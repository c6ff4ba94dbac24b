"""The port's host runtime in C++ (the port of avtex/native/), bound with
ctypes.

``framestitch.cc`` (the frame gather with the position bar, and the
crossfade) and ``muxer.cc`` (the MJPEG + PCM AVI writer) are the port's
own copies, with avtex's C ABI. They are built with ``g++`` at first use
into ``avtex_torch/_build/`` (``avtex_torch.ops._build.build_native``),
never at import. A missing compiler or a failed build raises: no caller
falls back to the numpy plain versions on its own.
"""

from __future__ import annotations

import ctypes

from avtex_torch.ops import _build

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
# name -> (restype, argtypes) of the library's C ABI
SIGNATURES = {
    "avtex_stitch_frames": (ctypes.c_int, [_P, _I64, _I64, _I64, _P, _I64,
                                           _P, _I32, _I64]),
    "avtex_crossfade": (ctypes.c_int, [_P, _P, _I64, _I64, _I32, _P]),
    "avtex_write_avi": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(_I32), _I32, _I32, _I32, ctypes.c_double, _P, _I64,
        _I32, _I32]),
}


def load() -> ctypes.CDLL:
    """The built library with its functions' argument and result types
    declared (built on first use; raises if it cannot be)."""
    lib = _build.load_native()
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib
