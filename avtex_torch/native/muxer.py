"""ctypes binding of the C++ AVI muxer (``muxer.cc``; the port of
avtex/native/muxer.py). Its files are byte-identical to those of the
pure-Python writer, ``avtex_torch.media.avimux.write_avi_python``."""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional

import numpy as np

from . import load


def write_avi(path: str, jpegs: List[bytes], width: int, height: int,
              fps: float, pcm: Optional[np.ndarray], sample_rate: int) -> str:
    """Write the JPEG byte strings as an MJPEG AVI, interleaved with 16-bit
    PCM ``pcm`` ([n] or [n, channels]) when given; raises on failure."""
    lib = load()
    n = len(jpegs)
    buf_ptrs = (ctypes.c_char_p * n)(*jpegs)
    sizes = (ctypes.c_int32 * n)(*[len(j) for j in jpegs])
    if pcm is not None:
        pcm = np.ascontiguousarray(pcm, dtype=np.int16)
        if pcm.ndim == 1:
            pcm = pcm[:, None]
        pcm_ptr = pcm.ctypes.data
        n_samples, channels = pcm.shape
    else:
        pcm_ptr, n_samples, channels = None, 0, 0
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    rc = lib.avtex_write_avi(
        path.encode(), buf_ptrs, sizes, n, width, height, float(fps),
        pcm_ptr, n_samples, channels, int(sample_rate))
    if rc != 0:
        raise RuntimeError(f"avtex_write_avi failed with code {rc} for "
                           f"{path}")
    return path
