"""The subset of MessagePack that flax's checkpoints use, without the
``msgpack`` package (the port's hosts need not have it).

Types: nil, bool, ints of every width, float32 / float64, str, bin,
arrays, maps with str keys, and flax's extension types for arrays: code
1, an ndarray as an inner packed ``(shape, dtype name, C-order bytes)``;
code 3, a numpy scalar as an ndarray. Other codes (flax's 2, a Python
complex) are refused.
Integers are written in the smallest form that holds them, floats as
float64 and maps with their keys sorted, as flax's writer does (it maps
the tree through ``jax.tree_util``, which sorts keys, then calls
``msgpack.packb``). Flax writes arrays over 1 GiB as a
``__msgpack_chunked_array__`` map; both directions refuse those, and
``bfloat16`` arrays, with a ValueError.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED_KEY = "__msgpack_chunked_array__"
MAX_ARRAY_BYTES = 2 ** 30


# ----------------------------------------------------------------- write #

def _pack_uint(n: int, fmts) -> bytes:
    for code, fmt in fmts:
        if n < (1 << (8 * struct.calcsize(fmt))):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} too large for msgpack")


def _len_header(n: int, fix: int, fix_max: int, codes) -> bytes:
    if n <= fix_max:
        return bytes([fix | n])
    return _pack_uint(n, codes)


def _pack_int(n: int) -> bytes:
    if 0 <= n <= 0x7F or -32 <= n < 0:
        return struct.pack(">b" if n < 0 else ">B", n)
    if n >= 0:
        for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"),
                          (0xCF, ">Q")):
            if n < (1 << (8 * struct.calcsize(fmt))):
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"),
                          (0xD3, ">q")):
            if n >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} does not fit 64 bits")


def _pack_ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        head = bytes([fixed[len(data)]])
    else:
        head = _pack_uint(len(data), ((0xC7, ">B"), (0xC8, ">H"),
                                         (0xC9, ">I")))
    return head + struct.pack(">b", code) + data


def _array_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError(f"cannot write an array of dtype {arr.dtype}")
    if arr.nbytes > MAX_ARRAY_BYTES:
        raise ValueError(f"array of {arr.nbytes} bytes: flax writes arrays "
                         f"over 1 GiB in its chunked form, which this codec "
                         f"does not support")
    return packb([list(arr.shape), arr.dtype.name,
                  np.ascontiguousarray(arr).tobytes()])


def _pack(obj: Any, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(_len_header(len(b), 0xA0, 31, ((0xD9, ">B"), (0xDA, ">H"),
                                                   (0xDB, ">I"))) + b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        out.append(_pack_uint(len(b), ((0xC4, ">B"), (0xC5, ">H"),
                                          (0xC6, ">I"))) + b)
    elif isinstance(obj, (list, tuple)):
        out.append(_len_header(len(obj), 0x90, 15, ((0xDC, ">H"),
                                                     (0xDD, ">I"))))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_len_header(len(obj), 0x80, 15, ((0xDE, ">H"),
                                                     (0xDF, ">I"))))
        if not all(isinstance(k, str) for k in obj):
            raise TypeError(f"map keys must be str, got {list(obj)}")
        for k in sorted(obj):
            _pack(k, out)
            _pack(obj[k], out)
    elif isinstance(obj, np.ndarray):
        out.append(_pack_ext(EXT_NDARRAY, _array_payload(obj)))
    elif isinstance(obj, np.generic):
        out.append(_pack_ext(EXT_NPSCALAR, _array_payload(np.asarray(obj))))
    else:
        raise TypeError(f"cannot write {type(obj).__name__} to msgpack")


def packb(obj: Any) -> bytes:
    """``obj`` as MessagePack bytes."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


# ------------------------------------------------------------------ read #

class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"truncated msgpack data: need {n} bytes at "
                             f"offset {self.pos} of {len(self.buf)}")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN = {">B": (0xC4, 0xC7, 0xD9), ">H": (0xC5, 0xC8, 0xDA, 0xDC, 0xDE),
        ">I": (0xC6, 0xC9, 0xDB, 0xDD, 0xDF)}
_LEN_FMT = {code: fmt for fmt, codes in _LEN.items() for code in codes}


def _array_from(payload: memoryview) -> np.ndarray:
    shape, name, buf = unpackb(payload)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        raise ValueError("bfloat16 arrays are not supported by this reader")
    dtype = np.dtype(name)
    if len(buf) != int(np.prod(shape, dtype=np.int64)) * dtype.itemsize:
        raise ValueError(f"array payload of {len(buf)} bytes does not hold "
                         f"{shape} {name}")
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def _ext(code: int, data: memoryview) -> Any:
    if code == EXT_NDARRAY:
        return _array_from(data)
    if code == EXT_NPSCALAR:
        return _array_from(data)[()]
    raise ValueError(f"unknown msgpack ext code {code}")


def _read(r: _Reader) -> Any:
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_read(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return str(r.take(b & 0x1F), "utf-8")
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _FIXED:
        return r.unpack(_FIXED[b])
    if 0xD4 <= b <= 0xD8:
        code = r.unpack(">b")
        return _ext(code, r.take(1 << (b - 0xD4)))
    if b in _LEN_FMT:
        n = r.unpack(_LEN_FMT[b])
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(r.take(n))
        if b in (0xC7, 0xC8, 0xC9):
            code = r.unpack(">b")
            return _ext(code, r.take(n))
        if b in (0xD9, 0xDA, 0xDB):
            return str(r.take(n), "utf-8")
        if b in (0xDC, 0xDD):
            return [_read(r) for _ in range(n)]
        return _read_map(r, n)
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x} at offset "
                     f"{r.pos - 1}")


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r)
        out[k] = _read(r)
    if CHUNKED_KEY in out:
        raise ValueError("the checkpoint holds a chunked array (flax's form "
                         "for a leaf over 1 GiB), which this reader does "
                         "not support")
    return out


def unpackb(data) -> Any:
    """One MessagePack object from ``data``; trailing bytes are an error.
    Arrays are read-only views of ``data``."""
    r = _Reader(data)
    obj = _read(r)
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} trailing bytes after the "
                         f"msgpack object")
    return obj

