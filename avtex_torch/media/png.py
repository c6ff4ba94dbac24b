"""PNG encoding without OpenCV, byte-identical to ``cv2.imwrite``.

OpenCV writes an 8-bit RGB PNG through libpng with its speed settings:
every row Sub-filtered (None when the image is one pixel wide), zlib at
level 1 with the run-length strategy, a window no larger than the
filtered rows need (libpng shrinks it for small images) and IDAT chunks
of 8192 bytes. ``encode_png`` does the same with the standard library's
zlib, so ``write_frames_png`` gives avtex's files byte for byte on a host
without OpenCV (tests/test_torch_examples.py holds the two against each
other). Python's zlib has no 256-byte window, so an image of at most 256
bytes of filtered rows (a few pixels) gets the 512-byte one: other bytes,
the same pixels.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_IDAT_BYTES = 8192
_FILTER_NONE, _FILTER_SUB = 0, 1


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _window_bits(n: int) -> int:
    """The smallest zlib window that holds ``n`` bytes (9 to 15)."""
    bits = 9
    while bits < 15 and (1 << bits) < n:
        bits += 1
    return bits


def encode_png(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of uint8 ``[H, W, 3]``."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"need [H, W, 3] frames, got {rgb.shape}")
    rows = rgb.reshape(h, w * 3)
    kind = _FILTER_SUB if w > 1 else _FILTER_NONE
    if kind == _FILTER_SUB:  # each byte minus the one a pixel to its left
        rows = rows.copy()
        rows[:, 3:] -= rgb.reshape(h, w * 3)[:, :-3]
    raw = np.concatenate([np.full((h, 1), kind, np.uint8), rows], 1)
    raw = raw.tobytes()
    z = zlib.compressobj(1, zlib.DEFLATED, _window_bits(len(raw)), 8,
                         zlib.Z_RLE)
    data = z.compress(raw) + z.flush()
    out = [_SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2,
                                                   0, 0, 0))]
    out += [_chunk(b"IDAT", data[i:i + _IDAT_BYTES])
            for i in range(0, len(data), _IDAT_BYTES)]
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)
