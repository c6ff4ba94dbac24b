"""Self-contained AVI (RIFF) muxer: MJPEG video + PCM audio, interleaved.

The port's copy of avtex/media/avimux.py's pure-Python writer. Frames are
JPEG-encoded with OpenCV (imported at use) and interleaved with 16-bit PCM
chunks into one AVI with an idx1 index.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional

import numpy as np

from .video import _cv2

AVIF_HASINDEX = 0x00000010
AVIIF_KEYFRAME = 0x00000010


def _encode_jpegs(frames: np.ndarray, quality: int = 95) -> List[bytes]:
    cv2 = _cv2()
    out = []
    for f in np.asarray(frames):
        ok, buf = cv2.imencode(
            ".jpg", np.ascontiguousarray(f[:, :, ::-1]),
            [int(cv2.IMWRITE_JPEG_QUALITY), quality])
        if not ok:
            raise RuntimeError("JPEG encode failed")
        out.append(buf.tobytes())
    return out


def _pcm16(audio: np.ndarray) -> np.ndarray:
    audio = np.asarray(audio)
    if audio.dtype == np.int16:
        return audio
    return (np.clip(audio.astype(np.float32), -1.0, 1.0)
            * (2 ** 15 - 1)).astype(np.int16)


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) % 2 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(fourcc: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", fourcc + payload)


def write_avi(path: str, frames: np.ndarray, fps: float,
              audio: Optional[np.ndarray] = None,
              sample_rate: int = 22050, quality: int = 95) -> str:
    """Mux uint8 RGB frames (+ optional PCM audio) into one AVI file."""
    frames = np.asarray(frames)
    n, h, w = frames.shape[:3]
    jpegs = _encode_jpegs(frames, quality)
    max_jpeg = max(len(j) for j in jpegs)

    pcm = None
    channels = 1
    samples_per_frame = 0
    if audio is not None:
        pcm = _pcm16(audio)
        if pcm.ndim == 1:
            pcm = pcm[:, None]
        channels = pcm.shape[1]
        samples_per_frame = int(round(sample_rate / fps))

    # --- headers ---------------------------------------------------------- #
    usec_per_frame = int(round(1e6 / fps))
    n_streams = 2 if pcm is not None else 1
    avih = _chunk(b"avih", struct.pack(
        "<14I", usec_per_frame, 0, 0, AVIF_HASINDEX, n, 0, n_streams,
        max_jpeg, w, h, 0, 0, 0, 0))

    scale, rate = 1000, int(round(fps * 1000))
    strh_v = _chunk(b"strh", b"vids" + b"MJPG" + struct.pack(
        "<IHHIIIIIIiI4h", 0, 0, 0, 0, scale, rate, 0, n, max_jpeg, -1, 0,
        0, 0, w, h))
    strf_v = _chunk(b"strf", struct.pack(
        "<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0))
    strls = _list(b"strl", strh_v + strf_v)
    if pcm is not None:
        block_align = 2 * channels
        strh_a = _chunk(b"strh", b"auds" + b"\x00" * 4 + struct.pack(
            "<IHHIIIIIIiI4h", 0, 0, 0, 0, 1, sample_rate, 0, len(pcm),
            samples_per_frame * block_align, -1, block_align, 0, 0, 0, 0))
        strf_a = _chunk(b"strf", struct.pack(
            "<HHIIHHH", 1, channels, sample_rate, sample_rate * block_align,
            block_align, 16, 0))
        strls += _list(b"strl", strh_a + strf_a)
    hdrl = _list(b"hdrl", avih + strls)

    # --- movi: one audio chunk per video frame ---------------------------- #
    movi_payload = bytearray()
    index = bytearray()

    def emit(fourcc: bytes, payload: bytes):
        offset = 4 + len(movi_payload)  # relative to the 'movi' fourcc
        movi_payload.extend(_chunk(fourcc, payload))
        index.extend(fourcc + struct.pack(
            "<III", AVIIF_KEYFRAME, offset, len(payload)))

    audio_pos = 0
    for i, jpeg in enumerate(jpegs):
        emit(b"00dc", jpeg)
        if pcm is not None:
            end = len(pcm) if i == n - 1 else min(
                len(pcm), (i + 1) * samples_per_frame)
            if end > audio_pos:
                emit(b"01wb", pcm[audio_pos:end].tobytes())
                audio_pos = end

    riff = _chunk(b"RIFF", b"AVI " + hdrl + _list(b"movi", bytes(movi_payload))
                  + _chunk(b"idx1", bytes(index)))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(riff)
    return path
