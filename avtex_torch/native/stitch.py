"""ctypes bindings of the C++ frame stitcher (``framestitch.cc``; the
port of avtex/native/stitch.py). The numpy plain versions with the same
semantics are ``avtex_torch.synth.stitcher.stitch_frames`` and
``crossfade``; the outputs are byte-identical."""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import load


def stitch_frames(video: np.ndarray, frame_ids: np.ndarray,
                  frames_bar: bool = False,
                  total_input_frames: Optional[int] = None) -> np.ndarray:
    """Gather ``video[frame_ids]`` (+ optional red position bar in rows
    [H-25, H-10) with a 6-px marker at column ``id * W / total``). An id
    outside ``[0, T)`` raises ``IndexError``."""
    video = np.ascontiguousarray(video, dtype=np.uint8)
    frame_ids = np.ascontiguousarray(frame_ids, dtype=np.int64).reshape(-1)
    if video.ndim != 4 or video.shape[3] != 3:
        raise ValueError(f"need uint8 frames [T, H, W, 3], got {video.shape}")
    t, h, w, _ = video.shape
    total = total_input_frames if total_input_frames is not None else t
    out = np.empty((len(frame_ids), h, w, 3), dtype=np.uint8)
    rc = load().avtex_stitch_frames(
        video.ctypes.data, t, h, w, frame_ids.ctypes.data, len(frame_ids),
        out.ctypes.data, 1 if frames_bar else 0, total)
    if rc != 0:
        raise IndexError(f"a frame id is outside the {t}-frame video")
    return out


def crossfade(frame0: np.ndarray, frame1: np.ndarray, n_mid: int
              ) -> np.ndarray:
    """``n_mid`` linear blends between two uint8 frames, rounded half up
    (the stitcher's default ``interp_fn``)."""
    f0 = np.ascontiguousarray(frame0, dtype=np.uint8)
    f1 = np.ascontiguousarray(frame1, dtype=np.uint8)
    if f0.shape != f1.shape or f0.ndim != 3 or f0.shape[2] != 3:
        raise ValueError(f"need two uint8 frames [H, W, 3], got {f0.shape} "
                         f"and {f1.shape}")
    h, w, _ = f0.shape
    out = np.empty((n_mid, h, w, 3), dtype=np.uint8)
    load().avtex_crossfade(f0.ctypes.data, f1.ctypes.data, h, w, n_mid,
                           out.ctypes.data)
    return out
