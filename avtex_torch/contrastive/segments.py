"""Segment-index arithmetic (the port's copy of avtex/contrastive/segments.py).

A video of T frames is cut into overlapping windows of ``W`` frames at
stride ``S``; segment *i* covers frames ``[i*S, i*S + W)``. The number of
query segments is ``floor((T - W)/S) - 1`` at train time and
``floor((T - W)/S)`` at synthesis ("val") time.
"""

from __future__ import annotations

import numpy as np


def num_segments(num_frames: int, window: int, stride: int,
                 split: str = "train") -> int:
    """Number of query segments."""
    n = (num_frames - window) // stride
    return n - 1 if split == "train" else n


def require_segments(num_frames: int, window: int, stride: int,
                     split: str = "val", what: str = "this video") -> int:
    """num_segments, but raise an actionable error for too-short videos.

    Synthesis needs at least 2 segments (a query and a distinct
    successor), training at least 1 query.
    """
    L = num_segments(num_frames, window, stride, split)
    need = 1 if split == "train" else 2
    if L < need:
        need_frames = (window + (need + (split == "train")) * stride)
        raise ValueError(
            f"{what} is too short: {num_frames} frames gives {max(L, 0)} "
            f"{split} segment(s) at window={window}, stride={stride}; "
            f"need at least {need}. Provide >= ~{need_frames} frames, or "
            f"reduce -w/-stride (fps-derived: W=ceil(fps/2), "
            f"S=ceil(fps/5)), or lower -subr subsampling.")
    return L


def gather_windows(frames: np.ndarray, window: int, stride: int,
                   split: str = "val") -> np.ndarray:
    """All segment windows as a strided view: [L, W, ...frame dims...]."""
    L = num_segments(len(frames), window, stride, split)
    s0 = frames.strides[0]
    shape = (L, window) + frames.shape[1:]
    strides = (s0 * stride, s0) + frames.strides[1:]
    return np.lib.stride_tricks.as_strided(frames, shape=shape, strides=strides)
