"""Segment-index arithmetic (the port's copy of avtex/contrastive/segments.py).

A video of T frames is cut into overlapping windows of ``W`` frames at
stride ``S``; segment *i* covers frames ``[i*S, i*S + W)``. The number of
query segments is ``floor((T - W)/S) - 1`` at train time and
``floor((T - W)/S)`` at synthesis ("val") time. At train time the
positive of query *i* is *i + 1*, and hard negatives (offsets
{-4..-1, +2..+5}) overwrite the head of a random negative draw.
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


def segment_start_frames(num_frames: int, window: int, stride: int,
                         split: str = "val") -> np.ndarray:
    """Start frame of every segment: ``i*S`` for i in [0, L)."""
    L = num_segments(num_frames, window, stride, split)
    return np.arange(L) * stride


def segment_frame_ids(seg_id: int, window: int, stride: int) -> np.ndarray:
    """Frame ids covered by one segment: ``[i*S, i*S + W)``."""
    return np.arange(seg_id * stride, seg_id * stride + window)


def hard_negative_ids(idx: int, max_id: int) -> np.ndarray:
    """Hard-negative segment ids near the query: offsets
    {-4,-3,-2,-1,+2,+3,+4,+5}, clipped to [0, max_id] (inclusive, so the
    positive of the last query is reachable)."""
    cand = np.array([idx - 4, idx - 3, idx - 2, idx - 1,
                     idx + 2, idx + 3, idx + 4, idx + 5])
    cand = cand[cand >= 0]
    return cand[cand <= max_id]


def sample_negatives(idx: int, n_total: int, n_negs: int,
                     rng: np.random.Generator) -> np.ndarray:
    """Negative segment ids for query ``idx`` at train time.

    Candidates are all ids in [0, n_total] except {idx, idx+1}; ``n_negs``
    are drawn without replacement and the head of the draw is overwritten
    with the hard negatives, truncated to ``n_negs`` when fewer than 8.
    """
    ids = np.arange(n_total + 1)
    mask = np.ones(n_total + 1, dtype=bool)
    mask[[idx, idx + 1]] = False
    negs = rng.choice(ids[mask], n_negs, replace=False)
    hard = hard_negative_ids(idx, n_total)[:n_negs]
    negs[: len(hard)] = hard
    return negs


def target_ordering(q_id: int, L: int) -> np.ndarray:
    """Candidate ordering at synthesis time: ``[pos]`` then every other
    segment ascending, without ``q_id``; pos = min(q_id+1, L-1)."""
    pos_id = min(q_id + 1, L - 1)
    mask = np.ones(L, dtype=bool)
    mask[[q_id, pos_id]] = False
    return np.concatenate(([pos_id], np.arange(L)[mask]))


def gather_windows(frames: np.ndarray, window: int, stride: int,
                   split: str = "val") -> np.ndarray:
    """All segment windows as a strided view: [L, W, ...frame dims...]."""
    L = num_segments(len(frames), window, stride, split)
    s0 = frames.strides[0]
    shape = (L, window) + frames.shape[1:]
    strides = (s0 * stride, s0) + frames.strides[1:]
    return np.lib.stride_tricks.as_strided(frames, shape=shape, strides=strides)
