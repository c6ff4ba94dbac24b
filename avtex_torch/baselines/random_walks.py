"""Random playback baselines (the port of avtex/baselines/random_walks.py),
numpy ``default_rng``, bit-exact with avtex for the same seed.

- ``random_sequential_walk``: a random start segment, then *sequential*
  playback wrapping at the end (the reference's "random baseline").
- ``random_segment_walk``: an independently random segment every step
  ("Random Clip").
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def random_sequential_walk(num_segments: int, window: int, stride: int,
                           max_length: int, seed: int = 0) -> np.ndarray:
    """Frame ids: random start, sequential segments, wrap at the end;
    whole blocks until ``max_length`` is reached (never truncated)."""
    rng = np.random.default_rng(seed)
    seg = int(rng.integers(num_segments))
    frame_ids = list(range(seg * stride, seg * stride + window))
    while len(frame_ids) < max_length:
        seg = (seg + 1) % num_segments
        start = seg * stride + (window - stride)
        frame_ids.extend(range(start, seg * stride + window))
    return np.asarray(frame_ids)


def random_segment_walk(num_segments: int, window: int, stride: int,
                        max_length: int, seed: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(frame ids, segment ids): a fresh uniform segment per step, the
    first emitting its whole window, later ones their last ``stride``;
    whole blocks until ``max_length`` is reached."""
    rng = np.random.default_rng(seed)
    frame_ids: list = []
    segs: list = []
    while len(frame_ids) < max_length:
        seg = int(rng.integers(num_segments))
        start = seg * stride + (window - stride if segs else 0)
        segs.append(seg)
        frame_ids.extend(range(start, seg * stride + window))
    return np.asarray(frame_ids), np.asarray(segs)
