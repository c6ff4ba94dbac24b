"""Chunking helpers (the port of avtex/utils/batching.py).

``batched_apply`` runs a function over host arrays in fixed batches. The
numpy helpers keep the reference's batching API for users porting its
workflows: pad-split ``[1, N, ...]`` into fixed batches
(``split_into_batches``) and back (``combine_batches``), and cut a flat
frame array into chunks that each yield ``max_segments`` windows
(``split_into_overlapping_segments``; consecutive chunks start
``S * (max_segments - 1)`` apart, so they share a window, as in the
reference).
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch


def split_into_batches(x: np.ndarray, max_segments: int
                       ) -> Tuple[np.ndarray, int]:
    """[1, N, ...] -> ([ceil(N/m), m, ...] zero-padded, N)."""
    if x.shape[0] != 1:
        raise ValueError(f"need a leading axis of 1, got {x.shape}")
    n = x.shape[1]
    num_batches = math.ceil(n / max_segments)
    out = np.zeros((num_batches, max_segments) + x.shape[2:], dtype=x.dtype)
    for idx in range(num_batches):
        start = idx * max_segments
        end = min(start + max_segments, n)
        out[idx, : end - start] = x[0, start:end]
    return out, n


def split_into_overlapping_segments(x: np.ndarray, max_segments: int,
                                    window: int, stride: int
                                    ) -> Tuple[np.ndarray, int]:
    """[N, ...] frames -> ([B, m*S + W, ...] overlapping chunks, N)."""
    n = x.shape[0]
    total_segments = math.ceil((n - window) / stride)
    chunk = max_segments * stride + window
    batches = math.ceil(total_segments / max_segments)
    out = np.zeros((batches, chunk) + x.shape[1:], dtype=x.dtype)
    for idx in range(batches):
        start = idx * stride * (max_segments - 1)
        end = min(start + chunk, n)
        out[idx, : end - start] = x[start:end]
    return out, n


def batched_apply(fn: Callable[..., torch.Tensor], *arrays: np.ndarray,
                  batch_size: int) -> torch.Tensor:
    """Run ``fn`` over the leading axis of host arrays in fixed batches.

    As avtex does, the tail batch is padded by repeating its last row (so
    every call sees one shape) and the padding is trimmed from the result.
    All arrays share the leading dim; returns the concatenated output
    (on ``fn``'s device).
    """
    n = len(arrays[0])
    out = []
    for b0 in range(0, n, batch_size):
        chunks = [np.asarray(a[b0:b0 + batch_size]) for a in arrays]
        pad = batch_size - len(chunks[0])
        if pad:
            chunks = [np.concatenate([c, np.repeat(c[-1:], pad, 0)])
                      for c in chunks]
        res = fn(*[torch.from_numpy(np.ascontiguousarray(c))
                   for c in chunks])
        out.append(res[:batch_size - pad] if pad else res)
    return torch.cat(out, dim=0)


def combine_batches(x: np.ndarray, num_valid: int) -> np.ndarray:
    """[G, N/G, ...] -> [1, num_valid, ...] (inverse of
    ``split_into_batches``)."""
    g, per = x.shape[:2]
    if num_valid > g * per:
        raise ValueError(f"{num_valid} rows asked of {g * per}")
    return x.reshape((1, g * per) + x.shape[2:])[:, :num_valid]
