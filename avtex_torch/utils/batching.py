"""``batched_apply`` (the port of avtex/utils/batching.py:57-76)."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


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
