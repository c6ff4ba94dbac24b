"""Random-walk texture sampling over a transition matrix (the port of the
host walk of avtex/classic/sampler.py).

The reference walks the thresholded matrix one transition at a time with
``np.random.choice(P[this].nonzero())``, i.e. uniform over the surviving
columns, with three stitching modes: per-frame (-m 1), per-stride block
(-m 2) and per-filter-window block (-m 3).

``sample_texture_walk_host`` is bit-exact with avtex's for the same
``np.random.Generator``. avtex's device walk (a ``lax.scan`` keyed by
``jax.random``) is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def sample_texture_walk_host(p: np.ndarray, start: int, num_steps: int,
                             rng: np.random.Generator, advance: int = 0
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Walk ``num_steps`` transitions from ``start``, uniform over the
    nonzero columns of the current row.

    ``advance=0``: the next row is the chosen index (modes 1/3).
    ``advance=k>0``: the next row is min(chosen + k, N-1), the reference's
    mode-2 stride advance. A jump is a chosen index other than the
    sampled-from row + 1.

    Returns (indices [num_steps+1], jump_flags [num_steps]).
    """
    n = len(p)
    cur = min(start + advance, n - 1) if advance else start
    idx = [start]
    jumps = []
    for _ in range(num_steps):
        choices = np.flatnonzero(p[cur])
        nxt = int(rng.choice(choices))
        jumps.append(nxt != cur + 1)
        idx.append(nxt)
        cur = min(nxt + advance, n - 1) if advance else nxt
    return np.asarray(idx), np.asarray(jumps)


def expand_walk_to_frames(indices: np.ndarray, mode: int, stride: int,
                          filter_size: int, num_frames: int) -> np.ndarray:
    """Expand walk indices into output frame ids per stitching mode.

    mode 1: each index is one frame.
    mode 2: each index starts a block of ``stride`` frames; pass
            ``num_frames`` = the TRANSITION-MATRIX size (the reference
            clips blocks to P.shape[0], not the raw frame count).
    mode 3: each index is a segment row of the strided matrix; emits the
            last ``stride`` frames of its ``filter_size`` window.
    """
    if mode == 1:
        return np.asarray(indices)
    out = []
    if mode == 2:
        out.extend(range(indices[0], min(indices[0] + stride, num_frames)))
        for nxt in indices[1:]:
            out.extend(range(nxt, min(nxt + stride, num_frames)))
    else:
        out.extend(range(indices[0], indices[0] + filter_size))
        for nxt in indices[1:]:
            lo = nxt * stride + (filter_size - stride)
            hi = nxt * stride + filter_size
            out.extend(range(lo, min(hi, num_frames)))
    return np.asarray(out)
