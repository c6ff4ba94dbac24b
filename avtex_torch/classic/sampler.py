"""Random-walk texture sampling over a transition matrix (the port of
avtex/classic/sampler.py).

The reference walks the thresholded matrix one transition at a time with
``np.random.choice(P[this].nonzero())``, i.e. uniform over the surviving
columns, with three stitching modes: per-frame (-m 1), per-stride block
(-m 2) and per-filter-window block (-m 3).

- ``sample_texture_walk``: the walk on the matrix's device (avtex's
  ``_walk_scan``), uniform over the nonzero columns as the argmax of
  ``[num_steps, N]`` uniform noise on the row's mask; the noise comes from
  a ``torch.Generator`` or is given (``noise=``): given avtex's noise it
  picks avtex's indices.
- ``sample_texture_walk_host``: numpy, bit-exact with avtex's for the same
  ``np.random.Generator``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def sample_texture_walk(p: torch.Tensor, start: int, num_steps: int,
                        generator: Optional[torch.Generator] = None,
                        noise: Optional[torch.Tensor] = None,
                        advance: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Walk ``num_steps`` transitions from ``start`` on ``p``'s device.

    The carry is the row sampled from: ``advance=0`` samples the next step
    from the chosen index (modes 1/3), ``advance=k>0`` from min(chosen +
    k, N-1) (mode 2; the first row is offset the same way). A jump is a
    chosen index other than the sampled-from row + 1. ``noise``: optional
    ``[num_steps, N]`` uniform draws; without it they come from
    ``generator`` (on ``p``'s device). A step is three kernels (the row's
    mask, the masked noise, its argmax); the jumps are computed after the
    loop.

    Returns (indices [num_steps+1], jump_flags [num_steps]) on ``p``'s
    device.
    """
    n = p.shape[0]
    dev = p.device
    if noise is None:
        noise = torch.rand((num_steps, p.shape[1]), generator=generator,
                           device=dev)
    noise = noise.to(dev)
    # the row sampled from after choosing each index, and its mask
    rows = torch.arange(n, device=dev)
    if advance:
        rows = (rows + advance).clamp_max(n - 1)
    after = (p > 0.0).index_select(0, rows)
    cur = torch.tensor([int(start)], dtype=torch.int64, device=dev)
    idx = [cur]
    for noise_s in noise[:num_steps].unbind(0):  # [1]-shaped ids, no views
        cur = torch.where(after.index_select(0, cur), noise_s,
                          -1.0).argmax(dim=1)
        idx.append(cur)
    idx = torch.cat(idx)
    return idx, idx[1:] != rows.index_select(0, idx[:-1]) + 1


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
