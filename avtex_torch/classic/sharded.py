"""The classic chain sharded by row blocks over a mesh axis (the port of
avtex/classic/sharded.py).

``classic_transition_matrix`` holds the whole ``[N, N]`` chain on one
device. Here each rank of ``mesh[axis]`` computes only its block of
``mp = ceil(m / ndev)`` output rows (m = (N - fs) // s + 1, the last
block padded with clipped rows):

- D1: the block's rows of the distance matrix against all N frames, a
  Gram product in fp32 (TF32 off, accumulated over ``BK``-wide feature
  blocks as ``pairwise_l2_reference`` does), clamped, with exact zeros on
  the diagonal; no rank holds the ``[N, N]`` matrix. avtex computes this
  block with ``dot_general`` at HIGHEST precision, not with its Pallas
  kernel.
- D2: the diagonal binomial smoothing of the local block alone.
- D3: Jacobi value iteration whose only cross-rank traffic per sweep is
  an all-gather of the ``[mp]`` per-row mins and an all-reduce of the
  masked squared change. As in ``future_cost.py`` the loop runs on the
  host and reads delta after every sweep (mean over m*m, stop at
  ``delta <= eps`` or after ``MAX_SWEEPS``): the same sweep count.

The D3 blocks are then all-gathered and finished with the port's
``distance_to_transition_probs`` and ``threshold_rows`` on every rank.
The reference's quirks stay: row 0 never updated, the diagonal-zero D1,
the one-row shift of P.
"""

from __future__ import annotations

import contextlib
from typing import Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from avtex_torch.ops.pairwise import BK
from avtex_torch.parallel.mesh import axis_info, rank_device

from .d1 import distance_to_transition_probs
from .d2 import binomial_coeffs
from .future_cost import threshold_rows

MAX_SWEEPS = 10_000  # avtex's bound on the value iteration


@contextlib.contextmanager
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _gather_rows(x: torch.Tensor, n: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def classic_transition_matrix_sharded(
        feats, mesh: DeviceMesh, sigma_factor: float, *,
        filter_size: int = 16, stride: int = 1, normalize: bool = False,
        p: float = 0.7, alpha: float = 0.997, eps: float = 1e-2,
        thresholding: float = 0.75, axis: str = "data",
        return_sweeps: bool = False
        ) -> Union[torch.Tensor, Tuple[torch.Tensor, int]]:
    """P3_new from row-block-sharded D1/D2/D3 over ``mesh[axis]``, on every
    rank's device (and the D3 sweep count with ``return_sweeps``)."""
    ndev, sid, group = axis_info(mesh, axis)
    dev = rank_device(mesh)
    x = torch.as_tensor(feats).to(dev, torch.float32)
    x = x.reshape(x.shape[0], -1)
    if normalize:
        x = x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-12)
    n, f = x.shape
    fs, s = filter_size, stride
    m = (n - fs) // s + 1
    mp = -(-m // ndev)
    i0 = sid * mp

    # ---- D1: rows i0*s .. i0*s + (mp-1)*s + fs of the distances -------- #
    rows = (i0 * s + torch.arange((mp - 1) * s + fs, device=dev)
            ).clamp(0, n - 1)
    a = x[rows]
    gram = torch.zeros((len(rows), n), dtype=torch.float32, device=dev)
    with _no_tf32():
        for k in range(0, f, BK):
            gram.addmm_(a[:, k:k + BK], x[:, k:k + BK].t())
    sq_a, sq_b = (a * a).sum(dim=1), (x * x).sum(dim=1)
    d2sq = (sq_a[:, None] + sq_b[None, :] - 2.0 * gram).clamp_min(0.0)
    d2sq[rows[:, None] == torch.arange(n, device=dev)[None, :]] = 0.0
    b = d2sq.sqrt()
    del gram, d2sq

    # ---- D2: the diagonal binomial smoothing of the block -------------- #
    acc = torch.zeros((mp, m), dtype=torch.float32, device=dev)
    for k, c in enumerate(binomial_coeffs(fs)):
        acc = acc + float(np.float32(c)) * b[k:k + (mp - 1) * s + 1:s,
                                              k:k + (m - 1) * s + 1:s]

    # ---- D3: Jacobi sweeps, all-gathered mins, all-reduced delta ------- #
    base = acc ** p
    row_ids = i0 + torch.arange(mp, device=dev)
    real = (row_ids < m).to(torch.float32)[:, None]
    diag_inf = torch.where(
        row_ids[:, None] == torch.arange(m, device=dev)[None, :],
        float("inf"), 0.0)
    updated = (row_ids >= 1)[:, None]  # the reference never updates row 0
    eps = float(np.float32(eps))  # avtex compares in float32
    d3, delta, sweeps = base, float("inf"), 0
    while delta > eps and sweeps < MAX_SWEEPS:
        mins = _gather_rows((d3 + diag_inf).amin(dim=1), ndev, group)[:m]
        d3_new = torch.where(updated, base + alpha * mins[None, :], base)
        sq = (((d3_new - d3) * real) ** 2).sum()
        dist.all_reduce(sq, group=group)
        delta = float(sq / (m * m))
        d3, sweeps = d3_new, sweeps + 1

    d3 = _gather_rows(d3, ndev, group)[:m]
    p3, _ = distance_to_transition_probs(d3, sigma_factor)
    out = threshold_rows(p3, thresholding)
    return (out, sweeps) if return_sweeps else out
