"""Schödl anticipated-future-cost value iteration (D3), the port of
avtex/classic/future_cost.py.

``D3_old`` is frozen for a whole sweep, so a sweep is one masked row-min
and one broadcast add:

    mins[j]   = min_{k != j} D3_old[j, k]
    D3_new[i] = D3[i] + alpha * mins        for i in [1, N)   (row 0 untouched)

It stops when mean((new - old)^2) <= eps or after ``max_sweeps``: the same
rule, and so the same sweep count, as avtex's ``lax.while_loop``. Here the
loop runs on the host and reads ``delta`` after every sweep (one device
synchronisation per sweep).
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from .d1 import distance_to_transition_probs


def anticipated_future_cost(d2: torch.Tensor, p: float = 0.7,
                            alpha: float = 0.997, eps: float = 1e-2,
                            max_sweeps: int = 10_000,
                            return_sweeps: bool = False
                            ) -> Union[torch.Tensor,
                                       Tuple[torch.Tensor, int]]:
    """Converged D3 matrix (and the number of sweeps with
    ``return_sweeps``).

    Args:
      d2: [N, N] smoothed distance matrix.
      p: future-cost exponent (D3 = D2**p).
      alpha: discount on the anticipated future cost.
      eps: stop when mean((new - old)^2) <= eps.
      max_sweeps: hard bound on the sweeps.
    """
    d3_base = d2.to(torch.float32) ** p
    n = d3_base.shape[0]
    diag_inf = torch.zeros((n, n), dtype=torch.float32, device=d2.device)
    diag_inf.fill_diagonal_(float("inf"))
    eps = float(np.float32(eps))  # avtex compares in float32
    d3, delta, sweeps = d3_base, float("inf"), 0
    while delta > eps and sweeps < max_sweeps:
        mins = (d3 + diag_inf).amin(dim=1)
        d3_new = d3_base + alpha * mins[None, :]
        d3_new[0] = d3_base[0]  # the reference never updates row 0
        delta = float(((d3_new - d3) ** 2).mean())
        d3, sweeps = d3_new, sweeps + 1
    return (d3, sweeps) if return_sweeps else d3


def threshold_rows(p: torch.Tensor, threshold: float) -> torch.Tensor:
    """Zero out entries below ``rowmax - threshold*rowmax`` per row."""
    rowmax = p.amax(dim=1, keepdim=True)
    return torch.where(p < rowmax - threshold * rowmax,
                       torch.zeros((), dtype=p.dtype, device=p.device), p)


def compute_d3(d2: torch.Tensor, sigma_factor: float, p: float = 0.7,
               alpha: float = 0.997, eps: float = 1e-2,
               thresholding: float = 0.75
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """(D3, P3, P3_thresholded, sigma) — API parity with avtex's
    compute_d3."""
    d3 = anticipated_future_cost(d2, p=p, alpha=alpha, eps=eps)
    p3, sigma = distance_to_transition_probs(d3, sigma_factor)
    return d3, p3, threshold_rows(p3, thresholding), sigma
