"""All-pairs frame distance (D1) and its transition probabilities (the
port of avtex/classic/d1.py).

Semantics kept from avtex:
- RGB mode uses *unnormalized* flattened frames; feature modes
  L2-normalize each row first;
- sigma = sigma_factor * sum(D) / count_nonzero(D);
- P = exp(-D / sigma), rows shifted up by one with the last row
  duplicated (P[i][j] ~ sim(i + 1, j)), then row-normalized.

D itself is ``avtex_torch.ops.pairwise_l2``: the hand-written kernel for a
CUDA tensor, the plain Gram form for a CPU one. avtex chose between its
Pallas kernel and XLA by ``N * F > 32M`` on a TPU; the port has one path
per device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from avtex_torch.ops import pairwise_l2


def distance_to_transition_probs(d: torch.Tensor, sigma_factor: float
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P, sigma): exp(-D/sigma) with the reference's shift + row-normalize.
    sigma is a 0-d tensor on D's device (no host fetch)."""
    nz = (d != 0.0).sum().to(torch.float32)
    sigma = sigma_factor * d.sum() / nz.clamp_min(1.0)
    p = torch.exp(-d / sigma)
    p = torch.cat([p[1:], p[-1:]], dim=0)  # P[i] <- P[i + 1]
    p = p / p.sum(dim=1, keepdim=True)
    return p, sigma


def compute_d1(feats: torch.Tensor, sigma_factor: float,
               normalize: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(D1, P1, sigma) — API parity with avtex's compute_d1."""
    d1 = pairwise_l2(feats.reshape(feats.shape[0], -1), normalize=normalize)
    p1, sigma = distance_to_transition_probs(d1, sigma_factor)
    return d1, p1, sigma
