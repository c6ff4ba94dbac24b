"""Temporal smoothing of the distance matrix (D2), the port of
avtex/classic/d2.py.

The reference convolves D1 with a diagonal kernel of binomial weights; the
valid-mode strided conv with a diagonal kernel is a sum of diagonally
shifted, strided slices:

    D2[i, j] = sum_k c_k * D1[i*s + k, j*s + k]

fs strided adds, O(fs) work per output.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .d1 import distance_to_transition_probs


def binomial_coeffs(filter_size: int) -> np.ndarray:
    """Binomial weights c_k = C(fs-1, k) / 2^(fs-1), float64, as
    ``(np.poly1d([.5, .5]) ** (fs-1)).coeffs``."""
    c = np.array([1.0])
    for _ in range(filter_size - 1):
        c = np.convolve(c, [0.5, 0.5])
    return c


def diagonal_filter_smooth(d1: torch.Tensor, filter_size: int = 16,
                           stride: int = 1) -> torch.Tensor:
    """Valid-mode strided conv of D1 with the diagonal binomial kernel."""
    n = d1.shape[0]
    out = (n - filter_size) // stride + 1
    span = (out - 1) * stride + 1
    acc = torch.zeros((out, out), dtype=torch.float32, device=d1.device)
    for k, c in enumerate(binomial_coeffs(filter_size)):
        block = d1[k:k + span:stride, k:k + span:stride]
        acc = acc + float(np.float32(c)) * block
    return acc


def compute_d2(d1: torch.Tensor, sigma_factor: float, filter_size: int = 16,
               stride: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(D2, P2, sigma) — API parity with avtex's compute_d2."""
    d2 = diagonal_filter_smooth(d1, filter_size, stride)
    p2, sigma = distance_to_transition_probs(d2, sigma_factor)
    return d2, p2, sigma
