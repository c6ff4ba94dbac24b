"""The whole classic chain as one call (the port of avtex/classic/fused.py).

D1 -> D2 -> D3 -> P3 -> threshold on the device with no host fetch of a
matrix in between; only the value iteration's scalar ``delta`` is read
after each sweep. The same functions as the staged
compute_d1 -> compute_d2 -> compute_d3 chain, so the result is identical.
"""

from __future__ import annotations

import torch

from avtex_torch.ops import pairwise_l2

from .d1 import distance_to_transition_probs
from .d2 import diagonal_filter_smooth
from .future_cost import anticipated_future_cost, threshold_rows


def classic_transition_matrix(feats: torch.Tensor, sigma_factor: float, *,
                              filter_size: int = 16, stride: int = 1,
                              normalize: bool = False, p: float = 0.7,
                              alpha: float = 0.997, eps: float = 1e-2,
                              thresholding: float = 0.75) -> torch.Tensor:
    """P3_new (the thresholded transition matrix) from features [N, ...]."""
    d1 = pairwise_l2(feats.reshape(feats.shape[0], -1), normalize=normalize)
    d2 = diagonal_filter_smooth(d1, filter_size, stride)
    d3 = anticipated_future_cost(d2, p=p, alpha=alpha, eps=eps)
    p3, _ = distance_to_transition_probs(d3, sigma_factor)
    return threshold_rows(p3, thresholding)
