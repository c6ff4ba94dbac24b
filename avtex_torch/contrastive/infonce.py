"""InfoNCE loss (the port of avtex/contrastive/infonce.py).

Cosine-similarity logits between one query embedding and (1 positive + n
negatives) target embeddings, divided by the temperature, then the
cross-entropy against the positive at column 0. The logits accumulate in
fp32 whatever the embeddings' dtype.
"""

from __future__ import annotations

import torch


def cosine_logits(q: torch.Tensor, t: torch.Tensor, temp: float
                  ) -> torch.Tensor:
    """``[B, D]`` queries, ``[B, N, D]`` targets (positive at index 0)
    -> ``[B, N]`` fp32 logits ``<q/|q|, t/|t|> / temp``."""
    qn = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
    tn = t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-12)
    return torch.einsum("bd,bnd->bn", qn.float(), tn.float()) / temp


def info_nce_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """Mean InfoNCE loss on ``[B, N]`` logits, positive at column 0."""
    return -torch.log_softmax(logits.float(), dim=-1)[:, 0].mean()


def info_nce_loss(q: torch.Tensor, t: torch.Tensor, temp: float
                  ) -> torch.Tensor:
    """Mean InfoNCE loss with the positive at column 0."""
    return info_nce_from_logits(cosine_logits(q, t, temp))
