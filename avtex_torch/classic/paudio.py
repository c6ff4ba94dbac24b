"""P_audio: a driving-audio transition distribution for the classic
baseline (the port of avtex/classic/paudio.py).

The cosine of one driving-audio embedding against every source segment's
audio embedding, divided by the RAW sum + 1e-6: no shift, so entries may
be negative and need not sum to 1 when cosines are negative, as in the
reference. Nothing in avtex or the port calls it.
"""

from __future__ import annotations

import torch


def compute_paudio(driving_emb: torch.Tensor,
                   segment_embs: torch.Tensor) -> torch.Tensor:
    """[N] per-segment weights ``cos / (cos.sum() + 1e-6)``, in fp32 on
    ``segment_embs``' device.

    Args:
      driving_emb: [D] (or [1, D]) driving-audio feature vector.
      segment_embs: [N, D] (or [N, ...]) per-segment audio features.
    """
    s = torch.as_tensor(segment_embs).float()
    d = torch.as_tensor(driving_emb).float().to(s.device).reshape(-1)
    d = d / (torch.linalg.vector_norm(d) + 1e-12)
    s = s.reshape(s.shape[0], -1)
    s = s / (torch.linalg.vector_norm(s, dim=1, keepdim=True) + 1e-12)
    sims = s @ d
    return sims / (sims.sum() + 1e-6)
