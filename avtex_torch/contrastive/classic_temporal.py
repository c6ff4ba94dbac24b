"""ClassicTemporal head: embedding-space L2 distances to every target (the
port of avtex/contrastive/classic_temporal.py).

One shared ``SegmentEmbedder`` (module name ``embedder``) embeds the
query segment and each target segment; each target is scored by the
Euclidean distance of the unit embeddings, computed as
``sqrt(max(2 - 2 q.t, 0))``, and the query itself is appended as a last
target at distance 0 (the reference's ``cat(t_f, q_f)`` slot). Like
avtex, it is not on the synthesis path.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from .model import SegmentEmbedder, _check_model_type


def classic_temporal_distances(q: torch.Tensor, t: torch.Tensor
                               ) -> torch.Tensor:
    """[B, D] unit queries + [B, N, D] unit targets -> [B, N+1] fp32 L2
    distances, the last column the query against itself (0)."""
    sim = torch.einsum("bd,bnd->bn", q.float(), t.float())
    d = torch.sqrt(torch.clamp(2.0 - 2.0 * sim, min=0.0))
    return torch.cat([d, torch.zeros_like(d[:, :1])], dim=-1)


class ClassicTemporal(nn.Module):
    """Shared query/target embedder + distance scoring. For
    ``model_type=2`` the given ``audio_encoder`` is registered here (as
    flax adopts a module field: ``params/audio_encoder``) and shared with
    the embedder."""

    def __init__(self, arch: str = "resnet18", model_type: int = 1,
                 audio_encoder: Optional[nn.Module] = None,
                 dtype: torch.dtype = torch.bfloat16, norm: str = "group",
                 **encoder_kwargs: Any):
        super().__init__()
        _check_model_type(model_type)
        if audio_encoder is not None:
            self.audio_encoder = audio_encoder
        self.embedder = SegmentEmbedder(arch, model_type, dtype, norm,
                                        audio_encoder, **encoder_kwargs)

    def forward(self, q_frames, t_frames, q_audio=None, t_audio=None
                ) -> torch.Tensor:
        """q_frames [B, T, H, W, 3] and t_frames [B, N, T, H, W, 3] (or
        (slow, fast) tuples of such for SlowFast) -> [B, N+1] distances
        (column N the appended query, always 0)."""
        q = self.embedder(q_frames, q_audio)
        if isinstance(t_frames, tuple):
            b, n = t_frames[0].shape[:2]
            flat = tuple(p.reshape((-1,) + p.shape[2:]) for p in t_frames)
        else:
            b, n = t_frames.shape[:2]
            flat = t_frames.reshape((-1,) + t_frames.shape[2:])
        t_audio = (None if t_audio is None
                   else t_audio.reshape((-1,) + t_audio.shape[2:]))
        t = self.embedder(flat, t_audio).reshape(b, n, -1)
        return classic_temporal_distances(q, t)
