"""Contrastive segment-successor model (the port of
avtex/contrastive/model.py:53-150).

- ``SegmentEmbedder``: window frames -> one L2-normalised embedding
  (``v / (||v|| + 1e-12)``).
- ``ContrastiveTextures``: a query and a target embedder with separate
  parameters; ``forward`` gives the training ``[B, 1+negs]`` logits,
  ``embed(tower=...)`` the rows of the synthesis tables.

Only ``model_type=1`` (video) is ported; the audio tower (VGGish) comes
with the ``-m 2`` slice.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from avtex_torch.nn.encoders import build_encoder


def _require_video_only(model_type: int) -> None:
    if model_type == 2:
        raise NotImplementedError(
            "model_type=2 (audio + video, VGGish) is not ported to "
            "avtex_torch yet: ROADMAP.md Queue 1 'Audio-conditioned "
            "synthesis, -m 2'")
    if model_type != 1:
        raise ValueError(f"unknown model_type {model_type}")


class SegmentEmbedder(nn.Module):
    """One segment's frames -> one normalised embedding."""

    def __init__(self, arch: str = "resnet18", model_type: int = 1,
                 dtype: torch.dtype = torch.bfloat16, norm: str = "group",
                 **encoder_kwargs: Any):
        super().__init__()
        _require_video_only(model_type)
        self.video_encoder, self.video_feat_dim, self.input_kind = (
            build_encoder(arch, dtype=dtype, norm=norm, **encoder_kwargs))

    def forward(self, frames) -> torch.Tensor:
        """frames: [B, T, H, W, 3], or a (slow, fast) tuple for SlowFast."""
        if self.input_kind == "slowfast":
            v = self.video_encoder(*frames)
        else:
            v = self.video_encoder(frames)
        return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)


class ContrastiveTextures(nn.Module):
    """Query + target embedders with separate parameters."""

    def __init__(self, arch: str = "resnet18", model_type: int = 1,
                 temp: float = 0.1, dtype: torch.dtype = torch.bfloat16,
                 norm: str = "group", **encoder_kwargs: Any):
        super().__init__()
        _require_video_only(model_type)
        self.arch, self.model_type, self.temp = arch, model_type, temp
        self.q_embedder = SegmentEmbedder(arch, model_type, dtype, norm,
                                          **encoder_kwargs)
        self.t_embedder = SegmentEmbedder(arch, model_type, dtype, norm,
                                          **encoder_kwargs)

    def forward(self, q_frames, t_frames) -> torch.Tensor:
        """Training forward: [B, 1+negs] logits, positive at column 0.

        ``t_frames`` is [B, N, ...] (or a tuple of such for SlowFast).
        """
        q = self.q_embedder(q_frames)
        if isinstance(t_frames, tuple):
            b, n = t_frames[0].shape[:2]
            flat = tuple(p.reshape((-1,) + p.shape[2:]) for p in t_frames)
        else:
            b, n = t_frames.shape[:2]
            flat = t_frames.reshape((-1,) + t_frames.shape[2:])
        t = self.t_embedder(flat).reshape(b, n, -1)
        return torch.einsum("bd,bnd->bn", q, t) / self.temp

    def embed(self, frames, *, tower: str = "target") -> torch.Tensor:
        """Embed a batch of segments with one tower (table precompute)."""
        if tower not in ("query", "target"):
            raise ValueError(f"tower must be 'query' or 'target', got {tower!r}")
        emb = self.t_embedder if tower == "target" else self.q_embedder
        return emb(frames)
