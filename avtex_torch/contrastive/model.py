"""Contrastive segment-successor model (the port of
avtex/contrastive/model.py:53-150).

- ``SegmentEmbedder``: window frames (+ an audio example for
  ``model_type=2``) -> one L2-normalised embedding
  (``v / (||v|| + 1e-12)``). With audio, the raw flattened VGGish conv
  features are concatenated after the video features before the
  normalisation: the reference's forward applies no audio MLP.
- ``ContrastiveTextures``: a query and a target embedder with separate
  video encoders and, for ``model_type=2``, ONE VGGish shared by both
  towers, registered once as ``audio_encoder`` (avtex's tree has it at
  ``params/audio_encoder``) and handed to the embedders without
  registering it again, so its weights appear once in ``state_dict``.
  ``forward`` gives the training ``[B, 1+negs]`` logits,
  ``embed(tower=...)`` the rows of the synthesis tables.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from avtex_torch.nn.encoders import build_encoder
from avtex_torch.nn.vggish import VGGish


def _check_model_type(model_type: int) -> None:
    if model_type not in (1, 2):
        raise ValueError(f"unknown model_type {model_type}")


class SegmentEmbedder(nn.Module):
    """One segment (frames + optional audio) -> one normalised embedding.

    ``audio_encoder`` (required for ``model_type=2``) is held, not
    registered: the parent owns it."""

    def __init__(self, arch: str = "resnet18", model_type: int = 1,
                 dtype: torch.dtype = torch.bfloat16, norm: str = "group",
                 audio_encoder: Optional[nn.Module] = None,
                 **encoder_kwargs: Any):
        super().__init__()
        _check_model_type(model_type)
        if model_type == 2 and audio_encoder is None:
            raise ValueError("model_type=2 requires an audio_encoder")
        self.model_type = model_type
        self._shared = (audio_encoder,)
        self.video_encoder, self.video_feat_dim, self.input_kind = (
            build_encoder(arch, dtype=dtype, norm=norm, **encoder_kwargs))

    @property
    def audio_encoder(self) -> Optional[nn.Module]:
        return self._shared[0]

    def forward(self, frames, audio_example: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """frames: [B, T, H, W, 3], or a (slow, fast) tuple for SlowFast;
        audio_example: [B, 100, 64] log-mel examples for model_type=2."""
        if self.input_kind == "slowfast":
            v = self.video_encoder(*frames)
        else:
            v = self.video_encoder(frames)
        if self.model_type == 2:
            if audio_example is None:
                raise ValueError("model_type=2 requires audio examples")
            v = torch.cat([v, self.audio_encoder(audio_example)], dim=-1)
        return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)


class ContrastiveTextures(nn.Module):
    """Query + target embedders with separate video encoders and, for
    ``model_type=2``, one shared VGGish."""

    def __init__(self, arch: str = "resnet18", model_type: int = 1,
                 temp: float = 0.1, dtype: torch.dtype = torch.bfloat16,
                 norm: str = "group", **encoder_kwargs: Any):
        super().__init__()
        _check_model_type(model_type)
        self.arch, self.model_type, self.temp = arch, model_type, temp
        audio = None
        if model_type == 2:
            self.audio_encoder = audio = VGGish(dtype=dtype)
        self.q_embedder = SegmentEmbedder(arch, model_type, dtype, norm,
                                          audio, **encoder_kwargs)
        self.t_embedder = SegmentEmbedder(arch, model_type, dtype, norm,
                                          audio, **encoder_kwargs)

    def forward(self, q_frames, t_frames, q_audio=None, t_audio=None
                ) -> torch.Tensor:
        """Training forward: [B, 1+negs] logits, positive at column 0.

        ``t_frames`` is [B, N, ...] (or a tuple of such for SlowFast),
        ``t_audio`` [B, N, 100, 64] for model_type=2.
        """
        q = self.q_embedder(q_frames, q_audio)
        if isinstance(t_frames, tuple):
            b, n = t_frames[0].shape[:2]
            flat = tuple(p.reshape((-1,) + p.shape[2:]) for p in t_frames)
        else:
            b, n = t_frames.shape[:2]
            flat = t_frames.reshape((-1,) + t_frames.shape[2:])
        t_audio = (None if t_audio is None
                   else t_audio.reshape((-1,) + t_audio.shape[2:]))
        t = self.t_embedder(flat, t_audio).reshape(b, n, -1)
        return torch.einsum("bd,bnd->bn", q, t) / self.temp

    def embed(self, frames, audio: Optional[torch.Tensor] = None, *,
              tower: str = "target") -> torch.Tensor:
        """Embed a batch of segments with one tower (table precompute)."""
        if tower not in ("query", "target"):
            raise ValueError(f"tower must be 'query' or 'target', got {tower!r}")
        emb = self.t_embedder if tower == "target" else self.q_embedder
        return emb(frames, audio)
