"""Audio-to-video retrieval head, the "-daf Contrastive" driving-audio
features (the port of avtex/contrastive/audio_retrieval.py:29-80).

``VideoForAudio`` scores an audio example (VGGish features -> AudioMLP ->
128-d) against video segments (a clip encoder -> ``Linear`` -> 128-d) by
cosine over ``temp``; both sides are L2-normalised with ``+1e-12``.
Module names follow avtex's flax tree (``audio_encoder``, ``audio_mlp``,
``video_encoder``, ``video_head``), so ``avtex_torch.convert`` carries
avtex's parameters across. The default dtype is bf16, as in avtex,
whatever a ``Config`` says; ``encoder_kwargs`` reach the video encoder
(e.g. ``width``).

``embed_video_table`` embeds a source video's segments once;
``video_for_audio_logits`` gives the ``[steps, L]`` rows of a driving
clip against that ``[L, emb_dim]`` table.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from avtex_torch.data.preprocess import preprocess_clip
from avtex_torch.device import module_device
from avtex_torch.nn.encoders import build_encoder
from avtex_torch.nn.vggish import VGGish

from .model import AudioMLP


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


class VideoForAudio(nn.Module):
    """score(audio_example, video_windows) -> [B, N] cosine/temp logits."""

    def __init__(self, arch: str = "resnet18", emb_dim: int = 128,
                 temp: float = 0.1, dtype: torch.dtype = torch.bfloat16,
                 **encoder_kwargs: Any):
        super().__init__()
        self.arch, self.temp, self.dtype = arch, temp, dtype
        self.audio_encoder = VGGish(dtype=dtype)
        self.audio_mlp = AudioMLP(emb_dim, dtype=dtype)
        self.video_encoder, feat_dim, kind = build_encoder(
            arch, dtype=dtype, **encoder_kwargs)
        if kind != "clip":
            raise ValueError("VideoForAudio requires a clip encoder")
        self.video_head = nn.Linear(feat_dim, emb_dim).to(dtype)

    def embed_audio(self, audio_example: torch.Tensor) -> torch.Tensor:
        """[B, 100, 64] log-mel examples -> [B, emb_dim] unit rows, fp32."""
        return _unit(self.audio_mlp(self.audio_encoder(audio_example)))

    def embed_video(self, windows: torch.Tensor) -> torch.Tensor:
        """Preprocessed [B, T, H, W, 3] clips -> [B, emb_dim] unit rows,
        fp32."""
        v = self.video_encoder(windows).to(self.dtype)
        return _unit(self.video_head(v).float())

    def forward(self, audio_example: torch.Tensor,
                video_windows: torch.Tensor) -> torch.Tensor:
        """audio_example [B, 100, 64], video_windows [B, N, T, H, W, 3]
        (preprocessed) -> [B, N] fp32 logits."""
        a = self.embed_audio(audio_example)
        b, n = video_windows.shape[:2]
        v = self.embed_video(video_windows.reshape(
            (-1,) + video_windows.shape[2:])).reshape(b, n, -1)
        return torch.einsum("bd,bnd->bn", a, v) / self.temp


def embed_video_table(module: VideoForAudio, video_u8, window: int,
                      stride: int, num_segments: int, img_size: int,
                      batch_size: int) -> torch.Tensor:
    """[L, emb_dim] ``embed_video`` rows of the ``[T, H, W, 3]`` uint8
    video's L segments (segment i: frames ``[i*stride, i*stride +
    window)``), in batches of ``batch_size``, on the module's device (the
    video goes there once)."""
    dev = module_device(module)
    frames = torch.as_tensor(np.asarray(video_u8)).to(dev)
    offsets = torch.arange(window, device=dev)
    rows = []
    with torch.inference_mode():
        for b0 in range(0, num_segments, batch_size):
            starts = torch.arange(b0, min(b0 + batch_size, num_segments),
                                  device=dev) * stride
            x = preprocess_clip(frames[starts[:, None] + offsets[None, :]],
                                size=img_size)
            rows.append(module.embed_video(x))
    return torch.cat(rows)


def video_for_audio_logits(module: VideoForAudio, driving_examples,
                           video_tables: torch.Tensor,
                           temp: Optional[float] = None) -> torch.Tensor:
    """[steps, L] fp32 rows: the driving examples' audio embeddings
    against the ``[L, emb_dim]`` table of ``embed_video`` outputs, over
    ``temp`` (the module's by default). The examples go to the table's
    device."""
    x = torch.as_tensor(driving_examples).to(video_tables.device)
    with torch.inference_mode():
        a = module.embed_audio(x)
    t = module.temp if temp is None else temp
    return (a @ video_tables.T).float() / t
