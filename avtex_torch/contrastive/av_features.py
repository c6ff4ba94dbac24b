"""Joint audio-visual feature network, SoundNet-style fusion (the port of
avtex/contrastive/av_features.py).

A 1-D conv tower over raw waveforms and a 3-D conv tower over clips,
fused by tiling the audio embedding over the video feature map and
concatenating, then a 1x1x1 conv, a global mean and a ``Linear`` to a
unit-norm joint embedding. The reference exports it without using it on
its main path; avtex keeps it for completeness, and so does the port.

flax's ``SAME`` padding is asymmetric at stride 2 (``pad_lo = total //
2``), and its ``SAME`` max pool pads with -inf: both are written out with
``F.pad`` (``avtex_torch.nn.densenet3d.pad_same``). Module names follow
avtex's tree (``VideoTower3D_0``, ``AudioTower1D_0``, ``Conv_k``,
``Dense_0``) for ``avtex_torch.convert``; weights and activations in
``dtype``, the embeddings returned in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from avtex_torch.nn.densenet3d import pad_same

AUDIO_LAYERS = ((16, 64, 2), (32, 32, 2), (64, 16, 2), (128, 8, 2),
                (256, 4, 2))   # (features, kernel, stride)
VIDEO_FEATURES = (32, 64, 128, 256)


class AudioTower1D(nn.Module):
    """Strided 1-D convs over a raw waveform [B, T] -> [B, 256] fp32."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        cin = 1
        for i, (feats, k, s) in enumerate(AUDIO_LAYERS):
            self.add_module(f"Conv_{i}", nn.Conv1d(cin, feats, k, s))
            cin = feats
        self.to(dtype)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = wav[:, None].to(self.dtype)                  # [B, 1, T]
        for i, (_, k, s) in enumerate(AUDIO_LAYERS):
            x = torch.relu(getattr(self, f"Conv_{i}")(pad_same(x, [k], [s])))
            # SAME pooling keeps at least one step for short waveforms
            x = F.max_pool1d(pad_same(x, [4], [4], float("-inf")), 4, 4)
        return x.mean(dim=-1).float()


class VideoTower3D(nn.Module):
    """3-D convs, spatial stride 2, over a clip [B, T, H, W, 3] ->
    [B, 256, t, h, w] (NCDHW)."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        cin = 3
        for i, feats in enumerate(VIDEO_FEATURES):
            self.add_module(f"Conv_{i}", nn.Conv3d(cin, feats, 3, (1, 2, 2)))
            cin = feats
        self.to(dtype)

    def forward(self, clip: torch.Tensor) -> torch.Tensor:
        x = clip.to(self.dtype).permute(0, 4, 1, 2, 3)
        for i in range(len(VIDEO_FEATURES)):
            x = pad_same(x, (3, 3, 3), (1, 2, 2))
            x = torch.relu(getattr(self, f"Conv_{i}")(x))
        return x


class AudioVisualFeatures(nn.Module):
    """Tile-and-concat fusion: (clip [B, T, H, W, 3], wav [B, T_a]) ->
    [B, emb_dim] unit rows, fp32."""

    def __init__(self, emb_dim: int = 128,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.VideoTower3D_0 = VideoTower3D(dtype)
        self.AudioTower1D_0 = AudioTower1D(dtype)
        self.Conv_0 = nn.Conv3d(512, 256, 1).to(dtype)
        self.Dense_0 = nn.Linear(256, emb_dim).to(dtype)

    def forward(self, clip: torch.Tensor, wav: torch.Tensor) -> torch.Tensor:
        v = self.VideoTower3D_0(clip)                    # [B, 256, t, h, w]
        a = self.AudioTower1D_0(wav).to(v.dtype)         # [B, 256]
        a_t = a[:, :, None, None, None].expand(-1, -1, *v.shape[2:])
        x = torch.relu(self.Conv_0(torch.cat([v, a_t], dim=1)))
        x = self.Dense_0(x.mean(dim=(2, 3, 4))).float()
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
