"""2D ResNet image encoder (the port of avtex/nn/resnet2d.py).

- ``ResNet2D`` with ``BasicBlock2D``: ``[B, H, W, 3]`` images ->
  ``[B, feat_dim]`` float32 penultimate features (a 7x7 stride-2 stem of
  64 channels, a 3x3 stride-2 max pool with padding 1, stage strides 2
  from the second stage, the spatial mean); the classic baseline's
  ``-f ResNet`` features run ``resnet2d18``; ``resnet2d34`` is avtex's
  deeper constructor, in no registry, as in avtex.
- ``FrameMean2D``: a clip encoder from it, ``[B, T, H, W, 3]`` -> T folded
  into the batch -> the temporal mean of the per-frame features; the
  encoder registry's ``resnet18_2d`` / ``resnet34_2d``.

Inside, NCHW tensors in ``channels_last`` memory; module names follow the
flax tree (``Conv_k``, ``Affine_k`` / ``GroupNorm_k``, ``BasicBlock2D_i``,
``FrameMean2D``'s ``ResNet2D_0``), so ``avtex_torch.convert`` carries
avtex's parameters over. Neither has avtex's ``remat`` field.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .resnet3d import _Block, make_norm, norm_prefix


def _conv2d(cin: int, cout: int, k: int, stride: int = 1,
            groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, groups=groups,
                     bias=False)


class BasicBlock2D(_Block):
    """Two 3x3 convs (the first strided), a 1x1 projection when the shape
    changes."""

    expansion = 1

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 norm: str = "group"):
        super().__init__()
        self.n_main = 2
        self.need_proj = in_ch != features or stride != 1
        specs = [(in_ch, features, 3, stride, 1),
                 (features, features, 3, 1, 1)]
        if self.need_proj:
            specs.append((in_ch, features, 1, stride, 1))
        self._pairs(norm, specs, conv=_conv2d)


class ResNet2D(nn.Module):
    """Image encoder ``[B, H, W, 3]`` -> ``[B, feat_dim]`` float32. Conv
    weights and activations in ``dtype``; norm parameters float32."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2), width: int = 64,
                 dtype: torch.dtype = torch.bfloat16, norm: str = "group"):
        super().__init__()
        self.dtype, self.norm = dtype, norm
        self.Conv_0 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.add_module(f"{norm_prefix(norm)}_0", make_norm(norm, 64))
        in_ch, idx = 64, 0
        for i, n_blocks in enumerate(layers):
            feats = width * (2 ** i)
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                self.add_module(f"BasicBlock2D_{idx}",
                                BasicBlock2D(in_ch, feats, stride, norm))
                in_ch, idx = feats, idx + 1
        self.n_blocks = idx
        self.feat_dim = width * 8 * BasicBlock2D.expansion
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.data = m.weight.data.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = getattr(self, f"{norm_prefix(self.norm)}_0")(self.Conv_0(x))
        x = F.max_pool2d(torch.relu(x), 3, 2, 1)
        for i in range(self.n_blocks):
            x = getattr(self, f"BasicBlock2D_{i}")(x)
        # avtex averages in the compute dtype, then casts to float32
        return x.mean(dim=(2, 3)).float()


resnet2d18 = functools.partial(ResNet2D, layers=(2, 2, 2, 2))
resnet2d34 = functools.partial(ResNet2D, layers=(3, 4, 6, 3))


class FrameMean2D(nn.Module):
    """Clip encoder ``[B, T, H, W, 3]`` -> ``[B, 512]``: ``ResNet2D``
    features of every frame, averaged over T."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2),
                 dtype: torch.dtype = torch.bfloat16, norm: str = "group"):
        super().__init__()
        self.ResNet2D_0 = ResNet2D(layers, dtype=dtype, norm=norm)
        self.feat_dim = self.ResNet2D_0.feat_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t = x.shape[:2]
        feats = self.ResNet2D_0(x.reshape((-1,) + tuple(x.shape[2:])))
        return feats.reshape(b, t, -1).mean(dim=1)
