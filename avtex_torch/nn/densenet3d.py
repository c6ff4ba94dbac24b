"""3D DenseNet video encoders (the port of avtex/nn/densenet3d.py).

DenseNet-BC: growth rate 32, bottleneck 4x (a 1^3 conv to 128 channels,
then a 3^3 conv to 32 concatenated onto the input), compression 0.5 in the
transitions (norm, ReLU, 1^3 conv to half the channels, a 2^3 stride-2
average pool that floors odd sizes), a 7^3 stem at stride (1, 2, 2) and a
3^3 stride-2 max pool; ``feat_dim`` is the real final channel count
(1024 for 121, 1664 for 169, 1920 for 201, 2688 for 264).
``densenet3d121/169/201/264``; the encoder registry names 121 and 169
only, as avtex's does.

avtex convolves and pools here with flax's ``padding="SAME"``: the pad
is ``max((ceil(n/s) - 1) * s + k - n, 0)``, its smaller half low. At
stride 2 on an even size that is asymmetric (the stem on 224 pads H and W
by (2, 3), the max pool on 112 by (0, 1), with -inf), which torch's
symmetric ``padding=`` cannot express, so both get an explicit ``F.pad``
with flax's lows and highs. Module names follow the flax tree
(``Conv_k``, ``{Affine,GroupNorm}_k``, ``DenseLayer3D_i``, numbered
across blocks). There is no ``remat`` field, as in avtex.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .resnet3d import conv_in, make_norm, norm_prefix


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax's ``padding="SAME"`` (low, high) for one dimension."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, k: Sequence[int], s: Sequence[int],
             value: float = 0.0) -> torch.Tensor:
    """Pad the spatial dims of NC... ``x`` as flax's SAME padding does for
    a window ``k`` at strides ``s``."""
    pads = []
    for size, kk, ss in reversed(list(zip(x.shape[2:], k, s))):
        pads.extend(same_pads(size, kk, ss))
    return F.pad(x, pads, value=value)


class DenseLayer3D(nn.Module):
    """norm -> ReLU -> 1^3 conv (bn_size * growth) -> norm -> ReLU -> 3^3
    conv (growth), concatenated after the input's channels."""

    def __init__(self, in_ch: int, growth_rate: int, bn_size: int = 4,
                 norm: str = "group"):
        super().__init__()
        mid = bn_size * growth_rate
        self.prefix = norm_prefix(norm)
        self.add_module(f"{self.prefix}_0", make_norm(norm, in_ch))
        self.Conv_0 = nn.Conv3d(in_ch, mid, 1, bias=False)
        self.add_module(f"{self.prefix}_1", make_norm(norm, mid))
        # SAME at stride 1 for an odd window is symmetric
        self.Conv_1 = nn.Conv3d(mid, growth_rate, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(getattr(self, f"{self.prefix}_0")(x))
        y = torch.relu(getattr(self, f"{self.prefix}_1")(
            conv_in(self.Conv_0, y)))
        y = conv_in(self.Conv_1, y)
        return torch.cat([x, y.to(x.dtype)], dim=1)


class DenseNet3D(nn.Module):
    """Video encoder on ``[B, T, H, W, 3]`` clips; returns ``[B,
    feat_dim]`` float32. Conv weights and activations in ``dtype``; norm
    parameters float32."""

    def __init__(self, block_config: Sequence[int] = (6, 12, 24, 16),
                 growth_rate: int = 32, init_features: int = 64,
                 dtype: torch.dtype = torch.bfloat16, norm: str = "group"):
        super().__init__()
        self.dtype, self.prefix = dtype, norm_prefix(norm)
        self.Conv_0 = nn.Conv3d(3, init_features, 7, (1, 2, 2), bias=False)
        self.add_module(f"{self.prefix}_0", make_norm(norm, init_features))
        ch, n_layers = init_features, 0
        self.blocks = []  # (first layer, layers) per block
        for i, n in enumerate(block_config):
            for j in range(n):
                self.add_module(f"DenseLayer3D_{n_layers + j}",
                                DenseLayer3D(ch, growth_rate, norm=norm))
                ch += growth_rate
            self.blocks.append((n_layers, n))
            n_layers += n
            if i != len(block_config) - 1:
                self.add_module(f"{self.prefix}_{i + 1}", make_norm(norm, ch))
                self.add_module(f"Conv_{i + 1}",
                                nn.Conv3d(ch, ch // 2, 1, bias=False))
                ch //= 2
        self.add_module(f"{self.prefix}_{len(block_config)}",
                        make_norm(norm, ch))
        self.feat_dim = ch
        for m in self.modules():
            if isinstance(m, nn.Conv3d):
                m.weight.data = m.weight.data.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 4, 1, 2, 3).contiguous(
            memory_format=torch.channels_last_3d)
        x = self.Conv_0(pad_same(x, (7, 7, 7), (1, 2, 2)))
        x = torch.relu(getattr(self, f"{self.prefix}_0")(x))
        x = F.max_pool3d(pad_same(x, (3, 3, 3), (2, 2, 2), -math.inf), 3, 2)
        last = len(self.blocks) - 1
        for i, (first, n) in enumerate(self.blocks):
            for j in range(first, first + n):
                x = getattr(self, f"DenseLayer3D_{j}")(x)
            x = torch.relu(getattr(self, f"{self.prefix}_{i + 1}")(x))
            if i != last:
                # averaged in fp32 and rounded once, as CUDA's bf16 kernel
                # does (the CPU has no bf16 avg_pool3d)
                y = conv_in(getattr(self, f"Conv_{i + 1}"), x)
                x = F.avg_pool3d(y.float(), 2, 2).to(y.dtype)
        # avtex averages in the compute dtype, then casts to float32
        return x.mean(dim=(2, 3, 4)).float()


densenet3d121 = functools.partial(DenseNet3D, block_config=(6, 12, 24, 16))
densenet3d169 = functools.partial(DenseNet3D, block_config=(6, 12, 32, 32))
densenet3d201 = functools.partial(DenseNet3D, block_config=(6, 12, 48, 32))
densenet3d264 = functools.partial(DenseNet3D, block_config=(6, 12, 64, 48))
