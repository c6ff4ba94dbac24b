"""SuperSloMo frame interpolation (the port of avtex/nn/slomo.py).

Two 6-level UNets with LeakyReLU(0.1): ``flow_comp`` (6 -> 4 channels,
the flows F01 and F10) and ``arb_time`` (20 -> 5 channels, flow residuals
and visibility), plus bilinear backwarping. NCHW tensors; convs in
``dtype`` (bf16 by default, as avtex), outputs of each UNet in float32.

Module names follow the flax tree (``flow_comp`` / ``arb_time``; in a
UNet ``Conv_0``, ``Conv_1``, ``_Down_0..4``, ``_Up_0..4``, ``Conv_2``; in
each level ``Conv_0``, ``Conv_1``), registered in call order, so the
port's convs in ``modules()`` order are the reference checkpoint's convs
in its registration order (``avtex_torch.checkpoints`` pairs them so).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

LEAK = 0.1
# Normalization the reference applies around SuperSloMo (interpolate.py).
SLOMO_MEAN = (0.429, 0.431, 0.397)


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=k // 2)


def _act(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAK)


class _Down(nn.Module):
    """2x2 average pool, then two convs."""

    def __init__(self, cin: int, features: int, kernel: int):
        super().__init__()
        self.Conv_0 = _conv(cin, features, kernel)
        self.Conv_1 = _conv(features, features, kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.avg_pool2d(x, 2)
        return _act(self.Conv_1(_act(self.Conv_0(x))))


class _Up(nn.Module):
    """Bilinear upsample to the skip's size, a conv, concat the skip, a
    conv."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.Conv_0 = _conv(cin, features, 3)
        self.Conv_1 = _conv(2 * features, features, 3)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        # jax.image.resize "bilinear" upscaling samples at half-pixel
        # centres: align_corners=False.
        x = F.interpolate(x, size=skip.shape[2:], mode="bilinear",
                          align_corners=False)
        x = _act(self.Conv_0(x))
        x = torch.cat([x, skip.to(x.dtype)], dim=1)
        return _act(self.Conv_1(x))


class UNet(nn.Module):
    """The SuperSloMo UNet (reference: models/slowmo.py:137-208)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.Conv_0 = _conv(in_channels, 32, 7)
        self.Conv_1 = _conv(32, 32, 7)
        downs = ((32, 64, 5), (64, 128, 3), (128, 256, 3), (256, 512, 3),
                 (512, 512, 3))
        for i, (cin, cout, k) in enumerate(downs):
            self.add_module(f"_Down_{i}", _Down(cin, cout, k))
        for i, (cin, cout) in enumerate(((512, 512), (512, 256), (256, 128),
                                         (128, 64), (64, 32))):
            self.add_module(f"_Up_{i}", _Up(cin, cout))
        self.Conv_2 = _conv(32, out_channels, 3)
        self.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _act(self.Conv_0(x.to(self.Conv_0.weight.dtype)))
        skips = [_act(self.Conv_1(x))]
        for i in range(5):
            skips.append(getattr(self, f"_Down_{i}")(skips[-1]))
        x = skips.pop()
        for i in range(5):
            x = getattr(self, f"_Up_{i}")(x, skips.pop())
        return _act(self.Conv_2(x)).float()


def backwarp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``img`` [B, C, H, W] at (x + u - 0.5,
    y + v - 0.5), ``flow`` [B, 2, H, W] = (u, v); taps outside the image
    read zero. This is the reference's ``grid_sample`` on
    ``2*((x + u)/W - 0.5)`` with ``align_corners=False`` (avtex/nn/
    slomo.py::backwarp derives it)."""
    _, _, h, w = img.shape
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=flow.dtype, device=flow.device),
        torch.arange(w, dtype=flow.dtype, device=flow.device),
        indexing="ij")
    x = 2 * ((gx + flow[:, 0]) / w - 0.5)
    y = 2 * ((gy + flow[:, 1]) / h - 0.5)
    return F.grid_sample(img, torch.stack([x, y], dim=-1), mode="bilinear",
                         padding_mode="zeros", align_corners=False)


class SuperSloMo(nn.Module):
    """flowComp + arbitrary-time interpolation.

    ``forward(i0, i1, ts)`` with normalised ``[B, 3, H, W]`` frames and a
    sequence of times in (0, 1) returns ``[len(ts), B, 3, H, W]`` float32.
    """

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.flow_comp = UNet(6, 4, dtype)
        self.arb_time = UNet(20, 5, dtype)

    def forward(self, i0: torch.Tensor, i1: torch.Tensor,
                ts: Sequence[float]) -> torch.Tensor:
        flows = self.flow_comp(torch.cat([i0, i1], dim=1))
        f01, f10 = flows[:, :2], flows[:, 2:]
        outs = []
        for t in ts:
            ft0 = -(1 - t) * t * f01 + t * t * f10
            ft1 = (1 - t) * (1 - t) * f01 - t * (1 - t) * f10
            g0, g1 = backwarp(i0, ft0), backwarp(i1, ft1)
            res = self.arb_time(torch.cat(
                [i0, i1, f01, f10, ft1, ft0, g1, g0], dim=1))
            ft0_r, ft1_r = res[:, :2] + ft0, res[:, 2:4] + ft1
            vt0 = torch.sigmoid(res[:, 4:5])
            vt1 = 1.0 - vt0
            g0r, g1r = backwarp(i0, ft0_r), backwarp(i1, ft1_r)
            # No epsilon: the reference divides bare (interpolate.py:135-
            # 136); (1-t)*sigmoid + t*(1-sigmoid) > 0 for t in (0, 1).
            wt0, wt1 = (1 - t) * vt0, t * vt1
            outs.append((wt0 * g0r + wt1 * g1r) / (wt0 + wt1))
        return torch.stack(outs)
