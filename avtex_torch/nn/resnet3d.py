"""Norm layers of the 3D encoders (the port of avtex/nn/resnet3d.py:43-92).

- ``Affine``: folded frozen-BatchNorm, ``x * scale + bias`` per channel in
  the activation dtype; parameters stay float32.
- ``GroupNorm``: flax's GroupNorm semantics — ``num_groups = min(32, ch)``,
  ``eps = 1e-6`` (torch defaults to 1e-5), statistics in float32, output in
  the activation dtype.

Both act on channel dim 1 (NCDHW, any memory format).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _per_channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.to(x.dtype).view((1, -1) + (1,) * (x.ndim - 2))


class Affine(nn.Module):
    """Folded frozen-BatchNorm: y = x*scale + bias, per channel."""

    def __init__(self, ch: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * _per_channel(self.scale, x) + _per_channel(self.bias, x)


class GroupNorm(nn.GroupNorm):
    """flax-compatible GroupNorm (min(32, ch) groups, eps 1e-6, fp32 stats)."""

    def __init__(self, ch: int):
        super().__init__(min(32, ch), ch, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                         self.eps)
        return y.to(x.dtype)


def make_norm(kind: str, ch: int) -> nn.Module:
    """``"affine"`` or ``"group"`` norm for ``ch`` channels."""
    if kind == "affine":
        return Affine(ch)
    if kind == "group":
        return GroupNorm(ch)
    raise ValueError(f"unknown norm {kind!r}; have 'affine', 'group'")


def norm_prefix(kind: str) -> str:
    """Module-name prefix of a norm kind (matches the flax param tree)."""
    return "Affine" if kind == "affine" else "GroupNorm"
