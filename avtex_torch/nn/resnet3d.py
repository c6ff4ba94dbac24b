"""3D ResNet video encoders and the norm layers of every 3D encoder (the
port of avtex/nn/resnet3d.py).

- ``ResNet3D`` with ``BasicBlock3D`` / ``Bottleneck3D``: the reference's
  r3d family (conv1 7^3 with spatial stride (1,2,2), a 3^3 stride-2 max
  pool, stage strides 2 from the second stage, global average pool);
  ``resnet3d10/18/34/50``. The stem has 64 channels whatever ``width``
  is, as in avtex. ``forward`` takes avtex's ``[B, T, H, W, 3]`` clips;
  inside, NCDHW tensors in ``channels_last_3d`` memory. Module names
  follow the flax tree (``Conv_k``, ``Affine_k`` / ``GroupNorm_k``,
  ``BasicBlock3D_i`` / ``Bottleneck3D_i``), so ``avtex_torch.convert``
  carries avtex's parameters over. With ``remat`` (avtex's field, for
  training), each residual block runs under activation checkpointing
  (``run_block``): its backward recomputes the block's forward, so peak
  activation memory holds about one block. Each block is checkpointed
  whole, saving nothing inside it (avtex's default ``REMAT_POLICY =
  None``). The names do not change.
- ``Affine``: folded frozen-BatchNorm, ``x * scale + bias`` per channel in
  the activation dtype; parameters stay float32.
- ``GroupNorm``: flax's GroupNorm semantics — ``num_groups = min(32, ch)``,
  ``eps = 1e-6`` (torch defaults to 1e-5), statistics in float32, output in
  the activation dtype.

Both act on channel dim 1 (NCDHW, any memory format).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple, Type

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn


def run_block(block: nn.Module, x: torch.Tensor, remat: bool
              ) -> torch.Tensor:
    """``block(x)``, under activation checkpointing when ``remat`` and a
    backward can follow (grad enabled)."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(block, x,
                                                 use_reentrant=False)
    return block(x)


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


def _conv(cin: int, cout: int, k: int,
          stride: Tuple[int, int, int] = (1, 1, 1),
          groups: int = 1) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, k, stride, padding=k // 2, groups=groups,
                     bias=False)


class _Block(nn.Module):
    """Conv/norm pairs ``Conv_k`` + ``{Affine,GroupNorm}_k``, ReLU between
    them, a projection shortcut when the shape changes, ReLU after the
    residual add."""

    def _pairs(self, norm: str, specs) -> None:
        self.norm = norm
        for i, (cin, cout, k, stride, groups) in enumerate(specs):
            self.add_module(f"Conv_{i}", _conv(cin, cout, k, stride, groups))
            self.add_module(f"{norm_prefix(norm)}_{i}", make_norm(norm, cout))

    def _conv_norm(self, i: int, x: torch.Tensor) -> torch.Tensor:
        y = getattr(self, f"Conv_{i}")(x)
        return getattr(self, f"{norm_prefix(self.norm)}_{i}")(y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for i in range(self.n_main):
            y = self._conv_norm(i, y)
            if i < self.n_main - 1:
                y = torch.relu(y)
        r = self._conv_norm(self.n_main, x) if self.need_proj else x
        return torch.relu(y + r.to(y.dtype))


class BasicBlock3D(_Block):
    """Two 3^3 convs (the first strided)."""

    expansion = 1

    def __init__(self, in_ch: int, features: int,
                 stride: Tuple[int, int, int] = (1, 1, 1),
                 norm: str = "group", groups: int = 1):
        super().__init__()
        self.n_main = 2
        self.need_proj = in_ch != features or stride != (1, 1, 1)
        specs = [(in_ch, features, 3, stride, 1),
                 (features, features, 3, (1, 1, 1), 1)]
        if self.need_proj:
            specs.append((in_ch, features, 1, stride, 1))
        self._pairs(norm, specs)


class Bottleneck3D(_Block):
    """1^3 reduce, 3^3 (strided, ``groups``), 1^3 expand by 4."""

    expansion = 4

    def __init__(self, in_ch: int, features: int,
                 stride: Tuple[int, int, int] = (1, 1, 1),
                 norm: str = "group", groups: int = 1):
        super().__init__()
        out_ch = features * self.expansion
        self.n_main = 3
        self.need_proj = in_ch != out_ch or stride != (1, 1, 1)
        specs = [(in_ch, features, 1, (1, 1, 1), 1),
                 (features, features, 3, stride, groups),
                 (features, out_ch, 1, (1, 1, 1), 1)]
        if self.need_proj:
            specs.append((in_ch, out_ch, 1, stride, 1))
        self._pairs(norm, specs)


class ResNet3D(nn.Module):
    """Video encoder on ``[B, T, H, W, 3]`` clips; returns ``[B, feat_dim]``
    float32. Conv weights and activations in ``dtype``; norm parameters
    float32. ``remat`` checkpoints each residual block (training
    memory)."""

    def __init__(self, block: Type[_Block] = BasicBlock3D,
                 layers: Sequence[int] = (2, 2, 2, 2), groups: int = 1,
                 width: int = 64, dtype: torch.dtype = torch.bfloat16,
                 norm: str = "group", remat: bool = False):
        super().__init__()
        self.dtype, self.norm, self.remat = dtype, norm, remat
        self.Conv_0 = nn.Conv3d(3, 64, 7, (1, 2, 2), padding=3, bias=False)
        self.add_module(f"{norm_prefix(norm)}_0", make_norm(norm, 64))
        in_ch, idx = 64, 0
        for i, n_blocks in enumerate(layers):
            feats = width * (2 ** i)
            for j in range(n_blocks):
                stride = (2, 2, 2) if (i > 0 and j == 0) else (1, 1, 1)
                self.add_module(f"{block.__name__}_{idx}", block(
                    in_ch, feats, stride, norm, groups))
                in_ch = feats * block.expansion
                idx += 1
        self.n_blocks = idx
        self.block_name = block.__name__
        self.feat_dim = width * 8 * block.expansion
        for m in self.modules():
            if isinstance(m, nn.Conv3d):
                m.weight.data = m.weight.data.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 4, 1, 2, 3).contiguous(
            memory_format=torch.channels_last_3d)
        x = getattr(self, f"{norm_prefix(self.norm)}_0")(self.Conv_0(x))
        x = F.max_pool3d(torch.relu(x), 3, 2, 1)
        for i in range(self.n_blocks):
            x = run_block(getattr(self, f"{self.block_name}_{i}"), x,
                          self.remat)
        # avtex averages in the compute dtype, then casts to float32
        return x.mean(dim=(2, 3, 4)).float()


resnet3d10 = functools.partial(ResNet3D, block=BasicBlock3D,
                               layers=(1, 1, 1, 1))
resnet3d18 = functools.partial(ResNet3D, block=BasicBlock3D,
                               layers=(2, 2, 2, 2))
resnet3d34 = functools.partial(ResNet3D, block=BasicBlock3D,
                               layers=(3, 4, 6, 3))
resnet3d50 = functools.partial(ResNet3D, block=Bottleneck3D,
                               layers=(3, 4, 6, 3))
