"""Parameter holders named as the program names its modules."""

from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from .common import conv3d, norm, norm_names


class ConvW(nn.Module):
    """A convolution's weight ``[cout, cin, kt, kh, kw]`` with its stride
    and padding; ``forward(x, precision)``."""

    def __init__(self, cin, cout, kernel, stride=(1, 1, 1), padding=None):
        super().__init__()
        kernel = tuple(kernel)
        self.stride = tuple(stride)
        self.padding = (tuple(k // 2 for k in kernel) if padding is None
                        else tuple(padding))
        self.weight = nn.Parameter(torch.empty((cout, cin) + kernel))

    def forward(self, x, precision):
        return conv3d(x, self.weight, self.stride, self.padding, precision)


class Norm(nn.Module):
    """Per-channel affine (``scale``, ``bias``) or GroupNorm (``weight``,
    ``bias``)."""

    def __init__(self, kind: str, ch: int):
        super().__init__()
        self.kind = kind
        _, a, b = norm_names(kind)
        self.a, self.b = a, b
        self.register_parameter(a, nn.Parameter(torch.empty(ch)))
        self.register_parameter(b, nn.Parameter(torch.empty(ch)))

    def forward(self, x):
        return norm(self.kind, x, getattr(self, self.a), getattr(self, self.b))


def add_pair(module: nn.Module, idx: int, kind: str, conv: ConvW) -> None:
    """``Conv_idx`` and its norm ``{Affine,GroupNorm}_idx``."""
    module.add_module(f"Conv_{idx}", conv)
    module.add_module(f"{norm_names(kind)[0]}_{idx}",
                      Norm(kind, conv.weight.shape[0]))


def conv_norm(module: nn.Module, idx: int, x, precision):
    conv = getattr(module, f"Conv_{idx}")
    nrm = getattr(module, f"{norm_names(module.kind)[0]}_{idx}")
    return nrm(conv(x, precision))


def run_block(block: nn.Module, x, precision, checkpoint: bool):
    """``block(x, precision)``, under activation checkpointing when asked
    (the reference's training memory; the arithmetic is the same)."""
    if checkpoint and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(block, x, precision,
                                                 use_reentrant=False)
    return block(x, precision)
