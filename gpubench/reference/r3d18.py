"""3D ResNet-18, plain (Hara et al., CVPR 2018; the r3d family).

A 7^3 stem conv to 64 channels, spatial stride 2, norm, ReLU, a 3^3 max
pool of stride 2; BasicBlocks (2, 2, 2, 2) of two 3^3 convs at widths
64-512, the first conv of each stage from the second strided 2 in time
and space, a 1^3 projection shortcut where the shape changes; the global
mean. Padding k // 2. Parameter names follow the program's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ConvW, add_pair, conv_norm, run_block

INPUT_KIND = "clip"


class BasicBlock(nn.Module):
    def __init__(self, cin, f, stride, kind):
        super().__init__()
        self.kind = kind
        s = (stride,) * 3
        add_pair(self, 0, kind, ConvW(cin, f, (3, 3, 3), s))
        add_pair(self, 1, kind, ConvW(f, f, (3, 3, 3)))
        self.proj = cin != f or stride != 1
        if self.proj:
            add_pair(self, 2, kind, ConvW(cin, f, (1, 1, 1), s))

    def forward(self, x, precision):
        y = torch.relu(conv_norm(self, 0, x, precision))
        y = conv_norm(self, 1, y, precision)
        r = conv_norm(self, 2, x, precision) if self.proj else x
        return torch.relu(y + r)


class Encoder(nn.Module):
    """``forward(clips, precision)`` on channels-last ``[B, T, H, W, 3]``
    clips -> ``[B, 8 * width]`` float32."""

    def __init__(self, cfg: dict, kind: str):
        super().__init__()
        self.kind = kind
        k = cfg["stem_kernel"]
        add_pair(self, 0, kind, ConvW(3, cfg["stem_channels"], (k, k, k),
                                      (1, 2, 2)))
        cin, idx = cfg["stem_channels"], 0
        for i, n in enumerate(cfg["layers"]):
            feats = cfg["width"] * 2 ** i
            for j in range(n):
                self.add_module(f"BasicBlock3D_{idx}", BasicBlock(
                    cin, feats, 2 if (i > 0 and j == 0) else 1, kind))
                cin, idx = feats, idx + 1
        self.n_blocks = idx

    def forward(self, x, precision="fp32", checkpoint=False):
        x = x.float().permute(0, 4, 1, 2, 3)
        x = torch.relu(conv_norm(self, 0, x, precision))
        x = F.max_pool3d(x, 3, 2, 1)
        for i in range(self.n_blocks):
            x = run_block(getattr(self, f"BasicBlock3D_{i}"), x, precision,
                          checkpoint)
        return x.mean(dim=(2, 3, 4))


def build(cfg: dict, kind: str) -> Encoder:
    return Encoder(cfg, kind)
