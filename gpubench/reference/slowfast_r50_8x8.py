"""SlowFast-R50, plain (Feichtenhofer et al., ICCV 2019; PySlowFast's
SLOWFAST_8x8_R50).

Two pathways: slow (T/alpha frames, width w) and fast (T frames, width
w / beta_inv). Stems: a (1, 7, 7) conv (slow) and a (5, 7, 7) conv
(fast), both spatial stride 2, norm, ReLU, a (1, 3, 3) max pool of
stride (1, 2, 2). Lateral fast->slow fusions after the stem and after
res2-res4: a (7, 1, 1) conv of temporal stride alpha to twice the fast
channels, norm, ReLU, concatenated onto the slow channels. Bottlenecks
[3, 4, 6, 3] with the temporal kernel on the first 1x1 conv (slow 1, 1,
3, 3; fast 3), the 3x3 strided at each stage's first block from res3,
a projection shortcut where the shape changes. The head concatenates the
global means of both pathways (32w + 4w, 2304 at w = 64).
Padding is k // 2 on every conv. Parameter names follow the program's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import conv3d, norm_names
from .layers import ConvW, Norm, add_pair, conv_norm, run_block

INPUT_KIND = "slowfast"


class Bottleneck(nn.Module):
    def __init__(self, cin, f, t_kernel, stride, kind):
        super().__init__()
        self.kind = kind
        add_pair(self, 0, kind, ConvW(cin, f, (t_kernel, 1, 1)))
        add_pair(self, 1, kind, ConvW(f, f, (1, 3, 3), (1, stride, stride)))
        add_pair(self, 2, kind, ConvW(f, 4 * f, (1, 1, 1)))
        self.proj = cin != 4 * f or stride != 1
        if self.proj:
            add_pair(self, 3, kind, ConvW(cin, 4 * f, (1, 1, 1),
                                          (1, stride, stride)))

    def forward(self, x, precision):
        y = torch.relu(conv_norm(self, 0, x, precision))
        y = torch.relu(conv_norm(self, 1, y, precision))
        y = conv_norm(self, 2, y, precision)
        r = conv_norm(self, 3, x, precision) if self.proj else x
        return torch.relu(y + r)


class Encoder(nn.Module):
    """``forward((slow, fast), precision)`` on channels-last
    ``[B, T, H, W, 3]`` pathways -> ``[B, feat]`` float32."""

    def __init__(self, cfg: dict, kind: str):
        super().__init__()
        self.kind = kind
        w, bi, alpha = cfg["width"], cfg["beta_inv"], cfg["alpha"]
        wf, lat = w // bi, cfg["fusion_kernel"]
        self.layers = list(cfg["layers"])
        self.alpha = alpha
        prefix = norm_names(kind)[0]
        add_pair(self, 0, kind, ConvW(3, w, (1, 7, 7), (1, 2, 2), (0, 3, 3)))
        self.fast_stem_kernel = nn.Parameter(torch.empty(wf, 3, 5, 7, 7))
        self.add_module(f"{prefix}_1", Norm(kind, wf))
        self.Conv_1 = ConvW(wf, 2 * wf, (lat, 1, 1), (alpha, 1, 1))
        self.add_module(f"{prefix}_2", Norm(kind, 2 * wf))
        slow_ch, fast_ch, idx = w + 2 * wf, wf, 0
        t_kernels = cfg["slow_temporal_kernels"]
        for i, n in enumerate(self.layers):
            feats = w * 2 ** i
            for j in range(n):
                s = 2 if (i > 0 and j == 0) else 1
                self.add_module(f"SFBottleneck_{idx}", Bottleneck(
                    slow_ch, feats, t_kernels[i], s, kind))
                self.add_module(f"SFBottleneck_{idx + 1}", Bottleneck(
                    fast_ch, feats // bi, cfg["fast_temporal_kernel"], s,
                    kind))
                slow_ch, fast_ch = 4 * feats, 4 * feats // bi
                idx += 2
            if i != len(self.layers) - 1:
                self.add_module(f"Conv_{2 + i}", ConvW(
                    fast_ch, 2 * fast_ch, (lat, 1, 1), (alpha, 1, 1)))
                self.add_module(f"{prefix}_{3 + i}",
                                Norm(kind, 2 * fast_ch))
                slow_ch += 2 * fast_ch

    def _norm(self, idx):
        return getattr(self, f"{norm_names(self.kind)[0]}_{idx}")

    def _lateral(self, fast, idx, precision):
        y = getattr(self, f"Conv_{idx - 1}")(fast, precision)
        return torch.relu(self._norm(idx)(y))

    def stems(self, slow, fast, precision):
        slow = slow.permute(0, 4, 1, 2, 3)
        fast = fast.permute(0, 4, 1, 2, 3)
        slow = torch.relu(self._norm(0)(self.Conv_0(slow, precision)))
        fast = torch.relu(self._norm(1)(conv3d(
            fast, self.fast_stem_kernel, (1, 2, 2), (2, 3, 3), precision)))
        slow = F.max_pool3d(slow, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        fast = F.max_pool3d(fast, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        return torch.cat([slow, self._lateral(fast, 2, precision)], 1), fast

    def forward(self, x, precision="fp32", checkpoint=False):
        slow, fast = (p.float() for p in x)
        slow, fast = self.stems(slow, fast, precision)
        idx = 0
        for i, n in enumerate(self.layers):
            for _ in range(n):
                slow = run_block(getattr(self, f"SFBottleneck_{idx}"), slow,
                                 precision, checkpoint)
                fast = run_block(getattr(self, f"SFBottleneck_{idx + 1}"),
                                 fast, precision, checkpoint)
                idx += 2
            if i != len(self.layers) - 1:
                slow = torch.cat([slow, self._lateral(fast, 3 + i,
                                                      precision)], 1)
        return torch.cat([slow.mean(dim=(2, 3, 4)),
                          fast.mean(dim=(2, 3, 4))], dim=-1)


def build(cfg: dict, kind: str) -> Encoder:
    return Encoder(cfg, kind)
