"""VGGish audio CNN (the port of avtex/nn/vggish.py).

conv-relu-pool twice, then (conv-relu) x2 + pool twice, on [100, 64]
log-mel patches; returns the flattened conv features (the reference's fc
head is bypassed, as in avtex): 512 * 6 * 4 = 12288 per example. Stock
cuDNN convs: avtex has no Pallas kernel here.

Layout: avtex runs channels-last, ``[B, frames, bands, 1]`` with H = 100
frames and W = 64 bands, and flattens ``[B, 6, 4, 512]`` in (frames,
bands, channels) order. The port takes ``[B, 100, 64]`` as
``[B, 1, 100, 64]`` NCHW in channels-last memory and flattens the same
order through ``permute(0, 2, 3, 1)``. ``padding="SAME"`` for a 3x3 conv
is ``padding=1``; flax's VALID max pool floors (25 -> 12) as
``max_pool2d`` does. Parameters are named as flax names them
(``Conv_0`` .. ``Conv_5``), conv weights and biases held in ``dtype``
(flax computes the bias add in the compute dtype too).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from avtex_torch.obs.spans import span

WIDTHS = ((64,), (128,), (256, 256), (512, 512))
# a named range, so a profile can attribute VGGish's device time
VGGISH_RANGE = "vggish"


class VGGish(nn.Module):
    """VGG-style audio feature extractor: [B, 100, 64] -> [B, 12288] fp32."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        cin, k = 1, 0
        for widths in WIDTHS:
            for w in widths:
                self.add_module(f"Conv_{k}", nn.Conv2d(cin, w, 3, padding=1))
                cin, k = w, k + 1
        self.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span(VGGISH_RANGE):
            if x.ndim == 4:  # avtex's [B, frames, bands, 1]
                x = x[..., 0]
            x = x[:, None].to(self.dtype).contiguous(
                memory_format=torch.channels_last)
            k = 0
            for widths in WIDTHS:
                for _ in widths:
                    x = torch.relu(getattr(self, f"Conv_{k}")(x))
                    k += 1
                x = F.max_pool2d(x, 2)
            return x.permute(0, 2, 3, 1).flatten(1).float()


def vggish_feat_dim(frames: int = 100, bands: int = 64) -> int:
    """Flattened feature size for a given mel-patch geometry."""
    f, b = frames, bands
    for _ in range(4):
        f, b = f // 2, b // 2
    return 512 * f * b
