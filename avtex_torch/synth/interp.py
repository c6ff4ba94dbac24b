"""SuperSloMo as the stitcher's ``interp_fn`` (the port of
avtex/synth/interp.py).

The reference's interpolate contract (interpolate.py:50-146): pad the two
frames to multiples of 32 (bottom/right, zeros after normalising; avtex
keeps this where the reference resizes, PARITY.md), subtract
``SLOMO_MEAN`` from [0, 1] values, run the net at t = (k+1)/(n_mid+1),
add the mean back, scale to [0, 255], clip and truncate to uint8, crop.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from avtex_torch.device import resolve_device
from avtex_torch.nn.slomo import SLOMO_MEAN, SuperSloMo

InterpFn = Callable[[np.ndarray, np.ndarray, int], np.ndarray]


def _pad32(h: int, w: int) -> Tuple[int, int]:
    return -(-h // 32) * 32, -(-w // 32) * 32


def init_slomo(seed: int = 0, dtype: torch.dtype = torch.bfloat16,
               device=None) -> SuperSloMo:
    """A SuperSloMo with random weights initialised as flax initialises
    avtex's (``lecun_normal`` kernels: a normal truncated at two standard
    deviations, std ``sqrt(1/fan_in)/0.8796``; zero biases), drawn on the
    CPU from ``torch.Generator().manual_seed(seed)``, on ``device``
    (``cuda`` unless ``device="cpu"``)."""
    dev = resolve_device(device)
    model = SuperSloMo(dtype)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            t = torch.zeros(p.shape)
            if name.endswith("weight"):
                std = math.sqrt(1.0 / math.prod(p.shape[1:])) \
                    / 0.87962566103423978
                torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                            generator=g)
            p.copy_(t)
    return model.to(dev).eval()


def make_interp_fn(model: SuperSloMo,
                   device: Optional[torch.device] = None) -> InterpFn:
    """``(frame0 u8 [H, W, 3], frame1 u8, n_mid) -> [n_mid, H, W, 3] u8``
    running ``model`` on its own device (or ``device``)."""
    dev = torch.device(device) if device is not None else \
        next(model.parameters()).device
    mean = torch.tensor(SLOMO_MEAN, device=dev).view(1, 3, 1, 1)

    @torch.inference_mode()
    def interp(frame0: np.ndarray, frame1: np.ndarray, n_mid: int
               ) -> np.ndarray:
        h, w = frame0.shape[:2]
        ph, pw = _pad32(h, w)

        def prep(frame):
            x = torch.from_numpy(np.ascontiguousarray(frame)).to(dev)
            x = x.permute(2, 0, 1)[None].float() / 255.0 - mean
            return F.pad(x, (0, pw - w, 0, ph - h))

        ts = tuple((k + 1) / (n_mid + 1) for k in range(n_mid))
        out = model(prep(frame0), prep(frame1), ts)[:, 0]
        out = ((out + mean) * 255.0).clamp(0, 255).to(torch.uint8)
        return out[:, :, :h, :w].permute(0, 2, 3, 1).cpu().numpy()

    return interp
