"""Device-side clip preprocessing (the port of avtex/data/preprocess.py:35-73).

uint8 windows go to the device once; the cast, resize and normalisation
run there. The resize reproduces ``jax.image.resize(method="bilinear",
antialias=True)`` exactly: the two ``[size, H]`` / ``[size, W]`` triangle-
filter weight matrices are built in numpy the way
``jax.image.scale_and_translate`` computes them (``F.interpolate``'s
antialias mode is not guaranteed to agree, and takes only 4-D NCHW), and
are applied with two einsums on the device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

CLIP_MEAN = (0.4345, 0.4051, 0.3775)
CLIP_STD = (0.2768, 0.2713, 0.2737)
SLOWFAST_MEAN = (0.45, 0.45, 0.45)
SLOWFAST_STD = (0.225, 0.225, 0.225)


@functools.lru_cache(maxsize=32)
def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] antialiased bilinear weights, float32, following
    jax's ``compute_weight_mat`` (scale = out/in, translation 0)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))  # host double, then f32
    kernel_scale = max(inv_scale, f32(1.0))  # widen the filter to downsample
    sample_f = ((np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.5))
    x = (np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None])
         / kernel_scale)
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))          # triangle
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = np.where(inside[None, :], w, f32(0.0))
    return np.ascontiguousarray(w.T.astype(f32))


def _resize_clip(x: torch.Tensor, size: int) -> torch.Tensor:
    """Antialiased bilinear resize of float [..., H, W, C] to (size, size);
    identity sizes return the input unchanged."""
    h, w = x.shape[-3], x.shape[-2]
    if h == size and w == size:
        return x
    wh = torch.from_numpy(_resize_weights(h, size)).to(x.device, x.dtype)
    ww = torch.from_numpy(_resize_weights(w, size)).to(x.device, x.dtype)
    x = torch.einsum("oh,...hwc->...owc", wh, x)
    return torch.einsum("pw,...owc->...opc", ww, x)


def preprocess_clip(frames: torch.Tensor, size: int = 224,
                    slowfast: bool = False) -> torch.Tensor:
    """uint8 RGB [..., T, H, W, 3] -> normalised float32 [..., T, size, size, 3].

    Non-SlowFast: square resize + the reference's clip normalisation.
    SlowFast: /255, RGB->BGR, then the SlowFast mean/std.
    """
    x = frames.to(torch.float32) / 255.0
    x = _resize_clip(x, size)
    if slowfast:
        x = x.flip(-1)  # RGB -> BGR
        mean, std = SLOWFAST_MEAN, SLOWFAST_STD
    else:
        mean, std = CLIP_MEAN, CLIP_STD
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean) / std
