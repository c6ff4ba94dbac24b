"""Device-side clip preprocessing and train-time augmentation (the port
of avtex/data/preprocess.py).

uint8 windows go to the device once; the cast, resize, augmentation and
normalisation run there. The resize reproduces ``jax.image.resize(method=
"bilinear")`` exactly: the two ``[size, H]`` / ``[size, W]`` triangle-
filter weight matrices are built the way ``jax.image.scale_and_translate``
computes them (``F.interpolate``'s antialias mode is not guaranteed to
agree, and takes only 4-D NCHW), and are applied with two einsums.

Augmentation (``augment_and_preprocess``) is split in two, because torch
cannot reproduce ``jax.random``: ``draw_augment_params`` draws each
clip's short-side target, crop offsets, flip and colour factors from an
explicit CPU ``torch.Generator`` (avtex's distribution, another stream),
and ``apply_augment`` applies given draws, equal to avtex's under avtex's
own draws. The scale jitter and crop of a clip is one bilinear
scale-and-translate (no antialias), as per-clip ``[size, H]`` and
``[size, W]`` interpolation matrices applied as two batched products.

``random_short_side_scale_jitter`` and ``lighting_jitter`` are host-side
and take avtex's legacy ``np.random`` stream, so their draws are
bit-exact with avtex's under the same ``RandomState``.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

CLIP_MEAN = (0.4345, 0.4051, 0.3775)
CLIP_STD = (0.2768, 0.2713, 0.2737)
SLOWFAST_MEAN = (0.45, 0.45, 0.45)
SLOWFAST_STD = (0.225, 0.225, 0.225)
# ImageNet statistics: only the eval composite scale_uniform_crop_norm
# uses them.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_WEIGHT_EPS = 1000.0 * float(np.finfo(np.float32).eps)


@functools.lru_cache(maxsize=32)
def _resize_weights(in_size: int, out_size: int,
                    antialias: bool = True) -> np.ndarray:
    """[out_size, in_size] bilinear weights, float32, following jax's
    ``compute_weight_mat`` (scale = out/in, translation 0)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))  # host double, then f32
    # antialias widens the filter to downsample
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
    sample_f = ((np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.5))
    x = (np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None])
         / kernel_scale)
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))          # triangle
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > _WEIGHT_EPS,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = np.where(inside[None, :], w, f32(0.0))
    return np.ascontiguousarray(w.T.astype(f32))


def _resize(x: torch.Tensor, out_h: int, out_w: int,
            antialias: bool = True) -> torch.Tensor:
    """Bilinear resize of float [..., H, W, C] to (out_h, out_w), as
    ``jax.image.resize``; identity sizes return the input unchanged."""
    h, w = x.shape[-3], x.shape[-2]
    if h == out_h and w == out_w:
        return x
    wh = torch.from_numpy(_resize_weights(h, out_h, antialias))
    ww = torch.from_numpy(_resize_weights(w, out_w, antialias))
    x = torch.einsum("oh,...hwc->...owc", wh.to(x.device, x.dtype), x)
    return torch.einsum("pw,...owc->...opc", ww.to(x.device, x.dtype), x)


def _resize_clip(x: torch.Tensor, size: int) -> torch.Tensor:
    """Antialiased bilinear resize of float [..., H, W, C] to (size, size)."""
    return _resize(x, size, size)


def _normalize(x: torch.Tensor, slowfast: bool) -> torch.Tensor:
    """SlowFast: RGB->BGR and the SlowFast mean/std; else the reference's
    clip normalisation."""
    if slowfast:
        x = x.flip(-1)  # RGB -> BGR
        mean, std = SLOWFAST_MEAN, SLOWFAST_STD
    else:
        mean, std = CLIP_MEAN, CLIP_STD
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def preprocess_clip(frames: torch.Tensor, size: int = 224,
                    slowfast: bool = False) -> torch.Tensor:
    """uint8 RGB [..., T, H, W, 3] -> normalised float32 [..., T, size, size, 3].

    Non-SlowFast: square resize + the reference's clip normalisation.
    SlowFast: /255, RGB->BGR, then the SlowFast mean/std.
    """
    x = frames.to(torch.float32) / 255.0
    return _normalize(_resize_clip(x, size), slowfast)


def _short_side(s: torch.Tensor, h: int, w: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nh, nw) for short-side targets ``s``: the short side becomes s,
    the long side floor(ratio * s), in float32."""
    if w < h:
        return torch.floor(s * (h / w)), s
    if h < w:
        return s, torch.floor(s * (w / h))
    return s, s


def augment_sizes(size: int, scale_range: Tuple[float, float] = (0.8, 1.2)
                  ) -> Tuple[int, int]:
    """Short-side target range [round(size*lo), round(size*hi)], clamped so
    the crop always fits (short side >= size)."""
    min_size = max(size, int(round(size * scale_range[0])))
    return min_size, max(min_size + 1, int(round(size * scale_range[1])))


def draw_augment_params(b: int, h: int, w: int, size: int,
                        generator: torch.Generator,
                        scale_range: Tuple[float, float] = (0.8, 1.2),
                        jitter: float = 0.2) -> Dict[str, torch.Tensor]:
    """Per-clip augmentation draws for ``b`` clips of ``h x w`` frames,
    from ``generator`` (on the CPU), in avtex's distribution: short-side
    target ``s = round(uniform(min, max))``; crop offsets ``oy, ox =
    floor(u * (n - size))`` for u ~ U[0, 1) (0 where the resized side
    equals ``size``; the last offset is never drawn); ``flip`` with
    p = 0.5; ``bright``, ``contrast``, ``sat`` ~ U[1 - jitter, 1 + jitter].
    Returns float32 tensors of shape [b] (``flip`` bool)."""
    min_size, max_size = augment_sizes(size, scale_range)

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return torch.clamp(u * (hi - lo) + lo, min=lo)

    s = torch.round(uniform((b,), float(min_size), float(max_size)))
    nh, nw = _short_side(s, h, w)
    u = torch.rand((b, 2), generator=generator, dtype=torch.float32)
    lim_y, lim_x = nh - size, nw - size
    zero = torch.zeros(())
    oy = torch.where(lim_y > 0, torch.floor(u[:, 0] * lim_y), zero)
    ox = torch.where(lim_x > 0, torch.floor(u[:, 1] * lim_x), zero)
    flip = torch.rand((b,), generator=generator) < 0.5
    bright, contrast, sat = (1.0 + uniform((b,), -jitter, jitter)
                             for _ in range(3))
    return {"s": s, "oy": oy, "ox": ox, "flip": flip, "bright": bright,
            "contrast": contrast, "sat": sat}


def _scale_translate_weights(in_size: int, out_size: int,
                             scale: torch.Tensor,
                             translation: torch.Tensor) -> torch.Tensor:
    """[B, out_size, in_size] bilinear weights (no antialias) of one
    scale-and-translate per clip, as jax's ``compute_weight_mat`` builds
    them from a traced float32 scale and translation."""
    dev = scale.device
    inv_scale = 1.0 / scale
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=dev)
                 + 0.5)[None] * inv_scale[:, None]
                - (translation * inv_scale)[:, None] - 0.5)
    x = torch.abs(sample_f[:, None, :] - torch.arange(
        in_size, dtype=torch.float32, device=dev)[None, :, None])
    w = torch.clamp(1.0 - x, min=0.0)  # triangle, [B, in, out]
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > _WEIGHT_EPS,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], w, 0.0).transpose(1, 2)


def _jittered_scale_crop(x: torch.Tensor, params: Dict[str, torch.Tensor],
                         size: int) -> torch.Tensor:
    """Short-side scale to ``s`` then a ``size`` crop at (oy, ox), per
    clip of float [B, T, H, W, C], as one scale-and-translate (scale
    (nh/H, nw/W), translation (-oy, -ox), bilinear, no antialias):
    avtex's ``jax.image.scale_and_translate`` per clip."""
    h, w = x.shape[2], x.shape[3]
    s, oy, ox = (params[k].to(x.device) for k in ("s", "oy", "ox"))
    nh, nw = _short_side(s, h, w)
    wy = _scale_translate_weights(h, size, nh / h, -oy)
    wx = _scale_translate_weights(w, size, nw / w, -ox)
    x = torch.einsum("boh,bthwc->btowc", wy, x)
    return torch.einsum("bpw,btowc->btopc", wx, x)


def apply_augment(frames: torch.Tensor, params: Dict[str, torch.Tensor],
                  size: int = 224, slowfast: bool = False) -> torch.Tensor:
    """uint8 [B, T, H, W, 3] -> normalised float32 [B, T, size, size, 3]
    under given draws (``draw_augment_params``): scale jitter + crop,
    horizontal flip, brightness / contrast / saturation, clip to [0, 1],
    then ``preprocess_clip``'s normalisation. Each clip's draws hold for
    all its frames."""
    x = frames.to(torch.float32) / 255.0
    x = _jittered_scale_crop(x, params, size)
    dev = x.device

    def per_clip(key):
        return params[key].to(dev).view(-1, 1, 1, 1, 1)

    x = torch.where(per_clip("flip"), x.flip(-2), x)
    x = x * per_clip("bright")
    mean_l = x.mean(dim=(-3, -2, -1), keepdim=True)
    x = (x - mean_l) * per_clip("contrast") + mean_l
    gray = x.mean(dim=-1, keepdim=True)
    x = (x - gray) * per_clip("sat") + gray
    return _normalize(torch.clamp(x, 0.0, 1.0), slowfast)


def augment_and_preprocess(frames: torch.Tensor, generator: torch.Generator,
                           size: int = 224, slowfast: bool = False,
                           scale_range: Tuple[float, float] = (0.8, 1.2),
                           jitter: float = 0.2) -> torch.Tensor:
    """Train-time augmentation, whole-clip-consistent: draws from
    ``generator`` (``draw_augment_params``), then ``apply_augment``."""
    b, _, h, w = frames.shape[:4]
    params = draw_augment_params(b, h, w, size, generator, scale_range,
                                 jitter)
    return apply_augment(frames, params, size, slowfast)


def uniform_crop(x: torch.Tensor, size: int, spatial_idx: int = 1
                 ) -> torch.Tensor:
    """Uniform spatial crop of [..., H, W, C]: spatial_idx 0/1/2 is
    left/center/right when W >= H, else top/center/bottom; the centre
    offset is ceil((dim - size) / 2)."""
    h, w = x.shape[-3], x.shape[-2]
    y_off = -(-(h - size) // 2)
    x_off = -(-(w - size) // 2)
    if h > w:
        y_off = {0: 0, 1: y_off, 2: h - size}[spatial_idx]
    else:
        x_off = {0: 0, 1: x_off, 2: w - size}[spatial_idx]
    return x[..., y_off:y_off + size, x_off:x_off + size, :]


def scale_uniform_crop_norm(frames: torch.Tensor, scale_size: int = 240,
                            crop_size: int = 224, spatial_idx: int = 1
                            ) -> torch.Tensor:
    """Eval composite: /255, a bilinear resize to (scale_size, scale_size)
    without antialias, a uniform crop to crop_size, ImageNet
    normalisation."""
    x = frames.to(torch.float32) / 255.0
    x = uniform_crop(_resize(x, scale_size, scale_size, antialias=False),
                     crop_size, spatial_idx)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def random_short_side_scale_jitter(frames, min_size: int, max_size: int,
                                   rng=None,
                                   inverse_uniform_sampling: bool = False
                                   ) -> torch.Tensor:
    """Short-side scale jitter of [..., H, W, C] frames, host-side.

    Draws a short-side target ``round(rng.uniform(min, max))`` (or the
    reciprocal-uniform variant) from ``rng`` (default: the legacy
    ``np.random`` module, avtex's stream); returns the frames as float32,
    unchanged when the short side already matches, else resized so the
    short side is the target and the long side ``floor(ratio * target)``
    (bilinear, no antialias)."""
    if rng is None:
        rng = np.random
    frames = torch.as_tensor(frames).to(torch.float32)
    if inverse_uniform_sampling:
        size = int(round(1.0 / rng.uniform(1.0 / max_size, 1.0 / min_size)))
    else:
        size = int(round(rng.uniform(min_size, max_size)))
    h, w = frames.shape[-3], frames.shape[-2]
    if (w <= h and w == size) or (h <= w and h == size):
        return frames
    new_h = new_w = size
    if w < h:
        new_h = int(math.floor(float(h) / w * size))
    else:
        new_w = int(math.floor(float(w) / h * size))
    return _resize(frames, new_h, new_w, antialias=False)


def lighting_jitter(frames, alphastd: float, eigval, eigvec,
                    rng: Optional[np.random.RandomState] = None):
    """AlexNet-style PCA lighting jitter of [..., C] frames, host-side.

    One ``alpha ~ N(0, alphastd)^3`` draw from ``rng`` (default: the
    legacy ``np.random`` module) per call; channel c gets ``rgb[2 - c]``
    (the reference's channel-reversed index, kept). Returns float32;
    with ``alphastd == 0`` the frames unchanged."""
    if rng is None:
        rng = np.random
    if alphastd == 0:
        return frames
    alpha = rng.normal(0, alphastd, size=(1, 3))
    eig_vec = np.array(eigvec)
    eig_val = np.reshape(eigval, (1, 3))
    rgb = np.sum(eig_vec * np.repeat(alpha, 3, axis=0)
                 * np.repeat(eig_val, 3, axis=0), axis=1)
    shift = torch.tensor(rgb[::-1].copy(), dtype=torch.float32)
    frames = torch.as_tensor(frames)
    return frames.to(torch.float32) + shift.to(frames.device)
