"""Plain PyTorch pieces of the reference, shared by its models and loops.

Frozen copies of the plain arithmetic of avtex's path, written from its
definitions: the window gather, preprocessing (bilinear resize weights,
RGB->BGR, the normalisations, the SlowFast pathways), the training
sampler and augmentation draws, InfoNCE and SGD with momentum and weight
decay. Nothing here imports the program.

Precision: ``"fp32"`` is the reference; ``"fp8"`` is the control, the
same arithmetic with every convolution's input and weight rounded to
float8 e4m3 (a per-tensor scale to its largest finite value) and, in a
backward, its output gradient to float8 e5m2: the step below the bf16 the
configurations state.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F

CLIP_MEAN = (0.4345, 0.4051, 0.3775)
CLIP_STD = (0.2768, 0.2713, 0.2737)
SLOWFAST_MEAN = (0.45, 0.45, 0.45)
SLOWFAST_STD = (0.225, 0.225, 0.225)
_WEIGHT_EPS = 1000.0 * float(np.finfo(np.float32).eps)


@contextlib.contextmanager
def exact_fp32():
    """TF32 off in matmuls and cuDNN convolutions, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _round_fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / torch.finfo(dtype).max,
                        torch.ones_like(amax))
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    """Round to e4m3 forward; round the gradient to e5m2 backward."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, grad):
        return _round_fp8(grad, torch.float8_e5m2)


def conv3d(x, weight, stride, padding, precision: str = "fp32"):
    if precision == "fp8":
        x, weight = _Fp8.apply(x), _Fp8.apply(weight)
    elif precision != "fp32":
        raise ValueError(f"unknown precision {precision!r}")
    return F.conv3d(x, weight, None, stride, padding)


def norm(kind: str, x, weight, bias):
    """``"affine"``: ``x * scale + bias``; ``"group"``: GroupNorm with
    min(32, C) groups and eps 1e-6; per channel of NCDHW ``x``."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    if kind == "affine":
        return x * weight.view(shape) + bias.view(shape)
    if kind == "group":
        return F.group_norm(x, min(32, x.shape[1]), weight, bias, 1e-6)
    raise ValueError(f"unknown norm {kind!r}")


def norm_names(kind: str) -> Tuple[str, str, str]:
    """(module prefix, scale leaf, shift leaf) of a norm kind's
    parameters."""
    return (("Affine", "scale", "bias") if kind == "affine"
            else ("GroupNorm", "weight", "bias"))


# ---- preprocessing -------------------------------------------------------- #

def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] antialiased bilinear (triangle) weights, scale out/in,
    no translation."""
    f32 = np.float32
    inv_scale = f32(in_size / out_size)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None])
    w = np.maximum(0.0, 1.0 - x / kernel_scale).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > _WEIGHT_EPS,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.ascontiguousarray(np.where(inside[None], w, 0.0).T
                                .astype(f32))


def normalise(x: torch.Tensor, slowfast: bool) -> torch.Tensor:
    if slowfast:
        x = x.flip(-1)
        mean, std = SLOWFAST_MEAN, SLOWFAST_STD
    else:
        mean, std = CLIP_MEAN, CLIP_STD
    return ((x - torch.tensor(mean, device=x.device))
            / torch.tensor(std, device=x.device))


def preprocess(frames_u8: torch.Tensor, size: int, slowfast: bool):
    """uint8 ``[B, T, H, W, 3]`` -> float32 ``[B, T, size, size, 3]``."""
    x = frames_u8.float() / 255.0
    h, w = x.shape[-3:-1]
    if (h, w) != (size, size):
        wh = torch.from_numpy(resize_weights(h, size)).to(x.device)
        ww = torch.from_numpy(resize_weights(w, size)).to(x.device)
        x = torch.einsum("oh,bthwc->btowc", wh, x)
        x = torch.einsum("pw,btowc->btopc", ww, x)
    return normalise(x, slowfast)


def pathways(x: torch.Tensor, fast_frames: int, alpha: int):
    """(slow, fast) of ``[B, T, ...]`` clips: ``fast_frames`` frames evenly
    spaced over T (rounded), every ``alpha``-th of them from alpha // 2."""
    t = x.shape[1]
    idx = np.linspace(0, t - 1, fast_frames).round().astype(np.int64)
    fast = x[:, torch.from_numpy(idx).to(x.device)]
    return fast[:, alpha // 2::alpha], fast


def windows(video: np.ndarray, starts, window: int) -> np.ndarray:
    """uint8 ``[len(starts), window, H, W, 3]`` from a host video."""
    return np.stack([video[s:s + window] for s in starts])


# ---- training inputs ------------------------------------------------------ #

def num_train_segments(num_frames: int, window: int, stride: int) -> int:
    return (num_frames - window) // stride - 1


def _hard_negatives(idx: int, max_id: int) -> np.ndarray:
    cand = np.array([idx - 4, idx - 3, idx - 2, idx - 1,
                     idx + 2, idx + 3, idx + 4, idx + 5])
    cand = cand[cand >= 0]
    return cand[cand <= max_id]


def _negatives(idx: int, n_total: int, n_negs: int,
               rng: np.random.Generator) -> np.ndarray:
    ids = np.arange(n_total + 1)
    mask = np.ones(n_total + 1, dtype=bool)
    mask[[idx, idx + 1]] = False
    negs = rng.choice(ids[mask], n_negs, replace=False)
    hard = _hard_negatives(idx, n_total)[:n_negs]
    negs[:len(hard)] = hard
    return negs


def train_batches(num_frames: int, window: int, stride: int,
                  batch_size: int, n_negs: int, seed: int
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(query ids [B], target ids [B, 1 + negs]) of avtex's sampler in
    order: epoch e permutes the train segments with
    ``default_rng((seed, e))``, the positive of query i is i + 1, the
    negatives a draw without replacement whose head the hard negatives
    overwrite; a ragged last batch is dropped."""
    n_train = num_train_segments(num_frames, window, stride)
    epoch = 0
    while True:
        rng = np.random.default_rng((seed, epoch))
        order = rng.permutation(n_train)
        for b0 in range(0, n_train - batch_size + 1, batch_size):
            ids = order[b0:b0 + batch_size]
            t_ids = np.stack([np.concatenate(
                ([i + 1], _negatives(i, n_train, n_negs, rng)))
                for i in ids])
            yield ids, t_ids
        epoch += 1


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of step ``step``'s augmentation draws."""
    state = np.random.SeedSequence((seed + 1, step)).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def _short_side(s, h: int, w: int):
    if w < h:
        return torch.floor(s * (h / w)), s
    if h < w:
        return s, torch.floor(s * (w / h))
    return s, s


def draw_augment(b: int, h: int, w: int, size: int,
                 generator: torch.Generator, scale_range=(0.8, 1.2),
                 jitter: float = 0.2) -> Dict[str, torch.Tensor]:
    """Per-clip draws, in this order: short-side target, crop offsets,
    flip, brightness, contrast, saturation."""
    lo = max(size, int(round(size * scale_range[0])))
    hi = max(lo + 1, int(round(size * scale_range[1])))

    def uniform(n, a, b_):
        u = torch.rand((n,), generator=generator, dtype=torch.float32)
        return torch.clamp(u * (b_ - a) + a, min=a)

    s = torch.round(uniform(b, float(lo), float(hi)))
    nh, nw = _short_side(s, h, w)
    u = torch.rand((b, 2), generator=generator, dtype=torch.float32)
    zero = torch.zeros(())
    oy = torch.where(nh - size > 0, torch.floor(u[:, 0] * (nh - size)), zero)
    ox = torch.where(nw - size > 0, torch.floor(u[:, 1] * (nw - size)), zero)
    flip = torch.rand((b,), generator=generator) < 0.5
    bright, contrast, sat = (1.0 + uniform(b, -jitter, jitter)
                             for _ in range(3))
    return {"s": s, "oy": oy, "ox": ox, "flip": flip, "bright": bright,
            "contrast": contrast, "sat": sat}


def _scale_translate(in_size: int, out_size: int, scale, translation):
    """[B, out, in] bilinear weights (no antialias) of a per-clip scale
    and translation."""
    dev = scale.device
    inv = 1.0 / scale
    sample = ((torch.arange(out_size, dtype=torch.float32, device=dev)
               + 0.5)[None] * inv[:, None] - (translation * inv)[:, None]
              - 0.5)
    x = torch.abs(sample[:, None, :] - torch.arange(
        in_size, dtype=torch.float32, device=dev)[None, :, None])
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > _WEIGHT_EPS,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None, :], w, 0.0).transpose(1, 2)


def augment(frames_u8: torch.Tensor, d: Dict[str, torch.Tensor], size: int,
            slowfast: bool) -> torch.Tensor:
    """uint8 ``[B, T, H, W, 3]`` -> float32 ``[B, T, size, size, 3]``:
    short-side scale to s and a crop at (oy, ox) as one bilinear
    scale-and-translate, flip, brightness, contrast (about the clip mean),
    saturation (about the pixel's channel mean), clip to [0, 1],
    normalise."""
    x = frames_u8.float() / 255.0
    dev = x.device
    h, w = x.shape[2:4]
    s, oy, ox = (d[k].to(dev) for k in ("s", "oy", "ox"))
    nh, nw = _short_side(s, h, w)
    wy = _scale_translate(h, size, nh / h, -oy)
    wx = _scale_translate(w, size, nw / w, -ox)
    x = torch.einsum("boh,bthwc->btowc", wy, x)
    x = torch.einsum("bpw,btowc->btopc", wx, x)

    def clip(key):
        return d[key].to(dev).view(-1, 1, 1, 1, 1)

    x = torch.where(clip("flip"), x.flip(-2), x)
    x = x * clip("bright")
    mean = x.mean(dim=(-3, -2, -1), keepdim=True)
    x = (x - mean) * clip("contrast") + mean
    gray = x.mean(dim=-1, keepdim=True)
    x = (x - gray) * clip("sat") + gray
    return normalise(torch.clamp(x, 0.0, 1.0), slowfast)


def info_nce(q: torch.Tensor, t: torch.Tensor, temp: float) -> torch.Tensor:
    """Per-row InfoNCE of unit ``q [B, D]`` against unit ``t [B, N, D]``,
    the positive at column 0: ``[B]`` losses."""
    logits = torch.einsum("bd,bnd->bn", q, t) / temp
    return -torch.log_softmax(logits, dim=-1)[:, 0]


def unit(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)


def sgd_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             momentum: Dict[str, torch.Tensor], lr: float, mu: float,
             wd: float) -> None:
    """SGD with momentum (no dampening, not Nesterov) and weight decay
    added to the gradient, in place; ``momentum`` starts empty."""
    with torch.no_grad():
        for name, p in params.items():
            d = grads[name] + wd * p
            if name in momentum:
                momentum[name].mul_(mu).add_(d)
            else:
                momentum[name] = d.clone()
            p.sub_(lr * momentum[name])


def lr_at(step: int, lr: float, steps_per_epoch: int, lr_steps: int) -> float:
    transition = steps_per_epoch * lr_steps
    return lr if transition <= 0 else lr * 0.1 ** (step // transition)


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in tensors.items()}


def median(values) -> float:
    v = sorted(values)
    n = len(v)
    return 0.5 * (v[(n - 1) // 2] + v[n // 2]) if n else math.nan
