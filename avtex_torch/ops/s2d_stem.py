"""Space-to-depth form of the SlowFast stem convolutions (the port of
avtex/ops/s2d_stem.py).

Both stems are a stride-(1,2,2) 7x7 conv with torch padding
``(kt//2, 3, 3)``: the slow stem kt = 1, 3 -> 64 channels; the fast stem
kt = 5, 3 -> 8 channels. Their 3 input channels feed a matrix unit poorly.
The same arithmetic runs as a stride-1 conv on the input space-to-depth'd
by ``f`` in H and W (3 -> f*f*3 input channels) with the weights scattered
so that each (f/2 x f/2) block of output positions becomes channels:

  f = 4: a (kt, 3, 3) conv, 48 -> 4*O channels;
  f = 8: a (kt, 2, 2) conv, 192 -> 16*O channels.

Per spatial axis, in padded coordinates the tap of output ``2I + a`` at
kernel offset ``kh`` reads padded row ``f*I + 2a + kh``; writing
``2a + kh = f*dU + u`` puts it at s2d row ``I + dU``, phase channel ``u``.
Channels are phase-major: input ``(u*f + v)*C + c``, output
``(a*op + b)*O + o`` with ``op = f/2``.

Layout: every function takes avtex's channels-last ``[B, T, H, W, C]``
clip and returns ``[B, T, H', W', O]``, a free view of an NCDHW tensor in
``torch.channels_last_3d`` memory (what the encoder runs on).

``fast_stem_s2d_pooled`` runs the whole affine-mode stem (conv, folded-BN
affine, ReLU, 3x3 stride-2 max pool) in s2d space; the pool has two exact
forms (``pool="shuffle"``: de-s2d then ``max_pool3d``; ``pool="phase"``:
avtex's per-phase separable max, no de-s2d), bit-identical to each other.
These are stock torch ops (a gather for the weights, cuDNN for the conv):
avtex's version is plain XLA, not a Pallas kernel.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

CL3D = torch.channels_last_3d
POOLS = ("shuffle", "phase")


@functools.lru_cache(maxsize=None)
def _scatter_map(f: int) -> Tuple[np.ndarray, np.ndarray]:
    """(tap index into the flattened 7x7 kernel, validity mask), each of
    shape [op, op, f, f, ksz, ksz]: entry (a, b, u, v, du, dv) holds tap
    ``kh*7 + kw`` with ``2a + kh = f*du + u``, ``2b + kw = f*dv + v``."""
    op = f // 2
    ksz = (2 * (op - 1) + 6) // f + 1
    a, b, u, v, du, dv = np.meshgrid(*(np.arange(n) for n in (
        op, op, f, f, ksz, ksz)), indexing="ij")
    kh, kw = f * du + u - 2 * a, f * dv + v - 2 * b
    valid = (kh >= 0) & (kh < 7) & (kw >= 0) & (kw < 7)
    return np.where(valid, kh * 7 + kw, 0), valid


@functools.lru_cache(maxsize=None)
def _scatter_tensors(f: int, device: torch.device):
    # normal tensors even when first asked for under inference_mode (the
    # server's embed): a training step saves them for its backward
    idx, valid = _scatter_map(f)
    with torch.inference_mode(False):
        return (torch.from_numpy(idx.reshape(-1)).to(device),
                torch.from_numpy(valid.reshape(-1)).to(device))


def s2d_stem_kernel(weight: torch.Tensor, f: int = 4) -> torch.Tensor:
    """Stem weights ``[O, C, kt, 7, 7]`` -> the s2d-by-``f`` conv's
    ``[op*op*O, f*f*C, kt, ksz, ksz]`` (f = 4: ksz 3; f = 8: ksz 2), built
    by one gather from a fixed index map and a zero mask."""
    o, c, kt, kh, kw = weight.shape
    if (kh, kw) != (7, 7) or f not in (4, 8):
        raise ValueError(f"need [O, C, kt, 7, 7] weights and f in (4, 8), "
                         f"got {tuple(weight.shape)}, f={f}")
    op, ksz = f // 2, (2 * (f // 2 - 1) + 6) // f + 1
    idx, valid = _scatter_tensors(f, weight.device)
    g = weight.reshape(o, c, kt, 49).index_select(3, idx)
    g = torch.where(valid, g, torch.zeros((), dtype=g.dtype,
                                          device=g.device))
    g = g.view(o, c, kt, op, op, f, f, ksz, ksz)
    return g.permute(3, 4, 0, 5, 6, 1, 2, 7, 8).reshape(
        op * op * o, f * f * c, kt, ksz, ksz)


def space_to_depth(x: torch.Tensor, f: int) -> torch.Tensor:
    """``[B, T, H, W, C]`` -> NCDHW ``[B, f*f*C, T, Hp/f, Wp/f]`` in
    channels_last_3d memory, the stem's spatial pads (3 left, ``3 + (-(H+6))
    % f`` right) folded in; phase-major channels ``(u*f + v)*C + c``."""
    b, t, h, w, c = x.shape
    x = F.pad(x, (0, 0, 3, 3 + (-(w + 6)) % f, 3, 3 + (-(h + 6)) % f))
    hb, wb = x.shape[2] // f, x.shape[3] // f
    x = x.view(b, t, hb, f, wb, f, c).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(b, t, hb, wb, f * f * c).permute(0, 4, 1, 2, 3)


def _s2d_conv(x: torch.Tensor, weight: torch.Tensor, f: int) -> torch.Tensor:
    """The scattered-weight conv: NCDHW ``[B, op*op*O, T, H/f, W/f]``."""
    kt = weight.shape[2]
    kp = s2d_stem_kernel(weight, f).contiguous(memory_format=CL3D)
    return F.conv3d(space_to_depth(x, f), kp, padding=(kt // 2, 0, 0))


def depth_to_space(y: torch.Tensor, op: int) -> torch.Tensor:
    """NCDHW ``[B, op*op*O, T, Hb, Wb]`` with phase-major channels ->
    channels-last ``[B, T, op*Hb, op*Wb, O]`` (one copy)."""
    b, cc, t, hb, wb = y.shape
    o = cc // (op * op)
    y = y.permute(0, 2, 3, 4, 1).reshape(b, t, hb, wb, op, op, o)
    return y.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, t, hb * op, wb * op, o)


def _channels_last(y: torch.Tensor) -> torch.Tensor:
    """NCDHW -> the ``[B, T, H, W, C]`` view (free in channels_last_3d)."""
    return y.permute(0, 2, 3, 4, 1)


def stem_conv_plain(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The stem conv as avtex's reference writes it: one ``conv3d``,
    stride (1, 2, 2), padding (kt//2, 3, 3)."""
    kt = weight.shape[2]
    xn = x.permute(0, 4, 1, 2, 3).contiguous(memory_format=CL3D)
    return _channels_last(F.conv3d(xn, weight, stride=(1, 2, 2),
                                   padding=(kt // 2, 3, 3)))


def _stem_pool(y: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 pad-1 spatial max pool, channels-last in and out."""
    y = y.permute(0, 4, 1, 2, 3).contiguous(memory_format=CL3D)
    return _channels_last(F.max_pool3d(y, (1, 3, 3), (1, 2, 2), (0, 1, 1)))


def _affine_relu(y: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """Per-channel ``relu(y*scale + bias)`` on dim 1, in y's dtype."""
    shape = (1, -1) + (1,) * (y.ndim - 2)
    return torch.relu(y * scale.to(y.dtype).view(shape)
                      + bias.to(y.dtype).view(shape))


def stem_pooled_plain(x: torch.Tensor, weight: torch.Tensor,
                      scale: torch.Tensor, bias: torch.Tensor
                      ) -> torch.Tensor:
    """The plain affine-mode stem: conv, affine, ReLU, max pool."""
    y = stem_conv_plain(x, weight).permute(0, 4, 1, 2, 3)
    return _stem_pool(_channels_last(_affine_relu(y, scale, bias)))


def fast_stem_s2d(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The stem conv through the s2d-by-4 form; equals
    ``stem_conv_plain(x, weight)`` up to the order of the sums.
    ``x``: ``[B, T, H, W, C]`` with H, W multiples of 4."""
    h, w = x.shape[2:4]
    if h % 4 or w % 4:
        raise ValueError(f"fast_stem_s2d needs H, W multiples of 4, got "
                         f"{tuple(x.shape)}")
    return depth_to_space(_s2d_conv(x, weight, 4), 2)[:, :, :h // 2,
                                                       :w // 2]


def _pool_phases(y: torch.Tensor) -> torch.Tensor:
    """The pool straight from the s2d-by-2 phase planes of the dense
    image (avtex's ``_pool_des2d``, "rw"): dense tap ``2i + d`` for
    d in {0, 1} is row (i, phase d), for d = -1 row (i - 1, phase 1), so
    phase (a, b) contributes a (1+a) x (1+b) max reaching up and left.
    ``y``: NCDHW ``[B, 4*O, T, Hb, Wb]`` -> ``[B, T, Hb, Wb, O]``."""
    o = y.shape[1] // 4
    p = [y[:, k * o:(k + 1) * o] for k in range(4)]
    hb, wb = y.shape[3], y.shape[4]

    def reach(z, dh, dw):
        z = F.max_pool3d(z, (1, 1 + dh, 1 + dw), 1, (0, dh, dw))
        return z[:, :, :, :hb, :wb]

    out = torch.maximum(torch.maximum(p[0], reach(p[1], 0, 1)),
                        torch.maximum(reach(p[2], 1, 0), reach(p[3], 1, 1)))
    return _channels_last(out)


def _refold_8_to_4(y: torch.Tensor) -> torch.Tensor:
    """f = 8 output (4x4 phases, ``(a*4 + b)*O``) -> the f = 4 layout
    (2x2 phases on a grid twice as fine): dense row ``4I + a`` is
    ``2(2I + a//2) + a%2``. NCDHW in and out."""
    b, cc, t, hb, wb = y.shape
    o = cc // 16
    y = y.permute(0, 2, 3, 4, 1).reshape(b, t, hb, wb, 2, 2, 2, 2, o)
    y = y.permute(0, 1, 2, 4, 3, 6, 5, 7, 8).reshape(
        b, t, 2 * hb, 2 * wb, 4 * o)
    return y.permute(0, 4, 1, 2, 3)


def stem_factor(o: int, h: int, w: int, f: Optional[int] = None) -> int:
    """The s2d factor used: ``f`` (None means 4), with 8 falling back to
    4 where avtex's does (more than 8 outputs, or H, W not multiples of
    8)."""
    f = f or 4
    if f == 8 and not (o <= 8 and h % 8 == 0 and w % 8 == 0):
        return 4
    return f


def fast_stem_s2d_pooled(x: torch.Tensor, weight: torch.Tensor,
                         scale: torch.Tensor, bias: torch.Tensor, *,
                         f: Optional[int] = None,
                         pool: str = "shuffle") -> torch.Tensor:
    """The whole affine-mode stem in s2d space: the scattered conv (the
    temporal pad folded into its padding), affine + ReLU on the
    phase-major channels (scale and bias repeated per phase), then the
    pool (``pool``: "shuffle" or "phase"). Equals
    ``stem_pooled_plain(x, weight, scale, bias)`` up to the order of the
    conv's sums. ``x``: ``[B, T, H, W, C]`` with H, W multiples of 4;
    returns ``[B, T, H/4, W/4, O]``."""
    h, w = x.shape[2:4]
    if h % 4 or w % 4:
        raise ValueError(f"fast_stem_s2d_pooled needs H, W multiples of 4, "
                         f"got {tuple(x.shape)}")
    if pool not in POOLS:
        raise ValueError(f"pool must be one of {POOLS}, got {pool!r}")
    f = stem_factor(weight.shape[0], h, w, f)
    reps = (f // 2) ** 2
    y = _affine_relu(_s2d_conv(x, weight, f), scale.repeat(reps),
                     bias.repeat(reps))
    if pool == "shuffle":
        return _stem_pool(depth_to_space(y, f // 2))
    return _pool_phases(_refold_8_to_4(y) if f == 8 else y)
