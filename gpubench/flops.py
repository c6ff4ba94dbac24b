"""Operations and bytes counted from shapes, and the chip's peaks.

Frozen here, apart from the program, so that no change to the program can
move the yardstick. Every count is of one clip-forward of one encoder
(one tower), at the sizes a configuration file gives; a convolution
counts ``2 * output elements * C_in * kernel volume`` operations (torch's
``FlopCounterMode`` rule), and nothing else in the forward is counted.

- ``conv_layers(config)``: the encoder's convolutions in forward order,
  each with its input and output shapes for one clip.
- ``forward_flops(config)``: their operations, one clip-forward.
- ``fused_bound_s(m, k, n, residual)``: the least time the fused 1x1
  kernel can take for one launch, the larger of its bytes over the HBM
  rate and its operations over the bf16 tensor-core rate.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit.
PEAK_BF16_FLOP_S = 989e12
PEAK_HBM_BYTES_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class Conv:
    """One convolution of one clip: ``cin x (t, h, w)`` in,
    ``cout x (to, ho, wo)`` out, ``kernel`` and ``stride`` per dim."""

    name: str
    cin: int
    cout: int
    kernel: Tuple[int, int, int]
    stride: Tuple[int, int, int]
    padding: Tuple[int, int, int]
    t: int
    h: int
    w: int

    @property
    def out_dims(self) -> Tuple[int, int, int]:
        return tuple((d + 2 * p - k) // s + 1 for d, p, k, s in zip(
            (self.t, self.h, self.w), self.padding, self.kernel,
            self.stride))

    @property
    def flops(self) -> int:
        return (2 * self.cout * math.prod(self.out_dims) * self.cin
                * math.prod(self.kernel))


def _pool(dims, kernel, stride, padding):
    return tuple((d + 2 * p - k) // s + 1
                 for d, k, s, p in zip(dims, kernel, stride, padding))


def _slowfast(cfg: dict) -> List[Conv]:
    size, w = cfg["img_size"], cfg["width"]
    alpha, beta_inv = cfg["alpha"], cfg["beta_inv"]
    tf = cfg["fast_frames"]
    ts = tf // alpha
    wf = w // beta_inv
    lat_k = cfg["fusion_kernel"]
    convs = [Conv("slow_stem", 3, w, (1, 7, 7), (1, 2, 2), (0, 3, 3),
                  ts, size, size),
             Conv("fast_stem", 3, wf, (5, 7, 7), (1, 2, 2), (2, 3, 3),
                  tf, size, size)]
    slow = _pool(convs[0].out_dims, (1, 3, 3), (1, 2, 2), (0, 1, 1))
    fast = _pool(convs[1].out_dims, (1, 3, 3), (1, 2, 2), (0, 1, 1))

    def lateral(name, cin, dims):
        return Conv(name, cin, 2 * cin, (lat_k, 1, 1), (alpha, 1, 1),
                    (lat_k // 2, 0, 0), *dims)

    convs.append(lateral("lateral_stem", wf, fast))
    slow_ch, fast_ch = w + 2 * wf, wf
    t_kernels = cfg["slow_temporal_kernels"]
    for i, n_blocks in enumerate(cfg["layers"]):
        feats = w * 2 ** i
        for j in range(n_blocks):
            s = 2 if (i > 0 and j == 0) else 1
            for path, cin, f, tk, dims in (
                    ("slow", slow_ch, feats, t_kernels[i], slow),
                    ("fast", fast_ch, feats // beta_inv,
                     cfg["fast_temporal_kernel"], fast)):
                name = f"res{i + 2}.{j}.{path}"
                c0 = Conv(name + ".conv0", cin, f, (tk, 1, 1), (1, 1, 1),
                          (tk // 2, 0, 0), *dims)
                c1 = Conv(name + ".conv1", f, f, (1, 3, 3), (1, s, s),
                          (0, 1, 1), *dims)
                out = c1.out_dims
                c2 = Conv(name + ".conv2", f, 4 * f, (1, 1, 1), (1, 1, 1),
                          (0, 0, 0), *out)
                convs += [c0, c1, c2]
                if cin != 4 * f or s != 1:
                    convs.append(Conv(name + ".proj", cin, 4 * f, (1, 1, 1),
                                      (1, s, s), (0, 0, 0), *dims))
                if path == "slow":
                    slow, slow_ch = out, 4 * f
                else:
                    fast, fast_ch = out, 4 * f
        if i != len(cfg["layers"]) - 1:
            convs.append(lateral(f"lateral_res{i + 2}", fast_ch, fast))
            slow_ch += 2 * fast_ch
    return convs


def _r3d(cfg: dict) -> List[Conv]:
    size, t = cfg["img_size"], cfg["clip_frames"]
    k, cin = cfg["stem_kernel"], cfg["stem_channels"]
    stem = Conv("stem", 3, cin, (k, k, k), (1, 2, 2), (k // 2,) * 3, t,
                size, size)
    convs = [stem]
    dims = _pool(stem.out_dims, (3, 3, 3), (2, 2, 2), (1, 1, 1))
    for i, n_blocks in enumerate(cfg["layers"]):
        feats = cfg["width"] * 2 ** i
        for j in range(n_blocks):
            s = 2 if (i > 0 and j == 0) else 1
            name = f"res{i + 2}.{j}"
            c0 = Conv(name + ".conv0", cin, feats, (3, 3, 3), (s, s, s),
                      (1, 1, 1), *dims)
            out = c0.out_dims
            convs += [c0, Conv(name + ".conv1", feats, feats, (3, 3, 3),
                               (1, 1, 1), (1, 1, 1), *out)]
            if cin != feats or s != 1:
                convs.append(Conv(name + ".proj", cin, feats, (1, 1, 1),
                                  (s, s, s), (0, 0, 0), *dims))
            dims, cin = out, feats
    return convs


_FAMILIES = {"slowfast": _slowfast, "resnet3d_basic": _r3d}


def conv_layers(cfg: dict) -> List[Conv]:
    """The encoder's convolutions of one clip-forward, in forward order."""
    return _FAMILIES[cfg["family"]](cfg)


def forward_flops(cfg: dict) -> int:
    """Operations of one clip-forward of one tower."""
    return sum(c.flops for c in conv_layers(cfg))


def fused_bound_s(m: int, k: int, n: int, residual: bool) -> float:
    """Least seconds of one ``fused_conv1x1`` launch on ``x [m, k]``,
    ``weight [n, k]`` (bf16), fp32 scale and bias ``[n]``, an optional bf16
    residual ``[m, n]`` and a bf16 output ``[m, n]``: each input byte read
    once and each output byte written once over the HBM rate, or its
    ``2mkn`` operations over the bf16 rate, whichever is longer."""
    nbytes = (2 * (m * k + n * k + m * n + (m * n if residual else 0))
              + 8 * n)
    return max(nbytes / PEAK_HBM_BYTES_S, 2 * m * k * n / PEAK_BF16_FLOP_S)


def fused_bounds_total_s(launches: Sequence[Tuple[int, int, int, bool]]
                         ) -> float:
    return sum(fused_bound_s(*shape) for shape in launches)
