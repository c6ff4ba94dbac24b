"""Synthesis outputs beside the videos: CAM overlays, per-step bar plots
and the HTML report (the port's copy of avtex/obs/visualizations.py).
matplotlib is imported at use, by the bar plots only.

``overlay_cam`` is avtex's CAM overlay without OpenCV or matplotlib (the
GPU host has neither), in torch on the image's device: the map is
min-max normalised, resized with ``cv2.resize``'s bilinear arithmetic on
float32 (half-pixel centres, edge clamping, a horizontal pass then a
vertical one, each tap pair one fused multiply-add), coloured through a
256-entry copy of matplotlib's ``jet`` lookup table (built from its
segment data as matplotlib builds it) and blended in float64, each step
truncated to uint8 as numpy does.
"""

from __future__ import annotations

import functools
import html
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

# matplotlib's jet (matplotlib/_cm.py): per channel (x, y0, y1) points
_JET_DATA = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
            (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1),
              (0.91, 0, 0), (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
             (1.0, 0, 0)),
}
JET_N = 256


def _segment_lut(data, n: int) -> np.ndarray:
    """matplotlib's ``_create_lookup_table(n, data)`` (gamma 1), float64."""
    adata = np.array(data, dtype=float)
    x, y0, y1 = adata[:, 0] * (n - 1), adata[:, 1], adata[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1])
                          + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


@functools.lru_cache(maxsize=1)
def jet_lut() -> np.ndarray:
    """[256, 3] float64 RGB of matplotlib's ``cm.jet`` lookup table."""
    return np.stack([_segment_lut(_JET_DATA[c], JET_N)
                     for c in ("red", "green", "blue")], axis=1)


@functools.lru_cache(maxsize=32)
def _linear_taps(in_size: int, out_size: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``cv2.resize``'s INTER_LINEAR taps for float images: for each
    output index the two source indices and the float32 weight of the
    second (the sample position in float64, its fraction rounded to
    float32, zero where the position is clamped to an edge)."""
    pos = (np.arange(out_size) + 0.5) * (1.0 / (out_size / in_size)) - 0.5
    i0 = np.floor(pos).astype(np.int64)
    frac = (pos - i0).astype(np.float32)
    frac[(i0 < 0) | (i0 >= in_size - 1)] = 0.0
    i0 = np.clip(i0, 0, in_size - 1)
    return i0, np.minimum(i0 + 1, in_size - 1), frac


def _lerp(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """float32 ``fma(b - a, w, a)``, as OpenCV's vectorised linear resize
    computes it: the exact product and sum in float64, rounded once."""
    return ((b - a).double() * w.double() + a.double()).float()


def _resize_linear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """float32 [..., h, w] -> [..., out_h, out_w] as ``cv2.resize(x,
    (out_w, out_h))`` computes it for h, w >= 2: a horizontal pass, then
    a vertical one. (OpenCV's scalar loop tails weight the two taps
    separately, which can round one float32 ulp apart.)"""
    dev = x.device
    x0, x1, fx = (torch.from_numpy(t).to(dev)
                  for t in _linear_taps(x.shape[-1], out_w))
    y0, y1, fy = (torch.from_numpy(t).to(dev)
                  for t in _linear_taps(x.shape[-2], out_h))
    rows = _lerp(x[..., x0], x[..., x1], fx)
    return _lerp(rows[..., y0, :], rows[..., y1, :], fy[:, None])


def overlay_cam(image, cam, alpha: float = 0.5):
    """Overlay a class-activation map on an image (jet colormap blend), as
    avtex/obs/visualizations.py:17-31 does.

    image: uint8 [..., H, W, 3]; cam: [..., h, w] activations (any scale),
    one map per image. numpy inputs give a numpy uint8 array (computed on
    the CPU); tensors give a uint8 tensor on the image's device.
    """
    as_numpy = not isinstance(image, torch.Tensor)
    img = torch.as_tensor(np.asarray(image) if as_numpy else image)
    c = torch.as_tensor(np.asarray(cam) if not isinstance(cam, torch.Tensor)
                        else cam).to(img.device, torch.float32)
    lo = c.amin(dim=(-2, -1), keepdim=True)
    c = (c - lo) / ((c.amax(dim=(-2, -1), keepdim=True) - lo) + 1e-8)
    c = _resize_linear(c, img.shape[-3], img.shape[-2])
    idx = torch.floor(c * JET_N).clamp(0, JET_N - 1).long()
    heat_lut = torch.from_numpy((jet_lut() * 255).astype(np.uint8))
    heat = heat_lut.to(img.device)[idx]
    out = (alpha * heat.double() + (1 - alpha) * img.double()).to(torch.uint8)
    return out.numpy() if as_numpy else out


def save_bar_plot(values: Sequence[float], path: str, title: str,
                  xlabel: str = "step") -> str:
    """Bar PNG of a per-step statistic (entropy / non-zero counts)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig = plt.figure(figsize=(10, 3))
    ax = fig.add_subplot(1, 1, 1)
    ax.bar(np.arange(len(values)), np.asarray(values, dtype=float))
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def generate_html_report(out_path: str, videos: Dict[str, str],
                         stats: Optional[Dict[str, float]] = None,
                         title: str = "avtex results") -> str:
    """Write a small gallery page linking the result videos, with a table
    of ``stats``."""
    rows = []
    for name, path in videos.items():
        rows.append(
            f"<div class='item'><h3>{html.escape(name)}</h3>"
            f"<video controls width='480' src='{html.escape(path)}'>"
            f"</video></div>")
    stat_rows = ""
    if stats:
        cells = "".join(f"<tr><td>{html.escape(k)}</td><td>{v}</td></tr>"
                        for k, v in stats.items())
        stat_rows = f"<table border='1'>{cells}</table>"
    doc = (f"<!doctype html><html><head><meta charset='utf-8'>"
           f"<title>{html.escape(title)}</title></head>"
           f"<body><h1>{html.escape(title)}</h1>{stat_rows}"
           f"{''.join(rows)}</body></html>")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(doc)
    return out_path
