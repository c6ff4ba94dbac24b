"""The inputs of a run, made from its seed: synthetic source videos and the
model's weights.

Both go to the program and to the reference alike. The same seed gives
the same inputs on one kind of device; every seed gives the same shapes,
so the seed changes the content and never the work.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

# lecun_normal: a normal cut at two standard deviations, rescaled so that
# the cut distribution has variance 1 / fan_in (flax's truncated normal).
_TRUNC_STD = 0.87962566103423978


def video_params(seed: int, index: int) -> Dict[str, np.ndarray]:
    """Spatial frequencies, phases, drift and flicker of video ``index``,
    drawn per channel from ``(seed, index)``."""
    rng = np.random.default_rng([seed, index])
    return {"fx": rng.uniform(8.0, 24.0, 3), "fy": rng.uniform(8.0, 24.0, 3),
            "px": rng.uniform(0.0, 2 * math.pi, 3),
            "py": rng.uniform(0.0, 2 * math.pi, 3),
            "vx": rng.uniform(-2.0, 2.0, 3), "vy": rng.uniform(-2.0, 2.0, 3),
            "ft": rng.uniform(6.0, 12.0), "pt": rng.uniform(0.0, 2 * math.pi)}


def synthetic_video(seed: int, index: int, seconds: float, fps: int,
                    size: int, device="cpu",
                    chunk_frames: int = 150) -> np.ndarray:
    """uint8 RGB frames ``[seconds * fps, size, size, 3]`` on the host:
    drifting sine/cosine gratings per channel, flickering in time, made on
    ``device`` in chunks of frames (a decoded video is host memory)."""
    p = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
         for k, v in video_params(seed, index).items()}
    n = int(round(seconds * fps))
    coord = torch.arange(size, dtype=torch.float32, device=device)
    out = np.empty((n, size, size, 3), dtype=np.uint8)
    for f0 in range(0, n, chunk_frames):
        t = torch.arange(f0, min(n, f0 + chunk_frames), dtype=torch.float32,
                         device=device)[:, None, None, None]
        xx = coord[None, None, :, None] - p["vx"] * t
        yy = coord[None, :, None, None] - p["vy"] * t
        base = (torch.sin(xx / p["fx"] + p["px"])
                + torch.cos(yy / p["fy"] + p["py"]))
        flicker = 0.75 + 0.25 * torch.sin(t / p["ft"] + p["pt"])
        frames = torch.clamp(127.0 + 60.0 * base * flicker, 0.0, 255.0)
        out[f0:f0 + len(t)] = frames.to(torch.uint8).cpu().numpy()
    return out


def _kind(name: str, shape: Tuple[int, ...]) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) >= 2:
        return "kernel"
    if leaf in ("scale", "weight"):
        return "scale"
    if leaf == "bias":
        return "shift"
    raise KeyError(f"no initialiser for {name!r} of shape {shape}")


def seeded_weights(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
                   device="cpu", served: bool = False
                   ) -> Dict[str, torch.Tensor]:
    """fp32 weights by name from ``seed``, made on ``device`` in a few
    large calls: kernels (every leaf of two or more dims) lecun-normal
    (fan_in = the product of all dims but the first). Norm scales and
    shifts are the trainer's init (ones, zeros), or with ``served`` those
    of a trained or BN-folded model, drawn per channel: scales uniform on
    [0.5, 1.5), shifts normal with standard deviation 0.1. Each kind is a
    view of one buffer drawn at once, kernels first."""
    shapes = [(n, tuple(s)) for n, s in shapes]
    g = torch.Generator(device=device).manual_seed(int(seed))
    out = {}

    def draw(kind, fill):
        leaves = [(n, s) for n, s in shapes if _kind(n, s) == kind]
        counts = [math.prod(s) for _, s in leaves]
        buf = torch.empty(sum(counts), dtype=torch.float32, device=device)
        fill(buf, leaves, counts)
        off = 0
        for (name, shape), count in zip(leaves, counts):
            out[name] = buf[off:off + count].view(shape)
            off += count

    def kernels(buf, leaves, counts):
        torch.nn.init.trunc_normal_(buf, 0.0, 1.0, -2.0, 2.0, generator=g)
        std = torch.tensor([math.sqrt(1.0 / math.prod(s[1:])) / _TRUNC_STD
                            for _, s in leaves], dtype=torch.float32,
                           device=device)
        buf.mul_(torch.repeat_interleave(
            std, torch.tensor(counts, device=device)))

    def scales(buf, leaves, counts):
        if served:
            buf.uniform_(0.5, 1.5, generator=g)
        else:
            buf.fill_(1.0)

    def shifts(buf, leaves, counts):
        if served:
            buf.normal_(0.0, 0.1, generator=g)
        else:
            buf.zero_()

    draw("kernel", kernels)
    draw("scale", scales)
    draw("shift", shifts)
    return {name: out[name] for name, _ in shapes}
