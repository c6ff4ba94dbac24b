"""The frozen operation counts against torch's FlopCounterMode on the
port's plain path, and the fused kernel's bound arithmetic."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench import flops, spec
from gpubench.trace import CallRecorder


def _config(name, **changes):
    with open(os.path.join(spec.PKG, "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg.update(changes)
    return cfg


def _port_encoder(cfg, device, norm="group", **kwargs):
    from avtex_torch.nn.encoders import build_encoder
    with torch.device(device):
        enc, _, kind = build_encoder(
            cfg["arch"], dtype=torch.float32, norm=norm,
            layers=tuple(cfg["layers"]), width=cfg["width"], **kwargs)
    return enc, kind


def _inputs(cfg, kind, device, clips=1):
    s = cfg["img_size"]
    if kind == "slowfast":
        return (torch.zeros(clips, cfg["slow_frames"], s, s, 3, device=device),
                torch.zeros(clips, cfg["fast_frames"], s, s, 3, device=device))
    return (torch.zeros(clips, cfg["clip_frames"], s, s, 3, device=device),)


def _counted(cfg, device, **kwargs):
    enc, kind = _port_encoder(cfg, device, **kwargs)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        enc(*_inputs(cfg, kind, device))
    return fc.get_total_flops()


@pytest.mark.parametrize("name,gflop", [("slowfast_r50_8x8", 100.615323648),
                                        ("r3d18", 64.063111168)])
def test_full_width_counts_match_flop_counter(name, gflop):
    cfg = _config(name)
    kw = {"s2d_stem": False} if cfg["family"] == "slowfast" else {}
    assert flops.forward_flops(cfg) == pytest.approx(gflop * 1e9, rel=1e-12)
    assert _counted(cfg, "meta", **kw) == flops.forward_flops(cfg)


@pytest.mark.parametrize("name", ["slowfast_r50_8x8", "r3d18"])
def test_small_width_counts_match_flop_counter_on_cpu(name):
    cfg = _config(name, width=8, img_size=32)
    kw = {"s2d_stem": False} if cfg["family"] == "slowfast" else {}
    assert _counted(cfg, "cpu", **kw) == flops.forward_flops(cfg)


def test_fused_bound_is_the_larger_of_bytes_and_operations():
    # a wide product: operations bound
    m, k, n = 8192, 2048, 2048
    ops = 2 * m * k * n / flops.PEAK_BF16_FLOP_S
    assert flops.fused_bound_s(m, k, n, False) == pytest.approx(ops)
    # a thin one: bytes bound, residual read once more
    m, k, n = 1 << 20, 64, 64
    nbytes = 2 * (m * k + n * k + 2 * m * n) + 8 * n
    assert flops.fused_bound_s(m, k, n, True) == pytest.approx(
        nbytes / flops.PEAK_HBM_BYTES_S)


def test_recorder_sees_every_fused_launch_of_a_tower_forward():
    """32 launches a tower forward at the published width (the shape rule
    of the port), each with its (m, k, n, residual)."""
    cfg = _config("slowfast_r50_8x8", img_size=32)
    enc, kind = _port_encoder(cfg, "cpu", norm="affine", fuse="all")
    from gpubench.spec import load_module
    reader = load_module("metrics", "fused_conv1x1_roofline")
    with torch.no_grad(), CallRecorder(*reader.RECORD, reader.shape) as rec:
        enc(*_inputs(cfg, kind, "cpu"))
    assert len(rec.calls) == 32
    assert all(m > 0 and k % 8 == 0 and n % 8 == 0 for m, k, n, _ in rec.calls)
    # conv3 with its residual: the 16 slow bottlenecks and fast res5's 3
    assert sum(r for *_, r in rec.calls) == 19
    assert flops.fused_bounds_total_s(rec.calls) > 0
