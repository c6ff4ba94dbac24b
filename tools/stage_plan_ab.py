#!/usr/bin/env python3
"""Time fused_stage's seven path blocks under other launch plans (GPU only).

    python3 tools/stage_plan_ab.py default wg1 wg2 default

Slow res2 (80 -> 64 -> 256, stride 1) and res3 (320 -> 128 -> 512,
stride 2) of SlowFast-R50 at BT = 1200 slices of 56 x 56, seeded random
weights: per block the kernel's ms and TFLOP/s, then each stage against
the plain version on its first 4 slices (relative Frobenius error). Each
argument is a plan preset: ``default`` (``stage_fused.plan``), ``wg1`` or
``wg2`` (every block pinned to one or two consumer warpgroups, the plan
choosing the rest), ``res3wg1`` (res3's block 0 on one warpgroup). Run
the presets in turns (a, b, b, a) within one call to compare them.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from avtex_torch.ops import stage_fused as sf  # noqa: E402

STAGES = {"res2": (80, 64, 256, 3, 1), "res3": (320, 128, 512, 4, 2)}
BLOCKS = [(name, i) for name, spec in STAGES.items() for i in range(spec[3])]
PRESETS = {
    "default": {},
    "wg1": {k: {"warpgroups": 1} for k in BLOCKS},
    "wg2": {k: {"warpgroups": 2} for k in BLOCKS},
    "res3wg1": {("res3", 0): {"warpgroups": 1}},
}


def random_stage(cin, f, cout, n_blocks, g):
    def mk(*shape):
        fan_in = shape[-2] * (9 if len(shape) == 4 else 1)
        return (torch.randn(*shape, generator=g) * fan_in ** -0.5).cuda()

    def aff(n):
        return ((torch.rand(n, generator=g) + 0.5).cuda(),
                (torch.randn(n, generator=g) * 0.1).cuda())

    blocks, c = [], cin
    for i in range(n_blocks):
        (s1, b1), (s2, b2), (s3, b3) = aff(f), aff(f), aff(cout)
        sp, bp = aff(cout) if i == 0 else (None, None)
        blocks.append(sf.BlockWeights(
            mk(c, f), s1, b1, mk(3, 3, f, f), s2, b2, mk(f, cout), s3, b3,
            mk(c, cout) if i == 0 else None, sp, bp))
        c = cout
    return blocks


def time_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run_stage(x, blocks, packed, f, cout, stride, pins, name, timed):
    """The stage under the preset's plans: (output, [(ms, TFLOP/s)])."""
    rows = []
    for i, pk in enumerate(packed):
        s = stride if i == 0 else 1
        bt, h, w, c = x.shape
        p = sf.plan(h, w, c, f, cout, s, proj=i == 0, bt=bt,
                    **pins.get((name, i), {}))
        if timed:
            ms = time_ms(lambda: sf.launch_block(x, pk, s, p))
            flops = 2 * bt * (h * w * c * f + (h // s) * (w // s) * (
                9 * f * f + f * cout + (c * cout if i == 0 else 0)))
            rows.append((ms, flops / ms / 1e9, p))
        x = sf.launch_block(x, pk, s, p)
    return x, rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("presets", nargs="+", choices=sorted(PRESETS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stage_plan_ab: needs a CUDA device", file=sys.stderr)
        return 1
    g = torch.Generator(device="cpu").manual_seed(0)
    data = {}
    for name, (cin, f, cout, n, stride) in STAGES.items():
        blocks = random_stage(cin, f, cout, n, g)
        x = torch.randn(1200, 56, 56, cin, generator=g).to("cuda",
                                                          torch.bfloat16)
        data[name] = (x, blocks, [sf.pack_block(b, "cuda") for b in blocks])
    for preset in args.presets:
        pins, total, parts = PRESETS[preset], 0.0, []
        for name, (cin, f, cout, n, stride) in STAGES.items():
            x, blocks, packed = data[name]
            _, rows = run_stage(x, blocks, packed, f, cout, stride, pins,
                                name, True)
            total += sum(r[0] for r in rows)
            parts += [f"{name}.{i} {ms:.3f} ms {tf:.0f} TFLOP/s "
                      f"(tile {p['tile'][0]}x{p['tile'][1]}, "
                      f"{p['warpgroups']} wg, {p['b_stages']} slots)"
                      for i, (ms, tf, p) in enumerate(rows)]
            small = x[:4].contiguous()
            got, _ = run_stage(small, blocks, packed, f, cout, stride, pins,
                               name, False)
            want = sf.stage_reference(small, blocks, stride).float()
            fro = float((got.float() - want).norm() / want.norm())
            parts.append(f"{name} stage rel Frobenius {fro:.2g}")
        print(f"{preset}: {total:.3f} ms; " + "; ".join(parts), flush=True)
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
