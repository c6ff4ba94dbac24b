"""The readings that set a cell's limits, on the chip at the cell's size.

    python -m gpubench.control --workload <name> --seeds 1,2,3 \\
        [--seconds 3] [--fault <name>] [--control 1]

For each seed, in one process: the cell's set-up and a short window at
its own load, then the numbers its check compares, of the program (or of
the program with ``--fault`` planted) and, with ``--control 1``, of the
control: the reference computed in fp8 in the program's place. One JSON
line a seed. The benchmark's own runs never run this.

Embed cells read one number, the widest row distance; training cells
read the loss, first-gradient and change gaps (``drivers/train.py``'s
``compare``), the control's against the fp32 reference as the
program's are.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from gpubench import spec
from gpubench.harness import Spans, free
from gpubench.reference import common
from gpubench.run import forbidden_modules


def readings(workload: str, seed: int, seconds: float, device="cuda",
             fault=None, control: bool = False, overrides=None) -> dict:
    cell = spec.resolve(workload)
    for key, changes in (overrides or {}).items():
        getattr(cell, key).update(changes)
    module = spec.load_module("drivers", cell.traffic["driver"])
    driver = module.Driver(cell, seed, device, Spans(), fault=fault)
    t0 = time.perf_counter()
    driver.setup()
    if seconds > 0:
        driver.window(seconds)
    free(device)
    r = driver.readings(control=control)
    out = {"workload": workload, "seed": seed, "fault": fault,
           "seconds": time.perf_counter() - t0}
    if cell.traffic["driver"] == "embed":
        out["program"] = {"embed_gap": r["program"]}
        if control:
            out["control"] = {"embed_gap": r["control"]}
        return out
    limits = {k: float("inf") for k in module.NUMBERS}
    ref = r["reference"]
    for key in ("program",) + (("control",) if control else ()):
        p = r[key]
        checks = module.compare(p["losses"], p["grad_norms"],
                                p["change_norms"], ref, limits)
        out[key] = {k: v for k, (v, _) in checks.items()}
        out[key + "_leaves"] = {
            what: _worst_leaves(p[what], ref[what])
            for what in ("grad_norms", "change_norms")}
    out["losses"] = {"program": r["program"]["losses"],
                     "reference": ref["losses"]}
    return out


def _worst_leaves(prog, ref, n=6):
    """The ``n`` leaves with the widest gap, ``[gap, name, program norm,
    reference norm]``, as the check measures a gap."""
    med = common.median(ref.values())
    rows = sorted(([abs(prog[k] - ref[k]) / max(ref[k], med), k, prog[k],
                    ref[k]] for k in ref), reverse=True)
    return rows[:n]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m gpubench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fault", default=None)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--overrides", default=None,
                   help='JSON, e.g. {"config": {"compute_dtype": "float32"}}')
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("gpubench.control needs a CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.seconds,
                                  fault=args.fault,
                                  control=bool(args.control),
                                  overrides=json.loads(args.overrides)
                                  if args.overrides else None)),
              flush=True)
        free("cuda")
    found = forbidden_modules()
    if found:
        print(f"loaded {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
