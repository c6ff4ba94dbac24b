"""One run of one cell: set-up, the measured window, the traced
window's per-layer metrics, the correctness check, one result line.

``python -m gpubench --workload <name> --seed <n> --seconds <s> --trace
<0|1>`` from the root of a checkout. The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number compared beside its limit); the same numbers close standard
error. The run needs as many CUDA devices as the cell asks for, and
exits with code 2 and no result without them; with code 3 and no result
if JAX or the JAX package ``avtex`` got loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import types
from typing import Optional

import torch

from gpubench import spec
from gpubench.harness import Spans, free
from gpubench.trace import CallRecorder, Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "avtex")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared as whole names (``avtex_torch`` is not
    ``avtex``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _device_info(device, chips: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t0: Optional[float] = None, root: str = spec.ROOT,
             fault: Optional[str] = None, overrides: Optional[dict] = None
             ) -> dict:
    """One run of ``workload``: the result object the command prints.
    ``fault`` plants a fault in the timed path and ``overrides``
    ({"config": {...}, "traffic": {...}}) changes sizes: for tests and
    the control's readings, never for the benchmark's runs."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = spec.resolve(workload, root)
    for key, changes in (overrides or {}).items():
        getattr(cell, key).update(changes)
    cuda = torch.device(device).type == "cuda"
    spans = Spans(traced=trace)
    driver = spec.load_module("drivers", cell.traffic["driver"], root).Driver(
        cell, seed, device, spans, fault=fault)
    driver.setup()
    readers = spec.metric_readers(cell, root) if trace else {}
    recorders = {name: CallRecorder(*mod.RECORD, mod.shape)
                 for name, mod in readers.items() if hasattr(mod, "RECORD")}
    tracer = Tracer(cuda) if trace else None
    if tracer is not None:
        tracer.__enter__()  # the profiler's start is set-up, not window
    for rec in recorders.values():
        rec.__enter__()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    try:
        work = driver.window(seconds)
    finally:
        for rec in recorders.values():
            rec.__exit__(None, None, None)
        if tracer is not None:
            tracer.__exit__(None, None, None)
    device_info = _device_info(device, cell.chips)
    metrics, extra = {}, {}
    if not trace:
        values = dict(driver.end_to_end(work), setup_s=setup_s)
        if cuda:
            values["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        for m in cell.end_to_end:
            if m["name"] not in values:  # a device metric on the CPU
                continue
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        summary = tracer.summary()
        ctx = types.SimpleNamespace(
            trace=summary, work=work, spans=dict(spans.seconds),
            window_s=summary.window_s if summary else 0.0,
            calls={n: r.calls for n, r in recorders.items()},
            config=cell.config, traffic=cell.traffic)
        for m in cell.per_layer:
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if summary is not None:
            device_info["busy_s"] = summary.busy_s()
            device_info["window_s"] = summary.window_s
            extra["breakdown"] = summary.breakdown()
    free(device)
    checks = driver.check(cell.limits)
    correct = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    return {"correct": bool(correct), "attempted": work["attempted"],
            "failed": work.get("failed", 0), "metrics": metrics,
            "device": device_info, **extra,
            "checks": {k: {"value": v, "limit": lim}
                       for k, (v, lim) in checks.items()}}


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python -m gpubench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: Optional[float] = None) -> int:
    args = parse_args(argv)
    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"gpubench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t0)
    found = forbidden_modules()
    if found:
        print(f"gpubench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
