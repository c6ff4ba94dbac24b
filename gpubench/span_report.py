"""Where a cell's time goes, by the program's own spans.

    python -m gpubench.span_report --workload <name> --seeds 1,2 \\
        [--seconds 30]

For each seed, in one process: the cell's set-up and one traced window
at the cell's own load, as ``run_cell`` runs them with ``--trace 1``.
One JSON line a seed, per video or per step (per ``embed.video`` or
``train.step`` span): the device ms launched inside each span name, the
device idle ms by the innermost span open on the loop's thread, the
device busy ms and the HtoD copies' ms, the harness's own ``idle_gaps``,
and every wait for a batch that found the queue empty with the batch it
waited for (the prefetch thread's last ``data.gather`` to end before it).
The benchmark's own runs never run this; what tracing costs is read
from ``python -m gpubench`` runs with ``--trace 0`` and ``--trace 1``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from gpubench import program_spans, spec
from gpubench.harness import Spans, free
from gpubench.trace import Tracer

ROOTS = {"embed": "embed.video", "train": "train.step"}


def _empty_waits(spans) -> list:
    """(wait ms, epoch, batch, gather ms) of each ``data.wait`` that found
    the queue empty, with the last ``data.gather`` to end before it."""
    gathers = sorted(program_spans.named(spans, "data.gather"),
                     key=lambda s: s.end_ns)
    out = []
    for w in program_spans.named(spans, "data.wait"):
        if w.attrs.get("queued") != 0:
            continue
        done = [g for g in gathers if g.end_ns <= w.end_ns]
        g = done[-1] if done else None
        out.append([(w.end_ns - w.start_ns) / 1e6,
                    None if g is None else g.attrs.get("epoch"),
                    None if g is None else g.attrs.get("batch"),
                    None if g is None else (g.end_ns - g.start_ns) / 1e6])
    return out


def analyse(summary, spans, root: str) -> dict:
    """The traced window's spans against its device events."""
    roots = program_spans.named(spans, root)
    n = len(roots)
    if not n:
        return {"roots": 0}
    thread = roots[0].thread
    names = sorted({s.name for s in spans if s.thread == thread})
    device = {k: program_spans.device_ms(summary, spans, k) / n
              for k in names}
    idle = {k: v / n for k, v in program_spans.idle_by_innermost(
        summary, spans, thread).items()}
    htod, _ = summary.device_s(lambda name: "htod" in name.lower())
    children = [s for s in spans if s.parent in {r.id for r in roots}]
    child_names = sorted({s.name for s in children})
    gathers = program_spans.named(spans, "data.gather")
    waits = program_spans.named(spans, "data.wait")
    return {
        "roots": n, "window_s": summary.window_s,
        "busy_ms": 1e3 * summary.busy_s() / n, "htod_ms": 1e3 * htod / n,
        "device_ms": device,
        "children_device_ms": sum(device[k] for k in child_names),
        "idle_ms": idle,
        "root_idle_ms": program_spans.idle_ms(summary, spans, root) / n,
        "wait_idle_ms": program_spans.idle_ms(summary, spans,
                                              "data.wait") / n,
        "harness_idle_gaps_s": summary.idle_gaps(),
        "gathers": len(gathers),
        "gather_ms": sorted((g.end_ns - g.start_ns) / 1e6 for g in gathers),
        "waits": len(waits),
        "queued": [w.attrs.get("queued") for w in waits],
        "empty_waits": _empty_waits(spans)}


def report(workload: str, seed: int, seconds: float, device="cuda",
           overrides=None) -> dict:
    """One seed's line; ``overrides`` changes sizes as in ``run_cell``
    (the CPU tests run tiny cells through it)."""
    from avtex_torch.obs import spans as program
    cell = spec.resolve(workload)
    for key, changes in (overrides or {}).items():
        getattr(cell, key).update(changes)
    cuda = torch.device(device).type == "cuda"
    driver_kind = cell.traffic["driver"]
    driver = spec.load_module("drivers", driver_kind).Driver(
        cell, seed, device, Spans(traced=True))
    driver.setup()
    tracer = Tracer(cuda)
    tracer.__enter__()
    try:
        driver.window(seconds)
    finally:
        tracer.__exit__(None, None, None)
    summary = tracer.summary()
    out = {"workload": workload, "seed": seed,
           "device": torch.cuda.get_device_name(0) if cuda else "cpu",
           **analyse(summary, program.collect(*summary.window),
                     ROOTS[driver_kind])}
    program.clear()
    del driver, tracer, summary
    gc.collect()
    free(device)
    return out


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="python -m gpubench.span_report")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(report(args.workload, seed, args.seconds)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
