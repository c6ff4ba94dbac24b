"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Each piece lives in a file of its own under ``gpubench/``:

- ``configs/<config>.json``: the model's sizes (the file the
  configuration's entry names);
- ``traffic/<traffic>.json``: the mix's parameters; its ``driver`` names
  the loop that runs it, ``drivers/<driver>.py``;
- ``metrics/<metric>.py``: the reader of one per-layer metric;
- ``limits/<workload>.json``: the limits of the cell's correctness check.

So a later cell, configuration, mix or metric is new files and new
entries, never an edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Dict, List, Optional

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCHMARK_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
                  "end_to_end", "per_layer"}


class SpecError(ValueError):
    pass


@dataclasses.dataclass
class Cell:
    """One workload entry with everything it resolves to."""

    name: str
    config_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _read_json(path: str) -> dict:
    if not os.path.isfile(path):
        raise SpecError(f"missing file {path}")
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell_metrics(bench: dict, workload: str):
    """(end-to-end, per-layer) metric entries that ``workload`` reports.
    A per-layer metric without a ``workloads`` list goes to every cell
    that reports its ``moves``."""
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if m["moves"] in names and _applies(m, workload)]
    return e2e, per


def resolve(workload: str, root: str = ROOT,
            bench: Optional[dict] = None) -> Cell:
    """The cell named ``workload`` with its configuration, traffic and
    limits read from their files under ``root``."""
    bench = load_benchmark(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SpecError(f"unknown workload {workload!r}; have "
                        f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"{workload}: unknown config {w['config']!r}")
    config = _read_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _read_json(os.path.join(root, "gpubench", "traffic",
                                      w["traffic"] + ".json"))
    limits = _read_json(os.path.join(root, "gpubench", "limits",
                                     workload + ".json"))
    e2e, per = cell_metrics(bench, workload)
    return Cell(workload, w["config"], int(w["chips"]), config, traffic,
                limits, e2e, per)


def load_module(kind: str, name: str, root: str = ROOT) -> ModuleType:
    """``gpubench/<kind>/<name>.py`` as a module (names may hold dots, so
    it is loaded from its path, not imported by name)."""
    path = os.path.join(root, "gpubench", kind, name + ".py")
    if not os.path.isfile(path):
        raise SpecError(f"missing {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"gpubench.{kind}.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_readers(cell: Cell, root: str = ROOT) -> Dict[str, ModuleType]:
    return {m["name"]: load_module("metrics", m["name"], root)
            for m in cell.per_layer}


def validate(bench: dict, root: str = ROOT) -> List[str]:
    """The contract's limits on ``BENCHMARK.json`` that a file can be
    checked for without a run; returns the faults found."""
    faults = []
    if set(bench) != BENCHMARK_KEYS:
        faults.append(f"keys {sorted(bench)} != {sorted(BENCHMARK_KEYS)}")
    groups = (("configs",), ("workloads",), ("end_to_end", "per_layer"))
    for group in groups:
        names = [e.get("name", "") for g in group for e in bench.get(g, [])]
        faults += [f"{group}: bad name {n!r}" for n in names
                   if not NAME_RE.match(n)]
        faults += [f"{group}: duplicate name {n!r}" for n in set(names)
                   if names.count(n) > 1]
    e2e_names = {m["name"] for m in bench.get("end_to_end", [])}
    cells = {w["name"] for w in bench.get("workloads", [])}
    for m in bench.get("end_to_end", []) + bench.get("per_layer", []):
        if not UNIT_RE.match(m.get("unit", "")):
            faults.append(f"{m.get('name')}: bad unit {m.get('unit')!r}")
        if m.get("better") not in ("lower", "higher"):
            faults.append(f"{m.get('name')}: better must be lower/higher")
        for w in m.get("workloads", []):
            if w not in cells:
                faults.append(f"{m['name']}: unknown workload {w!r}")
    for m in bench.get("per_layer", []):
        if m.get("moves") not in e2e_names:
            faults.append(f"{m['name']}: moves unknown {m.get('moves')!r}")
        for w in m.get("workloads", []):
            reported = {e["name"] for e in bench.get("end_to_end", [])
                        if _applies(e, w)}
            if m.get("moves") not in reported:
                faults.append(f"{m['name']}: cell {w} does not report "
                              f"its moves {m.get('moves')!r}")
    for w in bench.get("workloads", []):
        for key in ("config", "traffic"):
            if not NAME_RE.match(w.get(key, "")):
                faults.append(f"{w['name']}: bad {key}")
        e2e, per = cell_metrics(bench, w["name"])
        e2e_names_w = {m["name"] for m in e2e}
        if "setup_s" not in e2e_names_w or len(e2e_names_w) < 2:
            faults.append(f"{w['name']}: needs setup_s and another "
                          "end-to-end metric")
        if not per:
            faults.append(f"{w['name']}: no per-layer metric")
        if len(w.get("why", "")) > 200 or "\n" in w.get("why", ""):
            faults.append(f"{w['name']}: why too long")
    for c in bench.get("configs", []):
        for key in c.get("reduced", []):
            if not NAME_RE.match(key):
                faults.append(f"{c['name']}: bad reduced key {key!r}")
        if not os.path.isfile(os.path.join(root, c.get("file", ""))):
            faults.append(f"{c['name']}: missing file {c.get('file')}")
    return faults
