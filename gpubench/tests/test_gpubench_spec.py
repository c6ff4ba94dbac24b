"""BENCHMARK.json against the contract's static limits, every name
resolving to its files, and a new cell, configuration, traffic mix and
metric added with new files only."""

import json
import os
import shutil

import pytest

from gpubench import spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_passes_static_checks():
    assert spec.validate(BENCH) == []
    assert BENCH["command"] == ["python3", "-m", "gpubench"]
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves(workload):
    cell = spec.resolve(workload)
    assert cell.chips == 1
    spec.load_module("reference", cell.config_name)
    readers = spec.metric_readers(cell)
    assert readers and all(hasattr(m, "read") for m in readers.values())
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    for m in cell.per_layer:
        assert m["moves"] in names
    driver = spec.load_module("drivers", cell.traffic["driver"])
    numbers = (("embed_gap",) if cell.traffic["driver"] == "embed"
               else driver.NUMBERS)
    assert cell.limits and set(cell.limits) <= set(numbers)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_module_declares_its_entry(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    mod = spec.load_module("metrics", metric)
    assert (mod.LAYER, mod.UNIT, mod.BETTER, mod.MOVES) == (
        entry["layer"], entry["unit"], entry["better"], entry["moves"])


@pytest.mark.parametrize("bad", ["a b", "a,b", "a/b", "é", "", "x" * 65,
                                 "-lead"])
def test_names_reject_disallowed_characters(bad):
    assert not spec.NAME_RE.match(bad)


@pytest.mark.parametrize("good", ["embed.slowfast_r50.fresh", "mfu.embed",
                                  "r3d18", "_x-1.2"])
def test_names_accept_allowed_characters(good):
    assert spec.NAME_RE.match(good)


@pytest.mark.parametrize("unit,ok", [("segments/s", True), ("%", True),
                                     ("GiB", True), ("tokens per s", False),
                                     ("us", True), ("µs", False)])
def test_units(unit, ok):
    assert bool(spec.UNIT_RE.match(unit)) == ok


def test_validate_finds_a_per_layer_metric_whose_cell_lacks_its_moves():
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"][0]["workloads"] = ["train.r3d18.default"]
    assert any("moves" in f for f in spec.validate(bench))


def test_new_cell_config_traffic_and_metric_from_new_files(tmp_path):
    root = tmp_path
    shutil.copytree(spec.PKG, root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((root / "gpubench/configs/r3d18.json").read_text())
    cfg["name"] = "r3d34"
    cfg["layers"] = [3, 4, 6, 3]
    (root / "gpubench/configs/r3d34.json").write_text(json.dumps(cfg))
    (root / "gpubench/reference/r3d34.py").write_text(
        "from .r3d18 import INPUT_KIND, build  # noqa: F401\n")
    traffic = json.loads(
        (root / "gpubench/traffic/embed_fresh.json").read_text())
    traffic["batch_size"] = 64
    (root / "gpubench/traffic/embed_small_batch.json").write_text(
        json.dumps(traffic))
    (root / "gpubench/limits/embed.r3d34.small_batch.json").write_text(
        json.dumps({"embed_gap": 0.05}))
    (root / "gpubench/metrics/videos_per_window.embed.py").write_text(
        "LAYER = 'tables'\nUNIT = 'videos'\nBETTER = 'higher'\n"
        "MOVES = 'embed_segments_per_s'\n\n\ndef read(ctx):\n"
        "    return ctx.work.get('videos')\n")
    bench["configs"].append({"name": "r3d34", "source": "paper",
                             "file": "gpubench/configs/r3d34.json",
                             "reduced": [], "why": "deeper"})
    bench["workloads"].append({"name": "embed.r3d34.small_batch",
                               "config": "r3d34",
                               "traffic": "embed_small_batch", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "embed_segments_per_s":
            m["workloads"].append("embed.r3d34.small_batch")
    bench["per_layer"].append({"name": "videos_per_window.embed",
                               "unit": "videos", "better": "higher",
                               "source": "program_counter",
                               "layer": "tables",
                               "moves": "embed_segments_per_s",
                               "workloads": ["embed.r3d34.small_batch"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert spec.validate(bench, str(root)) == []
    cell = spec.resolve("embed.r3d34.small_batch", str(root))
    assert cell.config["layers"] == [3, 4, 6, 3]
    assert cell.traffic["batch_size"] == 64
    readers = spec.metric_readers(cell, str(root))
    assert "videos_per_window.embed" in readers
    mod = spec.load_module("reference", "r3d34", str(root))
    assert mod.INPUT_KIND == "clip"
    # nothing under the original tree changed
    assert not os.path.exists(os.path.join(spec.PKG, "traffic",
                                           "embed_small_batch.json"))
