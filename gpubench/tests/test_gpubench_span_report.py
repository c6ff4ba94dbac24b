"""``python -m gpubench.span_report``'s ``report`` on the CPU at a tiny
size, through the drivers the benchmark runs: one line a seed, with the
program's spans found and divided by its roots."""

import json

import pytest
import torch

from gpubench import span_report
from test_gpubench_run import EMBED_FP32, SEED, TRAIN


def _all_idle(line):
    """No device activity is traced on the CPU: the idle split by
    innermost span covers the whole window."""
    assert line["busy_ms"] == line["children_device_ms"] == 0
    assert sum(line["idle_ms"].values()) * line["roots"] == pytest.approx(
        1e3 * line["window_s"], rel=1e-6)


def test_embed_report_splits_a_video_by_span():
    line = span_report.report("embed.slowfast_r50.fresh", SEED, 0.5,
                              device="cpu", overrides=EMBED_FP32)
    json.dumps(line)
    assert (line["workload"], line["seed"], line["device"]) == (
        "embed.slowfast_r50.fresh", SEED, "cpu")
    assert line["roots"] >= 1
    assert {"embed.video", "embed.upload", "embed.preprocess",
            "embed.towers", "slowfast_stems"} <= set(line["device_ms"])
    _all_idle(line)
    assert line["gathers"] == line["waits"] == 0


def test_train_report_finds_steps_gathers_and_waits():
    with torch.backends.mkldnn.flags(enabled=False):
        line = span_report.report("train.r3d18.default", SEED, 0.5,
                                  device="cpu", overrides=TRAIN)
    json.dumps(line)
    assert line["roots"] >= 1
    _all_idle(line)
    assert {"train.step", "train.upload", "train.draws", "train.augment",
            "train.forward", "train.backward", "train.optimizer",
            "data.wait"} <= set(line["device_ms"])
    assert line["waits"] >= line["roots"]
    assert len(line["queued"]) == line["waits"]
    assert all(q >= 0 for q in line["queued"])
    assert len(line["gather_ms"]) == line["gathers"]
    assert all(len(w) == 4 for w in line["empty_waits"])
