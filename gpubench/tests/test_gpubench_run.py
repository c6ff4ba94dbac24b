"""Whole runs through the harness on the CPU at a tiny size (the look for
a chip skipped): the result's shape, and ``correct`` false with the
timed path broken underneath, once for each fault a cell can have."""

import json
import math

import pytest
import torch

from gpubench import run

EMBED = {"config": {"width": 8, "img_size": 32},
         "traffic": {"video": {"seconds": 3, "fps": 30, "size": 32,
                               "pool": 2},
                     "batch_size": 8, "check_rows": 6}}
# fp32: at width 8 and 32 px the bf16 rows and gradients are ill-posed
# (one voxel left in the last stage), so the sound run is checked in fp32
EMBED_FP32 = {"config": dict(EMBED["config"], compute_dtype="float32"),
              "traffic": EMBED["traffic"]}
TRAIN = {"config": {"width": 8, "img_size": 32, "compute_dtype": "float32",
                    "encoder_kwargs": {}},
         "traffic": {"video": {"seconds": 3, "fps": 30, "size": 32,
                               "pool": 1},
                     "batch_size": 2, "n_negs": 2, "check_steps": 1,
                     "reference_rows_per_chunk": 1}}
SEED = 2 ** 31 + 11


def _shape_ok(result, trace):
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(
        result)
    assert result["attempted"] >= 1 and result["failed"] == 0
    for m in result["metrics"].values():
        assert math.isfinite(m["value"]) and m["unit"]
    if trace:
        assert "busy_s" in result["device"] and "window_s" in result["device"]
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(result)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", ["embed.slowfast_r50.fresh",
                                      "embed.r3d18.fresh"])
def test_embed_run_end_to_end(workload, trace):
    r = run.run_cell(workload, SEED, 0.5, bool(trace), device="cpu",
                     overrides=EMBED_FP32)
    _shape_ok(r, trace)
    assert r["correct"], r["checks"]
    if not trace:
        assert set(r["metrics"]) == {"embed_segments_per_s", "setup_s"}


@pytest.mark.parametrize("trace", [0, 1])
def test_train_run_end_to_end(trace):
    # oneDNN's CPU backward depends on the batch's rows, which the
    # reference splits into chunks: off, as in the port's parity tests
    with torch.backends.mkldnn.flags(enabled=False):
        r = run.run_cell("train.r3d18.default", SEED, 0.5, bool(trace),
                         device="cpu", overrides=TRAIN)
    _shape_ok(r, trace)
    assert r["correct"], r["checks"]
    if trace:
        assert "batch_wait_ms.train" in r["metrics"]
    else:
        # peak_gib is read from the card only
        assert set(r["metrics"]) == {"train_clips_per_s", "setup_s"}


def test_embed_with_an_altered_answer_is_not_correct():
    r = run.run_cell("embed.slowfast_r50.fresh", SEED, 0.2, False,
                     device="cpu", fault="answer_altered", overrides=EMBED)
    assert not r["correct"]
    assert r["checks"]["embed_gap"]["value"] > 0.3


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "control"])
def test_train_with_a_fault_is_not_correct(fault):
    r = run.run_cell("train.r3d18.default", SEED, 0.2, False, device="cpu",
                     fault=fault, overrides=TRAIN)
    assert not r["correct"], r["checks"]


def test_embed_with_the_fp8_control_in_place_is_not_correct():
    r = run.run_cell("embed.slowfast_r50.fresh", SEED, 0.2, False,
                     device="cpu", fault="control", overrides=EMBED_FP32)
    assert not r["correct"], r["checks"]


def test_a_failed_limit_fails_the_run(monkeypatch):
    from gpubench import spec
    resolve = spec.resolve

    def strict(*args, **kwargs):
        cell = resolve(*args, **kwargs)
        cell.limits["embed_gap"] = 0.0
        return cell

    monkeypatch.setattr(spec, "resolve", strict)
    r = run.run_cell("embed.r3d18.fresh", SEED, 0.2, False, device="cpu",
                     overrides=EMBED_FP32)
    assert not r["correct"]
