"""The plain reference against the port on the CPU at width 8 and 32 px
(and at width 64 where bf16 is compared), and the fp8 control reading
well above the program."""

import json
import os

import numpy as np
import pytest
import torch

from gpubench import inputs, spec
from gpubench.reference import common
from gpubench.reference import towers as ref_towers

SIZE = 32


def _cell(workload, **config):
    cell = spec.resolve(workload)
    cell.config.update(img_size=SIZE, **config)
    return cell


def _port_model(cell, norm, dtype, weights, remat=False):
    from avtex_torch.contrastive.model import ContrastiveTextures
    from gpubench.harness import encoder_kwargs
    model = ContrastiveTextures(arch=cell.config["arch"], dtype=dtype,
                                norm=norm, remat=remat,
                                **encoder_kwargs(cell.config))
    model.load_state_dict(weights)
    return model


def _towers(cell, norm, weights=None, seed=3, served=False):
    module = spec.load_module("reference", cell.config_name)
    towers = ref_towers.Towers(module, cell.config, norm)
    if weights is None:
        weights = inputs.seeded_weights(ref_towers.param_shapes(towers), seed,
                                        served=served)
    return ref_towers.load(towers, weights), weights


def _embed_gap(workload, width, dtype, precision="fp32"):
    from avtex_torch.synth.embeddings import precompute_embeddings_from_video
    cell = _cell(workload, width=width)
    norm = cell.config["norm"]["embed"]
    towers, weights = _towers(cell, norm, served=True)
    model = _port_model(cell, norm, dtype, weights).eval()
    video = inputs.synthetic_video(3, 0, 2, 30, SIZE)
    L = (len(video) - 15) // 6
    q, t = precompute_embeddings_from_video(model, video, 15, 6, L,
                                            img_size=SIZE, batch_size=8)
    starts = list(np.arange(L) * 6)
    prog = {"query": q, "target": t}
    if precision != "fp32":
        prog = ref_towers.table_rows(towers, video, starts, 15, SIZE,
                                     precision, "cpu")
    ref = ref_towers.table_rows(towers, video, starts, 15, SIZE, "fp32",
                                "cpu")
    return max(float(torch.linalg.vector_norm(prog[k] - ref[k], dim=-1).max())
               for k in ref)


@pytest.mark.parametrize("workload", ["embed.slowfast_r50.fresh",
                                      "embed.r3d18.fresh"])
def test_reference_rows_agree_with_the_port_in_fp32(workload):
    assert _embed_gap(workload, 8, torch.float32) < 1e-3


@pytest.mark.parametrize("workload", ["embed.slowfast_r50.fresh",
                                      "embed.r3d18.fresh"])
def test_fp8_control_reads_far_above_the_bf16_port(workload):
    program = _embed_gap(workload, 64, torch.bfloat16)
    control = _embed_gap(workload, 64, torch.bfloat16, precision="fp8")
    assert control > 3 * program


@pytest.mark.parametrize("config", ["r3d18", "slowfast_r50_8x8"])
def test_reference_training_step_agrees_with_the_port_in_fp32(config):
    """One step of the port's trainer (fp32, oneDNN off) against the
    reference's, under the training cell's traffic: loss, every leaf's
    gradient and change. SlowFast-R50 has no training cell yet; its
    reference is held to the port all the same."""
    from avtex_torch.config import Config
    from avtex_torch.data.pipeline import SegmentBatches
    from avtex_torch.train.loop import (create_state, make_train_step,
                                        step_generator)
    cell = _cell("train.r3d18.default")
    with open(os.path.join(spec.PKG, "configs", config + ".json")) as f:
        cell.config = dict(json.load(f), width=8, img_size=SIZE)
    cell.config_name = config
    # the plain stems: the s2d form rounds its sums in another order, which
    # moves near-ties of the stems' max pool and so a few gradients by a
    # few percent at this size (the check at the cell's size runs the s2d
    # form, as the program does)
    if cell.config["family"] == "slowfast":
        cell.config["encoder_kwargs"] = {"s2d_stem": False}
    traffic = dict(cell.traffic, batch_size=2, n_negs=2,
                   reference_rows_per_chunk=1)
    towers, weights = _towers(cell, "group")
    video = inputs.synthetic_video(5, 0, 3, 30, SIZE)
    model = _port_model(cell, "group", torch.float32, weights, remat=True)
    cfg = Config(img_size=SIZE, batch_size=2, n_negs=2, seed=5,
                 compute_dtype="float32").derive_geometry(30)
    data = SegmentBatches(video, 15, 6, n_negs=2, batch_size=2, seed=5)
    data.drop_last = True
    state = create_state(model, cfg, len(data), params=weights)
    step = make_train_step(model, SIZE, cell.config["arch"] == "slowfast")
    model.train()
    with torch.backends.mkldnn.flags(enabled=False):
        state, metrics = step(state, next(data.epoch(0)),
                              step_generator(5, 0))
        ref = ref_towers.train_steps(towers, video, traffic, 5, 1, "fp32",
                                     "cpu", list(state.params), len(data))
    assert float(metrics["loss"]) == pytest.approx(ref["losses"][0],
                                                   rel=1e-5)
    change = common.leaf_norms({n: p - weights[n]
                                for n, p in state.params.items()})
    med = common.median(ref["change_norms"].values())
    for name, r in ref["change_norms"].items():
        assert abs(change[name] - r) <= 1e-3 * max(r, med), name
