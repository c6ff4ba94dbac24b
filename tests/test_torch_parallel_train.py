"""The port's DP+TP train step (avtex_torch/parallel/sharded.py::
make_sharded_train_step) on the CPU, in a gloo world of 4 processes
(tests/torch_dist_worker.py) and at world size 1 in this process.

The network is avtex's own invariance test's (tests/test_parallel.py:
resnet10 with ``model_type=2``, so the full-width VGGish's Conv_4 /
Conv_5 split over the model axis), fp32, at 16 px, its audio examples
cut from 100 x 64 to 32 x 32 log-mel bins (VGGish's cost, not its
channels, falls with the patch): a global batch of 4 queries with 1
negative, two steps at LR 0.05 with momentum and weight
decay, from avtex's drawn parameters. At meshes (4, 1), (2, 2) and
(1, 4), with augmentation: every step's loss within 5e-4 of the
others' and of the port's unsharded ``make_train_step``, and the fp32
master parameters after two steps within a relative L2 error of 1e-4 of
the unsharded step's (all parameters together). Without augmentation, at
(2, 2), the losses are within 1e-4 of avtex's
``make_train_step(augment=False)``.
A batch that the data size does not divide raises; at world size 1 the
sharded step is the unsharded step bit for bit.
"""

import jax
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state

from avtex.config import Config as JaxConfig
from avtex.contrastive.model import ContrastiveTextures as JaxCT
from avtex.train import loop as jax_loop
from avtex_torch.config import Config
from avtex_torch.data.pipeline import SegmentBatches
from avtex_torch.train import create_state, make_train_step
from avtex_torch.train.loop import step_generator

from test_torch_parallel import _params_for, _port_kw
from torch_dist_worker import _model, run_world

torch.set_num_threads(1)

M2 = dict(arch="resnet10", model_type=2)
CFG = dict(enc_arch="resnet10", model_type=2, img_size=16, window=4,
           stride=2, train_stride=2, n_negs=1, batch_size=4, lr=0.05,
           lr_steps=30, momentum=0.9, weight_decay=1e-3, seed=0)
LOSS_TOL, AVTEX_TOL, PARAM_TOL = 5e-4, 1e-4, 1e-4
SHAPES = [(4, 1), (2, 2), (1, 4)]


def _batches():
    g = np.random.default_rng(4)
    video = (g.random((24, 16, 16, 3)) * 255).astype(np.uint8)
    audio = g.standard_normal((12, 32, 32)).astype(np.float32)
    data = SegmentBatches(video, 4, 2, n_negs=1, batch_size=4,
                          audio_examples=audio, seed=0, drop_last=True)
    batches = list(data.epoch(0))[:2]
    assert len(batches) == 2
    return batches, video, audio


@pytest.fixture(scope="module")
def setup():
    batches, video, audio = _batches()
    tree, sd = _params_for(M2, video[None, :4], 16, audio)
    return batches, tree, sd


def _port_run(sd, batches):
    model = _model(_port_kw(M2), sd).train()
    cfg = Config(**CFG, compute_dtype="float32")
    state = create_state(model, cfg, 2,
                         {k: torch.from_numpy(v) for k, v in sd.items()})
    step = make_train_step(model, 16, False)
    losses = []
    for i, batch in enumerate(batches):
        state, m = step(state, batch, step_generator(cfg.seed, i))
        losses.append(float(m["loss"]))
    return losses, {k: v.detach().numpy() for k, v in state.params.items()}


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """The unsharded port's run, then one world of 4 running every mesh
    shape with augmentation, (2, 2) without, and a bad batch."""
    batches, _, sd = setup
    common = dict(model_kw=_port_kw(M2), params=sd,
                  cfg_kw=dict(CFG, compute_dtype="float32"), batches=batches)
    jobs = {shape: ("train", dict(common, shape=shape, augment=True))
            for shape in SHAPES}
    jobs["noaug"] = ("train", dict(common, shape=(2, 2), augment=False))
    jobs["bad batch"] = ("train_bad_batch", dict(
        shape=(4, 1), model_kw=_port_kw(M2), params=sd,
        cfg_kw=common["cfg_kw"],
        batch={k: v[:3] for k, v in batches[0].items()}))
    out = dict(zip(jobs, run_world(tmp_path_factory.mktemp("train"), 4,
                                   list(jobs.values()))))
    out["plain"] = _port_run(sd, batches)
    return out


@pytest.fixture(scope="module")
def avtex_losses(setup):
    """avtex's make_train_step(augment=False) from the same parameters."""
    batches, tree, _ = setup
    cfg = JaxConfig(**CFG)
    model = JaxCT(**M2, dtype=jax.numpy.float32)
    tx = optax.chain(optax.add_decayed_weights(cfg.weight_decay),
                     optax.sgd(jax_loop.make_lr_schedule(cfg, 2),
                               momentum=cfg.momentum))
    state = train_state.TrainState.create(apply_fn=model.apply,
                                          params=tree, tx=tx)
    step = jax_loop.make_train_step(model, 16, False, augment=False)
    losses = []
    for i, batch in enumerate(batches):
        state, m = step(state, batch, jax.random.key(i))
        losses.append(float(m["loss"]))
    return losses


def _rel_l2(got, want):
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    den = sum(float((want[k] ** 2).sum()) for k in want)
    return np.sqrt(num / den)


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_step_matches_the_unsharded_step(setup, runs, shape):
    plain_losses, plain_params = runs["plain"]
    # the steps moved the parameters far more than the tolerance
    assert _rel_l2(plain_params, setup[2]) > 10 * PARAM_TOL
    ranks = runs[shape]
    assert len(ranks) == 4
    for r in ranks:
        np.testing.assert_allclose(r["loss"], plain_losses, rtol=0,
                                   atol=LOSS_TOL)
        assert r["loss"] == ranks[0]["loss"]  # every rank reports the mean
        assert set(r["params"]) == set(plain_params)
        assert _rel_l2(r["params"], plain_params) <= PARAM_TOL


def test_mesh_shapes_agree_with_each_other(runs):
    losses = np.array([runs[shape][0]["loss"] for shape in SHAPES])
    assert np.ptp(losses, axis=0).max() <= LOSS_TOL


def test_losses_without_augmentation_match_avtex(runs, avtex_losses):
    for r in runs["noaug"]:
        np.testing.assert_allclose(r["loss"], avtex_losses, rtol=0,
                                   atol=AVTEX_TOL)


def test_a_batch_the_data_size_does_not_divide_raises(runs):
    assert runs["bad batch"] == ["batch of 3 does not split over 4 data "
                                 "ranks"] * 4


def test_world_of_one_is_the_unsharded_step(setup):
    from avtex_torch.parallel import (make_mesh, make_sharded_train_step,
                                      shutdown)
    batches, _, sd = setup
    cfg = Config(**CFG, compute_dtype="float32")
    kw = dict(_port_kw(M2), model_type=1)
    sd = {k: v for k, v in sd.items() if not k.startswith("audio_encoder")}
    full = {k: torch.from_numpy(v) for k, v in sd.items()}
    got = []
    mesh = make_mesh(device="cpu")
    try:
        for sharded in (False, True):
            model = _model(kw, sd).train()
            step = (make_sharded_train_step(model, mesh, 16, False)
                    if sharded else make_train_step(model, 16, False))
            state = create_state(model, cfg, 2, full)
            batch = {k: v for k, v in batches[0].items()
                     if k not in ("q_audio", "t_audio")}
            state, m = step(state, batch, step_generator(0, 0))
            got.append((float(m["loss"]), state.params))
    finally:
        shutdown()
    assert got[0][0] == got[1][0]
    for name, p in got[0][1].items():
        assert torch.equal(p, got[1][1][name]), name
