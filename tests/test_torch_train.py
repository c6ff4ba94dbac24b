"""The port's training loop (avtex_torch/train/loop.py) against avtex's
(avtex/train/loop.py), and its checkpoint files against avtex's.

Step parity runs fp32 on both sides: avtex's ``create_state`` and
``make_train_step`` with ``ContrastiveTextures(dtype=float32)`` (avtex's
``train_video`` hard-codes bf16), the port's ``create_state`` from avtex's
initial parameters through ``convert_params``. Three steps without
augmentation, on a 22-frame clip at 32 px whose 8 train queries make two
batches of 4 an epoch, with ``lr_steps=1``: the LR falls 10x at the third
step, which is also the first of epoch 1; weight decay 1e-3, momentum
0.9. Losses agree within 1e-5, parameters and momentum traces within rtol
1e-4 / atol 1e-5 (the frameworks sum convolutions in other orders), for
``resnet10``, a width-16 SlowFast and ``model_type=2`` (resnet10 + the
full-width VGGish).

The SlowFast case (``CASES["slowfast"]``) is conditioned so that fp32
can answer it, and held to a stated momentum tolerance:
- Width 16, not the width 8 of tests/test_torch_slowfast.py: at width 8
  the fast pathway is one channel wide and its GroupNorm'd gradients
  come out of heavy cancellation.
- LR 1e-4, not 0.05: at avtex's initialisation one step at 0.05
  overshoots (gradient norm near 40, high curvature), and rounding
  differences grow about a hundredfold a step: a third-step loss then
  differs by 5e-4 between the two frameworks.
- avtex runs with flax's two-pass GroupNorm variance
  (``use_fast_variance=False``). flax's default E[x^2] - E[x]^2 in fp32
  cancels on one clip of this batch and moves avtex's gradient there by
  3.5% from an fp64 evaluation, where the port stays within 1e-5
  (``tests/test_torch_train_video.py::
  test_flax_fast_variance_moves_avtex_gradients``).
- The momentum traces are held to a relative L2 error of 1e-2 per
  tensor (``SF_MOMENTUM_TOL``; 3.3e-3 measured), not rtol 1e-4: clip by
  clip, both frameworks' fp32 gradients of this network lie up to 2e-3
  of each tensor's largest element from an fp64 evaluation (the port up
  to 5.4e-4, avtex up to 2.0e-3), and three steps of momentum carry
  that. Losses and parameters keep the tolerances above.
- The SlowFast tests run with torch's oneDNN CPU backend off: with it
  on, the SlowFast's parameter gradients at a batch of 20 clips part
  from the sum of the same clips' gradients in batches of 4 by up to 17%
  (5e-7 with it off). A 3D conv, GroupNorm, max-pool or ReLU
  backward alone is consistent, so the op at fault is not isolated. The
  flag does not touch CUDA.

Also: checkpointed blocks give the same gradients (1e-6) under both
``REMAT_POLICY`` settings, the step's preprocessing in chunks gives one
chunk's inputs bit for bit, the bf16 model steps an fp32 master copy,
``train_video`` at avtex's default ``-bs 32 -negs 20`` builds batches of
32 + 32 x 21 clips, and avtex's files resume in the port and the
port's in avtex. ``train_video``'s resume, early stop, start epoch,
best/latest files and errors, and the SlowFast case's GroupNorm variance
check, are in tests/test_torch_train_video.py (one file each keeps the
``--dist loadfile`` workers' shares short).
"""

import functools
import os

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from avtex.config import Config as JaxConfig
from avtex.contrastive.model import ContrastiveTextures as JaxCT
from avtex.data.pipeline import SegmentBatches as JaxBatches
from avtex.nn import encoders as jax_encoders
from avtex.nn.slowfast import SlowFastR50 as JaxSF
from avtex.train import checkpoint as jax_ckpt
from avtex.train import loop as jax_loop
from avtex_torch.config import Config
from avtex_torch.contrastive.model import ContrastiveTextures
from avtex_torch.convert import convert_opt_state, convert_params
from avtex_torch.data.pipeline import SegmentBatches
from avtex_torch.data.preprocess import preprocess_clip
from avtex_torch.nn.slowfast import slowfast_pathways
from avtex_torch.train import (create_state, make_lr_schedule,
                               make_train_step, restore_checkpoint,
                               save_checkpoint, train_video)
from avtex_torch.train.loop import step_generator

torch.set_num_threads(1)


SMALL_SF = dict(width=16, layers=(1, 1, 1, 1))
BASE = dict(model_type=1, img_size=32, window=4, stride=2, train_stride=2,
            n_negs=4, batch_size=4, lr=0.05, lr_steps=1, momentum=0.9,
            weight_decay=1e-3, seed=0, augment=False, early_stop_loss=1e-9)
CASES = {"resnet10": dict(BASE, enc_arch="resnet10"),
         "slowfast": dict(BASE, enc_arch="slowfast", lr=1e-4),
         "m2": dict(BASE, enc_arch="resnet10", model_type=2)}
N_STEPS = 3
LOSS_TOL, RTOL, ATOL = 1e-5, 1e-4, 1e-5
SF_MOMENTUM_TOL = 1e-2  # relative L2 error per tensor (docstring)
# avtex runs these with flax's two-pass GroupNorm variance (docstring)
TWO_PASS_VARIANCE = {"slowfast"}


def _avtex_patches(mp, two_pass_variance):
    """The narrow SlowFast in avtex's registry; no VGGish file found;
    optionally flax's two-pass GroupNorm variance."""
    mp.setitem(jax_encoders.ENCODER_REGISTRY, "slowfast",
               (functools.partial(JaxSF, **SMALL_SF), "slowfast"))
    mp.delenv("AVTEX_VGGISH_CKPT", raising=False)
    if two_pass_variance:
        mp.setattr(flax_nn, "GroupNorm", functools.partial(
            flax_nn.GroupNorm, use_fast_variance=False))


def _video(t=22, h=24, w=24):
    yy, xx = np.mgrid[0:h, 0:w]
    vid = np.stack([np.sin(xx / 3 + i / 2) * 100 + 127 + yy
                    for i in range(t)])
    return np.clip(vid[..., None].repeat(3, -1), 0, 255).astype(np.uint8)


def _audio(n=12):
    return (np.random.default_rng(5).standard_normal((n, 100, 64))
            .astype(np.float32))


def _np_tree(tree):
    return jax.tree.map(np.asarray, serialization.to_state_dict(tree))


def _batches(batches_cls, kw, audio):
    data = batches_cls(_video(), kw["window"], kw["train_stride"],
                       n_negs=kw["n_negs"], batch_size=kw["batch_size"],
                       audio_examples=audio, seed=kw["seed"],
                       drop_last=True)
    assert len(data) == 2
    return list(data.epoch(0)) + list(data.epoch(1))[:N_STEPS - 2]


_AVTEX = {}


def _avtex_run(case):
    """avtex's fp32 run of a case: initial params, the TrainState after
    each step, the losses, and its step function (cached per case)."""
    if case in _AVTEX:
        return _AVTEX[case]
    kw = CASES[case]
    cfg = JaxConfig(**kw)
    slowfast = cfg.enc_arch == "slowfast"
    audio = _audio() if cfg.model_type == 2 else None
    with pytest.MonkeyPatch.context() as mp:
        _avtex_patches(mp, case in TWO_PASS_VARIANCE)
        model = JaxCT(arch=cfg.enc_arch, model_type=cfg.model_type,
                      temp=cfg.temp, dtype=jnp.float32)
        batches = _batches(JaxBatches, kw, audio)
        state = jax_loop.create_state(model, cfg, batches[0], 2, slowfast)
        step = jax_loop.make_train_step(model, cfg.img_size, slowfast,
                                        augment=False)
        states, losses = [state], []
        for i, batch in enumerate(batches):
            state, metrics = step(state, batch, jax.random.key(i))
            states.append(state)
            losses.append(float(metrics["loss"]))
    _AVTEX[case] = (_np_tree(states[0].params), states, losses, step)
    return _AVTEX[case]


def _port_model(case, remat=True, dtype=torch.float32):
    kw = CASES[case]
    enc_kw = SMALL_SF if kw["enc_arch"] == "slowfast" else {}
    return ContrastiveTextures(kw["enc_arch"], kw["model_type"], 0.1,
                               dtype=dtype, remat=remat, **enc_kw)


def _port_setup(case, params_tree):
    kw = CASES[case]
    cfg = Config(**kw, compute_dtype="float32")
    model = _port_model(case)
    state = create_state(model, cfg, 2, convert_params(params_tree, model))
    step = make_train_step(model, cfg.img_size, kw["enc_arch"] == "slowfast",
                           augment=False)
    audio = _audio() if kw["model_type"] == 2 else None
    return state, step, _batches(SegmentBatches, kw, audio)


def _assert_state_matches(port_state, jax_state, momentum_tol=None):
    """Parameters within RTOL/ATOL; momentum traces within RTOL/ATOL, or
    within a relative L2 error of ``momentum_tol`` per tensor."""
    model = port_state.model
    want = convert_params(_np_tree(jax_state.params), model)
    mom, count = convert_opt_state(_np_tree(jax_state.opt_state), model)
    assert port_state.step == int(jax_state.step) == count
    got_mom = port_state.momentum()
    for name, m in port_state.params.items():
        np.testing.assert_allclose(m.detach().numpy(), want[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
        if momentum_tol is None:
            np.testing.assert_allclose(got_mom[name].numpy(),
                                       mom[name].numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=name)
        else:
            err = float(torch.linalg.vector_norm(got_mom[name] - mom[name])
                        / torch.linalg.vector_norm(mom[name]))
            assert err <= momentum_tol, (name, err)


@pytest.mark.parametrize("case", list(CASES))
def test_three_sgd_steps_match_avtex(case, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)  # no pretrained/ VGGish file is found
    init, jax_states, jax_losses, _ = _avtex_run(case)
    state, step, batches = _port_setup(case, init)
    lrs = []
    with torch.backends.mkldnn.flags(enabled=case != "slowfast"):
        for i, batch in enumerate(batches):
            lrs.append(state.schedule(state.step))
            state, metrics = step(state, batch, torch.Generator())
            assert abs(float(metrics["loss"]) - jax_losses[i]) <= LOSS_TOL, i
    lr = CASES[case]["lr"]
    assert lrs == pytest.approx([lr, lr, lr / 10])
    _assert_state_matches(state, jax_states[-1],
                          SF_MOMENTUM_TOL if case == "slowfast" else None)


def test_lr_schedule_matches_avtex():
    for spe, lr_steps in ((10, 3), (2, 1), (7, 0)):
        cfg = Config(lr=0.1, lr_steps=lr_steps)
        want = jax_loop.make_lr_schedule(JaxConfig(lr=0.1, lr_steps=lr_steps),
                                         spe)
        got = make_lr_schedule(cfg, spe)
        for k in (0, 1, spe * 3 - 1, spe * 3, spe * 6 + 1, spe * 7):
            assert got(k) == pytest.approx(float(want(k)), rel=1e-6), k


@pytest.mark.parametrize("case, policy", [
    pytest.param("resnet10", None, id="resnet10"),
    pytest.param("slowfast", None, id="slowfast"),
    pytest.param("resnet10", "conv_out", id="resnet10-conv_out"),
    pytest.param("slowfast", "conv_out", id="slowfast-conv_out")])
def test_checkpointed_blocks_give_the_same_gradients(case, policy,
                                                     monkeypatch):
    """remat (every block checkpointed, keeping what ``REMAT_POLICY``
    says) against remat off."""
    from avtex_torch.nn import resnet3d
    monkeypatch.setattr(resnet3d, "REMAT_POLICY", policy)
    model = _port_model(case, remat=False)
    kw = CASES[case]
    cfg = Config(**kw, compute_dtype="float32")
    state = create_state(model, cfg, 2)
    batch = _batches(SegmentBatches, kw, None)[0]
    grads = {}
    for remat in (False, True):
        for emb in (model.q_embedder, model.t_embedder):
            emb.video_encoder.remat = remat
        captured = {}
        real = state.apply_gradients

        def capture(grad_hook=None):
            captured.update({n: p.grad.clone()
                             for n, p in model.named_parameters()})
        state.apply_gradients = capture
        step = make_train_step(model, 32, kw["enc_arch"] == "slowfast", False)
        step(state, batch, torch.Generator())
        state.apply_gradients = real
        for p in model.parameters():
            p.grad = None
        grads[remat] = captured
    for name, g in grads[False].items():
        np.testing.assert_allclose(grads[True][name].numpy(), g.numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("slowfast", [False, True])
def test_chunked_preprocessing_matches_one_chunk(slowfast, augment,
                                                 monkeypatch):
    """``_prep_pathways`` in chunks of two clips (three chunks of five
    clips, the last short) gives one chunk's bf16 inputs bit for bit,
    under the same augmentation draws."""
    from avtex_torch.train import loop
    size, n = 16, 5
    vid = torch.from_numpy(_video(t=16, h=24, w=20))
    frames = torch.stack([vid[i:i + 8] for i in range(n)])
    draws = (loop._draws(n, slice(0, n), frames, size,
                         torch.Generator().manual_seed(3))
             if augment else None)
    one = loop._prep_pathways(frames, draws, size, slowfast, torch.bfloat16)
    monkeypatch.setattr(loop, "PREP_CHUNK_ELEMENTS", 2 * 8 * size * size * 3)
    several = loop._prep_pathways(frames, draws, size, slowfast,
                                  torch.bfloat16)
    if not slowfast:
        one, several = (one,), (several,)
    assert len(one) == len(several) == (2 if slowfast else 1)
    for a, b in zip(one, several):
        assert a.dtype == torch.bfloat16 and a.shape[0] == n
        assert torch.equal(a, b)


def test_an_encoder_without_remat_warns_and_trains_without(monkeypatch,
                                                          capsys):
    from avtex_torch.nn import encoders, resnet3d
    monkeypatch.setitem(encoders.ENCODER_REGISTRY, "resnet10", (
        lambda dtype, norm, **kw: resnet3d.resnet3d10(dtype=dtype, norm=norm,
                                                      **kw), "clip"))
    enc, _, _ = encoders.build_encoder("resnet10", remat=True)
    assert not enc.remat
    assert "does not support remat" in capsys.readouterr().err


def test_a_step_after_an_inference_mode_embed():
    """A server embeds under inference_mode; a training step in the same
    process must not meet the stems' cached index tensors made there."""
    from avtex_torch.ops import s2d_stem
    s2d_stem._scatter_tensors.cache_clear()
    model = _port_model("slowfast")
    kw = CASES["slowfast"]
    state = create_state(model, Config(**kw, compute_dtype="float32"), 2)
    batch = _batches(SegmentBatches, kw, None)[0]
    with torch.inference_mode():
        model.embed(slowfast_pathways(preprocess_clip(
            torch.from_numpy(batch["q_frames"]), 32, True)))
    step = make_train_step(model, 32, True, augment=False)
    state, metrics = step(state, batch, torch.Generator())
    assert torch.isfinite(metrics["loss"]) and state.step == 1


def test_bf16_model_steps_an_fp32_master_copy():
    """Updates below bf16's resolution accumulate in the master copy; the
    model always holds the master rounded to bf16; the checkpoint tree
    holds the master."""
    kw = dict(CASES["resnet10"], lr=1e-5, weight_decay=0.0, momentum=0.0)
    model = _port_model("resnet10", dtype=torch.bfloat16)
    state = create_state(model, Config(**kw), 2)
    w0 = state.params["q_embedder.video_encoder.Conv_0.weight"].clone()
    assert model.q_embedder.video_encoder.Conv_0.weight.dtype == \
        torch.bfloat16 and w0.dtype == torch.float32
    step = make_train_step(model, 32, False, augment=False)
    for batch in _batches(SegmentBatches, kw, None):
        state, _ = step(state, batch, torch.Generator())
    w = state.params["q_embedder.video_encoder.Conv_0.weight"]
    assert not torch.equal(w, w0)
    assert not torch.equal(w, w.bfloat16().float())  # below bf16's grid
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), state.params[name].to(p.dtype)), name
    tree = state.params_tree()["params"]
    np.testing.assert_array_equal(
        tree["q_embedder"]["video_encoder"]["Conv_0"]["kernel"],
        w.numpy().transpose(2, 3, 4, 1, 0))


def _jax_templates(case):
    _, states, _, _ = _avtex_run(case)
    return states[0]


def test_port_resumes_an_avtex_file(tmp_path):
    """avtex saves _latest (with opt_state) after two steps and takes its
    third; the port restores that file and takes the third step too."""
    _, states, losses, _ = _avtex_run("resnet10")
    s2 = states[2]
    path = jax_ckpt.save_checkpoint(
        str(tmp_path), "a", s2.params, 1, "resnet10", losses[1], False,
        opt_state=s2.opt_state, step=int(s2.step))
    assert path.endswith("_latest")
    payload = restore_checkpoint(path)
    state, step, batches = _port_setup("resnet10", payload["state"])
    mom, count = convert_opt_state(payload["opt_state"], state.model)
    assert count == payload["step"] == 2
    state.load_momentum(mom)
    state.step = payload["step"]
    state, metrics = step(state, batches[2], torch.Generator())
    assert abs(float(metrics["loss"]) - losses[2]) <= LOSS_TOL
    _assert_state_matches(state, states[3])


def test_avtex_reads_and_resumes_a_port_file(tmp_path):
    """The port saves after two steps; avtex's restore_checkpoint with
    templates reads the file, and avtex's third step from it matches its
    uninterrupted third step."""
    init, states, losses, jax_step = _avtex_run("resnet10")
    state, step, batches = _port_setup("resnet10", init)
    for batch in batches[:2]:
        state, _ = step(state, batch, torch.Generator())
    save_checkpoint(str(tmp_path), "p", state.params_tree(), 1, "resnet10",
                    0.5, True, opt_state=state.opt_state_tree(),
                    step=state.step)
    assert os.path.exists(tmp_path / "p_best")
    template = _jax_templates("resnet10")
    payload = jax_ckpt.restore_checkpoint(
        str(tmp_path / "p_latest"), template.params, template.opt_state)
    assert payload["step"] == 2 and payload["epoch"] == 1
    assert payload["arch"] == "resnet10"
    restored = template.replace(params=payload["state"],
                                opt_state=payload["opt_state"],
                                step=payload["step"])
    _assert_state_matches(state, restored)
    jax_batch = _batches(JaxBatches, CASES["resnet10"], None)[2]
    after, metrics = jax_step(restored, jax_batch, jax.random.key(2))
    assert abs(float(metrics["loss"]) - losses[2]) <= LOSS_TOL
    state, metrics = step(state, batches[2], torch.Generator())
    _assert_state_matches(state, after)


def test_train_video_at_the_default_batch_shapes(monkeypatch):
    """avtex's default ``-bs 32 -negs 20`` (``Config``'s defaults): every
    step gets 32 query windows and 32 x 21 target windows, 704 clips,
    and trains on all of them. A width-8 ResNet10 on 32 px frames of a
    tiny video; one epoch of two steps. (At 16 px the last stage's
    stride-2 conv gets a one-voxel input, where torch's oneDNN bf16
    conv3d weight gradient on the CPU needs the port's fp32 guard:
    tests/test_torch_conv_guard.py.)"""
    from avtex_torch.train import loop
    cfg = Config(enc_arch="resnet10", img_size=32, window=4, stride=2,
                 train_stride=1, epochs=1, seed=0, early_stop_loss=1e-9)
    assert (cfg.batch_size, cfg.n_negs) == (32, 20)
    shapes, real_step = [], loop.make_train_step

    def counting_step(*args, **kwargs):
        step = real_step(*args, **kwargs)

        def run(state, batch, generator):
            shapes.append((batch["q_frames"].shape, batch["t_frames"].shape))
            return step(state, batch, generator)
        return run
    monkeypatch.setattr(loop, "make_train_step", counting_step)
    monkeypatch.setattr(loop, "ContrastiveTextures", functools.partial(
        ContrastiveTextures, width=8))
    state, hist = train_video(cfg, _video(t=70, h=32, w=32), device="cpu")
    assert shapes == [((32, 4, 32, 32, 3), (32, 21, 4, 32, 32, 3))] * 2
    assert state.step == 2 and np.isfinite(hist).all()


def test_step_generator_replays():
    a = torch.rand(4, generator=step_generator(0, 7))
    assert torch.equal(a, torch.rand(4, generator=step_generator(0, 7)))
    assert not torch.equal(a, torch.rand(4, generator=step_generator(0, 8)))
    assert not torch.equal(a, torch.rand(4, generator=step_generator(1, 7)))
