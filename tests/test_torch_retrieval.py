"""The "-daf Contrastive" retrieval head in the port against avtex, on the
same seeded numpy inputs and the same parameters (drawn with numpy for
avtex's tree, carried over by ``avtex_torch.convert``), fp32 on both
sides unless a case says bf16. The video encoder is ResNet10 at width 8
in both registries, on 64 px clips (at 32 px its res5 is one voxel, and
GroupNorm over two-value groups leaves the fp32 forward ill-posed: the
two packages part by 3e-4); VGGish and the 12288 -> 4096 -> 4096 -> 128
AudioMLP are full width.

- ``AudioMLP``, ``embed_audio`` and ``embed_video`` within 1e-5, the
  training forward's logits within 1e-4;
- ``video_for_audio_logits`` rows within 1e-4; in bf16 on both sides
  within 5e-2 of each other and 0.1 of the fp32 rows (logits are cosines
  / 0.1; the two land 0.03 apart, each 0.06 from fp32);
- the ``-daf Contrastive`` scorer from a ``-daf_resume`` file that avtex's
  ``save_checkpoint`` wrote, with and without source audio: rows within
  1e-4, the seed segment (None without source audio) and the host walk's
  indices identical; the module in bf16 whatever ``compute_dtype`` is;
  without a file (or with a missing one) the seeded random head; through
  the server, built once per server;
- ``train_video_for_audio`` for 2 epochs from avtex's own initial
  parameters at LR 1e-6 (the test's docstring says why): the numpy draws
  identical, per-epoch losses within 1e-4 relative, every parameter
  tensor that is nonzero at init within 1e-3 relative L2, the biases that
  start at zero within 5e-2, all parameters together within 1e-5.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import avtex.contrastive.audio_retrieval as jax_ar
import avtex.contrastive.retrieval_train as jax_rt
from avtex.config import Config as JaxConfig
from avtex.contrastive.model import AudioMLP as JaxAudioMLP
from avtex.nn import encoders as jax_encoders
from avtex.nn import resnet3d as jax_resnet3d
from avtex.synth import engine as jax_engine
from avtex.synth import pipeline as jax_pipeline
from avtex_torch.config import Config
from avtex_torch.contrastive.audio_retrieval import (VideoForAudio,
                                                     video_for_audio_logits)
from avtex_torch.contrastive.model import AudioMLP
from avtex_torch.contrastive.retrieval_train import train_video_for_audio
from avtex_torch.convert import convert_params, export_params
from avtex_torch.nn import encoders
from avtex_torch.nn import resnet3d
from avtex_torch.synth import engine, pipeline

torch.set_num_threads(1)

WIDTH, SIZE, W, S = 8, 64, 4, 2


@pytest.fixture(scope="module", autouse=True)
def small_resnet10():
    """ResNet10 at width 8 in both packages' registries."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_encoders.ENCODER_REGISTRY, "resnet10", (
            functools.partial(jax_resnet3d.resnet3d10, width=WIDTH), "clip"))
        mp.setitem(encoders.ENCODER_REGISTRY, "resnet10", (
            functools.partial(resnet3d.resnet3d10, width=WIDTH), "clip"))
        yield


def _video(t, size=SIZE, seed=0):
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    base = np.stack([np.sin(xx / 3 + i / 2) + np.cos(yy / 5 - i / 7)
                     for i in range(t)])[..., None]
    return np.clip(127 + 60 * base + 8 * g.standard_normal(
        (t, size, size, 3)), 0, 255).astype(np.uint8)


def _examples(n, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, 100, 64)).astype(np.float32)


def draw_params(module, *args, seed=0):
    """avtex params as numpy, drawn directly (no init compile)."""
    shapes = jax.eval_shape(module.init, jax.random.key(0), *args)
    g = np.random.default_rng(seed)

    def draw(path, s):
        if path[-1].key == "scale":
            return (1.0 + 0.1 * g.standard_normal(s.shape)).astype(np.float32)
        if path[-1].key == "bias":
            return (0.1 * g.standard_normal(s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (g.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
            np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jit(jmodel, method):
    return jax.jit(functools.partial(jmodel.apply,
                                     method=getattr(jmodel, method)))


def _jax_clips(frames, size=SIZE):
    from avtex.data.preprocess import preprocess_clip
    return preprocess_clip(jnp.asarray(frames), size=size)


def _port_clips(frames, size=SIZE):
    from avtex_torch.data.preprocess import preprocess_clip
    return preprocess_clip(torch.from_numpy(np.asarray(frames)), size=size)


@pytest.fixture(scope="module")
def vfa():
    """avtex's fp32 VideoForAudio with drawn parameters and the port's
    with the same parameters."""
    jmodel = jax_ar.VideoForAudio(arch="resnet10", dtype=jnp.float32)
    x0 = _jax_clips(_video(W)[None])
    jparams = draw_params(jmodel, jnp.zeros((1, 100, 64)), x0[:, None])
    model = VideoForAudio(arch="resnet10", dtype=torch.float32,
                          width=WIDTH)
    model.load_state_dict(convert_params(jparams, model))
    return jmodel, jparams, model.eval()


@pytest.fixture(scope="module")
def source():
    """A 40-frame clip (L = 18 segments), its windows and seeded
    examples."""
    frames = _video(40)
    L = (len(frames) - W) // S
    windows = np.stack([frames[i * S:i * S + W] for i in range(L)])
    return frames, windows, L, _examples(20, 1), _examples(4, 2)


def test_audio_mlp_matches(vfa):
    _, jparams, _ = vfa
    tree = jparams["params"]["audio_mlp"]
    x = np.abs(np.random.default_rng(3).standard_normal(
        (5, 12288))).astype(np.float32)
    want = jax.jit(JaxAudioMLP(dtype=jnp.float32).apply)({"params": tree},
                                                         jnp.asarray(x))
    mlp = AudioMLP(dtype=torch.float32)
    mlp.load_state_dict(convert_params(tree, mlp))
    with torch.no_grad():
        got = mlp(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (5, 128)
    assert float(got.abs().max()) > 0  # the ReLUs leave something
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_embeddings_and_logits_match(vfa, source):
    jmodel, jparams, model = vfa
    _, windows, _, src, _ = source
    a = src[:4]
    v = windows[:8]
    want_a = _jit(jmodel, "embed_audio")(jparams, jnp.asarray(a))
    want_v = _jit(jmodel, "embed_video")(jparams, _jax_clips(v))
    want_l = jax.jit(jmodel.apply)(
        jparams, jnp.asarray(a),
        _jax_clips(v).reshape((4, 2) + v.shape[1:4] + (3,)))
    with torch.no_grad():
        got_a = model.embed_audio(torch.from_numpy(a))
        got_v = model.embed_video(_port_clips(v))
        got_l = model(torch.from_numpy(a),
                      _port_clips(v).reshape((4, 2) + v.shape[1:4] + (3,)))
    for got, want in ((got_a, want_a), (got_v, want_v)):
        assert tuple(got.shape) == (len(want), 128)
        np.testing.assert_allclose(
            torch.linalg.vector_norm(got, dim=-1).numpy(), 1.0, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    assert tuple(got_l.shape) == (4, 2)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=0,
                               atol=1e-4)


def _rows(jmodel, jparams, model, windows, drv):
    table = _jit(jmodel, "embed_video")(jparams, _jax_clips(windows))
    want = jax_ar.video_for_audio_logits(jmodel, jparams, drv, table, 0.1)
    with torch.no_grad():
        port_table = model.embed_video(_port_clips(windows))
    got = video_for_audio_logits(model, drv, port_table, 0.1)
    assert tuple(got.shape) == (len(drv), len(windows))
    assert got.dtype == torch.float32
    return got.numpy(), np.asarray(want)


def test_video_for_audio_logits_match(vfa, source):
    _, windows, _, _, drv = source
    got, want = _rows(*vfa, windows, drv)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_video_for_audio_logits_bf16(vfa, source):
    """bf16 on both sides, the same parameters: the two round VGGish, the
    AudioMLP, the encoder and the head differently, each landing about
    0.06 from the fp32 rows (logits are cosines / 0.1) and 0.03 from the
    other."""
    jmodel, jparams, model32 = vfa
    _, windows, _, _, drv = source
    fp32, _ = _rows(jmodel, jparams, model32, windows, drv)
    model = VideoForAudio(arch="resnet10", width=WIDTH)
    model.load_state_dict(convert_params(jparams, model))
    got, want = _rows(jax_ar.VideoForAudio(arch="resnet10"), jparams,
                      model.eval(), windows, drv)
    assert model.audio_mlp.Dense_2.weight.dtype == torch.bfloat16
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)
    for rows in (got, want):
        np.testing.assert_allclose(rows, fp32, rtol=0, atol=0.1)


def test_non_clip_encoder_raises():
    with pytest.raises(ValueError, match="clip encoder"):
        VideoForAudio(arch="slowfast")
    x = jnp.zeros((1, 1, 8, SIZE, SIZE, 3))
    with pytest.raises(ValueError, match="clip encoder"):
        jax.eval_shape(jax_ar.VideoForAudio(arch="slowfast").init,
                       jax.random.key(0), jnp.zeros((1, 100, 64)), x)


# --------------------------------------------------------------------- #
# The -daf Contrastive scorer
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def daf_resume(vfa, tmp_path_factory):
    """The drawn parameters in a file that avtex's save_checkpoint wrote."""
    from avtex.train.checkpoint import save_checkpoint
    d = tmp_path_factory.mktemp("daf")
    return save_checkpoint(str(d), "vfa", vfa[1], 3, "resnet10", 0.5, True)


def _fp32_scorers(monkeypatch):
    monkeypatch.setattr(jax_ar, "VideoForAudio", functools.partial(
        jax_ar.VideoForAudio, dtype=jnp.float32))
    monkeypatch.setattr(pipeline, "VideoForAudio", functools.partial(
        VideoForAudio, dtype=torch.float32))


CFG = dict(da_feats="Contrastive", enc_arch="resnet10", img_size=SIZE,
           mini_batchsize=5, temp=0.1)


@pytest.mark.parametrize("with_source_audio", [True, False])
def test_contrastive_scorer_matches(monkeypatch, source, daf_resume,
                                    with_source_audio):
    _fp32_scorers(monkeypatch)
    frames, _, L, src, drv = source
    src = src if with_source_audio else None
    steps = 6  # past the 4 driving examples: rows repeat the last
    want, wseed = jax_pipeline.make_audio_scorer(
        JaxConfig(**CFG, daf_resume=[daf_resume]), frames, src, L, W,
        S)(drv, steps)
    scorer = pipeline.make_audio_scorer(
        Config(**CFG, daf_resume=[daf_resume]), frames, src, L, W, S,
        device="cpu")
    got, seed = scorer(drv, steps)
    assert tuple(scorer.video_table.shape) == (L, 128)
    assert tuple(got.shape) == (steps, L) and got.dtype == torch.float32
    assert seed == wseed
    assert (seed is None) == (not with_source_audio)
    assert torch.equal(got[3], got[5])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    # the same walk from either package's rows
    q, t = np.abs(np.random.default_rng(5).standard_normal(
        (2, L, 32))).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    kw = dict(temp=0.1, threshold=0.05, alpha=0.5,
              seed_id=10 if seed is None else seed)
    w_walk = jax_engine.synthesize_indices_host(
        jnp.asarray(q), jnp.asarray(t), steps, audio_logits=np.asarray(want),
        rng=np.random.default_rng(3), **kw)
    g_walk = engine.synthesize_indices_host(
        torch.from_numpy(q), torch.from_numpy(t), steps, audio_logits=got,
        rng=np.random.default_rng(3), **kw)
    np.testing.assert_array_equal(g_walk.indices, w_walk.indices)


def test_contrastive_scorer_is_bf16_and_seeded(monkeypatch, source,
                                               tmp_path):
    """Without a -daf_resume file (here: one that does not exist) the head
    is flax_style_init's from cfg.seed, in bf16 whatever compute_dtype
    says."""
    frames, _, L, src, drv = source
    seeds = []
    real = pipeline.flax_style_init

    def recording(model, seed):
        seeds.append((type(model).__name__, seed))
        return real(model, seed)
    monkeypatch.setattr(pipeline, "flax_style_init", recording)
    cfg = Config(**CFG, compute_dtype="float32", seed=4,
                 daf_resume=[str(tmp_path / "missing")])
    scorer = pipeline.make_audio_scorer(cfg, frames, src, L, W, S,
                                        device="cpu")
    assert seeds == [("VideoForAudio", 4)]
    assert scorer.vfa.audio_mlp.Dense_0.weight.dtype == torch.bfloat16
    assert scorer.vfa.video_head.weight.dtype == torch.bfloat16
    rows, seed = scorer(drv, 6)
    assert tuple(rows.shape) == (6, L) and torch.isfinite(rows).all()
    assert seed is not None
    np.testing.assert_allclose(
        torch.linalg.vector_norm(scorer.video_table, dim=-1).numpy(), 1.0,
        atol=1e-5)


def test_server_builds_the_contrastive_scorer_once(tmp_path, daf_resume):
    from avtex_torch.media import write_wav
    from avtex_torch.synth import TextureServer
    frames = _video(60)
    g = np.random.default_rng(4)
    drive = write_wav(str(tmp_path / "drive.wav"),
                      (0.3 * g.standard_normal(3 * 22050)).astype(
                          np.float32), 22050)
    cfg = Config(**CFG, compute_dtype="float32", new_video_length=3,
                 daf_resume=[daf_resume])
    server = TextureServer.from_frames(cfg, frames, 10.0, device="cpu",
                                       width=WIDTH)
    a = server.synthesize(driving_audio=drive, seed=1, interpolate=False)
    b = server.synthesize(driving_audio=drive, seed=1, interpolate=False)
    assert "scorer_s" in a["timings"] and "scorer_s" not in b["timings"]
    assert "audio_rows_s" in b["timings"]
    # no source audio: the walk starts at cfg.start_segment
    assert a["result"].seed_id == b["result"].seed_id == min(
        cfg.start_segment, server.L - 1)
    np.testing.assert_array_equal(a["result"].indices, b["result"].indices)


# --------------------------------------------------------------------- #
# The trainer
# --------------------------------------------------------------------- #

class _Recording:
    """A numpy Generator that logs what permutation and choice return."""

    def __init__(self, real, seed, log):
        self._g, self._log = real(seed), log

    def permutation(self, *a, **k):
        out = self._g.permutation(*a, **k)
        self._log.append(np.array(out))
        return out

    def choice(self, *a, **k):
        out = self._g.choice(*a, **k)
        self._log.append(np.array(out))
        return out


def test_train_video_for_audio_matches(monkeypatch):
    """Two epochs of one step from avtex's own initial parameters, at LR
    1e-6. At avtex's 1e-3 the trajectory is chaotic: Adam moves every
    weight of the 12288-wide layer by ~10% of its scale a step, and an
    entry whose gradient is near rounding noise moves by +-LR either way,
    so the two packages' losses part by 1% within four steps. At 1e-6
    every tensor that is nonzero at init stays within 1e-3 relative L2
    (3e-6 measured) and the losses within 1e-4. A bias that starts at
    zero is made of such moves alone: an entry whose gradient is near
    Adam's eps moves by g / (|g| + eps), size and sign set by the
    rounding of g, so those tensors are held within 5e-2 (1.7e-2
    measured) and all parameters together within 1e-5."""
    frames = _video(10, seed=7)            # L = 3: 1 step an epoch
    examples = _examples(2, 8)             # fewer than L: ids clip
    kw = dict(arch="resnet10", img_size=SIZE, batch_size=2, n_negs=2,
              epochs=2, lr=1e-6, temp=0.1, seed=3)
    monkeypatch.setattr(jax_rt, "VideoForAudio", functools.partial(
        jax_rt.VideoForAudio, dtype=jnp.float32))
    # avtex's initial parameters, as its trainer hands them to Adam
    init = {}
    real_adam = optax.adam

    def adam(lr):
        tx = real_adam(lr)

        def record(params):
            init["params"] = jax.device_get(params)
            return tx.init(params)
        return optax.GradientTransformation(record, tx.update)
    monkeypatch.setattr(optax, "adam", adam)

    real = np.random.default_rng
    logs = []

    def recording(seed):
        logs.append([])
        return _Recording(real, seed, logs[-1])
    monkeypatch.setattr(np.random, "default_rng", recording)
    _, jparams, jhist = jax_rt.train_video_for_audio(frames, examples, W, S,
                                                     **kw)
    model = VideoForAudio(arch="resnet10", dtype=torch.float32, width=WIDTH)
    params0 = convert_params(init["params"], model)
    _, params, hist = train_video_for_audio(
        frames, examples, W, S, **kw, params=params0, dtype=torch.float32,
        device="cpu", width=WIDTH)
    monkeypatch.setattr(np.random, "default_rng", real)

    # per epoch one permutation, then per batch row one choice
    assert len(logs) == 2 and len(logs[0]) == len(logs[1]) == 2 * (1 + 2)
    for mine, theirs in zip(logs[1], logs[0]):
        np.testing.assert_array_equal(mine, theirs)
    assert len(hist) == len(jhist) == 2 and np.isfinite(hist).all()
    np.testing.assert_allclose(hist, jhist, rtol=1e-4)
    want = convert_params(jax.device_get(jparams), model)
    assert set(params) == set(want)
    diff2 = total2 = 0.0
    for name, p in params.items():
        d = float(torch.linalg.vector_norm(p - want[name]))
        n = float(torch.linalg.vector_norm(want[name]))
        diff2, total2 = diff2 + d * d, total2 + n * n
        zero_init = not bool(params0[name].any())
        assert d <= (5e-2 if zero_init else 1e-3) * n, (name, d / n)
    assert diff2 ** 0.5 <= 1e-5 * total2 ** 0.5
    # the master parameters go back to avtex's tree for -daf_resume
    back = export_params(params)["params"]
    assert back["video_head"]["kernel"].shape == (8 * WIDTH, 128)


def test_trainer_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_video_for_audio(_video(20), _examples(4, 0), W, S, epochs=1)
