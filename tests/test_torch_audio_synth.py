"""Audio-conditioned synthesis in the port (``model_type=2`` and driving
audio) against avtex, on the same seeded numpy inputs.

- the walk: ``driving_audio_logits`` within 1e-5 (fp32 cosines / temp),
  the host walk with ``audio_logits`` bit-exact (indices, jumps, greedy
  ids, survivor counts) at alpha 0, 0.5 and 1 from the same rows and seed;
- the scorer: ``make_audio_scorer`` rows and seed for ``-daf Mel`` within
  1e-5; for ``-daf VGG`` both run VGGish at its default bf16 (as avtex
  does), whose two implementations round differently: rows within 2e-2
  of logits that are cosines / 0.1 (a cosine within 2e-3), the seed equal;
- end to end on a tiny clip (32 px, width-8 SlowFast, full-width VGGish,
  fp32 on both sides): the ``[L, 288 + 12288]`` tables within 1e-4, also
  with source audio shorter than the L segments (ids clipped to the last
  example); driving-audio requests through ``TextureServer`` and
  ``synthesize(driving_audio_path=)`` with identical indices, frame count
  and output audio (the driving waveform), a driving clip longer than
  the request included;
- refusals: driving audio without source audio (avtex's ValueError),
  ``model_type=2`` without audio, ``-daf Contrastive``.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import avtex.contrastive.model as jax_model
import avtex.nn.vggish as jax_vggish
from avtex.config import Config as JaxConfig
from avtex.nn import encoders as jax_encoders
from avtex.nn.slowfast import SlowFastR50 as JaxSF
from avtex.synth import engine as jax_engine
from avtex.synth import pipeline as jax_pipeline
from avtex_torch import checkpoints
from avtex_torch.config import Config
from avtex_torch.nn.vggish import VGGish
from avtex_torch.synth import engine, pipeline

torch.set_num_threads(1)

SMALL = dict(width=8, layers=(2, 1, 1, 1))
FEAT = 288 + 12288


# --------------------------------------------------------------------- #
# The walk and the logits
# --------------------------------------------------------------------- #

def _rows(shape, seed):
    """Non-negative rows, as cosines of ReLU features are."""
    return np.abs(np.random.default_rng(seed).standard_normal(shape)
                  ).astype(np.float32)


def test_driving_audio_logits_match():
    src, drv = _rows((37, 500), 0) - 0.3, _rows((23, 500), 1) - 0.3
    want = np.asarray(jax_engine.driving_audio_logits(
        jnp.asarray(src), jnp.asarray(drv), 0.1))
    got = engine.driving_audio_logits(torch.from_numpy(src),
                                      torch.from_numpy(drv), 0.1)
    assert got.dtype == torch.float32 and tuple(got.shape) == (23, 37)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("L,threshold,seed_id,steps", [
    (40, 0.0, 10, 50), (120, 0.2, 119, 80), (297, 0.5, 3, 149)])
def test_host_walk_with_audio_bit_exact(alpha, L, threshold, seed_id, steps):
    q, t = _rows((2, L, 64), L)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    audio = _rows((steps, L), L + 1) / 0.1
    kw = dict(temp=0.1, threshold=threshold, alpha=alpha, seed_id=seed_id)
    want = jax_engine.synthesize_indices_host(
        jnp.asarray(q), jnp.asarray(t), steps, audio_logits=audio,
        rng=np.random.default_rng(7), **kw)
    got = engine.synthesize_indices_host(
        torch.from_numpy(q), torch.from_numpy(t), steps,
        audio_logits=torch.from_numpy(audio),
        rng=np.random.default_rng(7), **kw)
    for key in ("indices", "jumps", "greedy_ids", "nonzero_counts"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key),
                                      err_msg=key)
    np.testing.assert_allclose(got.pos_prob, want.pos_prob, rtol=1e-5)
    if alpha == 0.0:
        # video rows have no weight: the same walk for any tables
        other = engine.synthesize_indices_host(
            torch.from_numpy(t), torch.from_numpy(q), steps,
            audio_logits=audio, rng=np.random.default_rng(7), **kw)
        np.testing.assert_array_equal(other.indices, got.indices)


# --------------------------------------------------------------------- #
# Media: a tiny clip, its wav and driving wavs
# --------------------------------------------------------------------- #

def _tone_track(seconds, sr, phase_fn, seed):
    """Tones whose pitch follows ``phase_fn(t)`` plus seeded noise."""
    g = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f = 300 + 250 * phase_fn(t)
    x = 0.4 * np.sin(2 * np.pi * np.cumsum(f) / sr) \
        + 0.03 * g.standard_normal(len(t))
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    from avtex.media import read_video, write_video, write_wav
    d = tmp_path_factory.mktemp("media")
    t, h, w = 64, 32, 32
    yy, xx = np.mgrid[0:h, 0:w]
    vid = np.clip(127 + 60 * np.stack(
        [np.sin(xx / 3 + i / 2) + np.cos(yy / 5 - i / 7) for i in range(t)]
    )[..., None].repeat(3, -1) + (np.arange(t) % 9)[:, None, None, None],
        0, 255).astype(np.uint8)
    path = str(d / "clip.mp4")
    write_video(vid, path, fps=8.0)
    frames, fps = read_video(path)
    brightness = lambda s: np.sin(s * 8.0 / 2)  # noqa: E731 (frame phase)
    paths = {
        "video": path,
        "wav": write_wav(str(d / "clip.wav"),
                         _tone_track(8.0, 22050, brightness, 0), 22050),
        "short_wav": write_wav(str(d / "short.wav"),
                               _tone_track(2.0, 22050, brightness, 1), 22050),
        "drive": write_wav(str(d / "drive.wav"), np.stack(
            [_tone_track(5.0, 44100, lambda s: np.cos(1.3 * s), 2)] * 2, -1),
            44100),
        "drive16": write_wav(str(d / "drive16.wav"), _tone_track(
            2.5, 16000, lambda s: np.sin(3 * s + 1), 3), 16000),
    }
    vg = VGGish(torch.float32)
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for p in vg.parameters():
            p.copy_(torch.randn(p.shape, generator=g)
                    * (0.02 if p.ndim == 1 else (p[0].numel()) ** -0.5))
    state = checkpoints.vggish_reference_state(vg)
    state["embeddings.0.weight"] = torch.zeros(16, 8)
    paths["vggish"] = str(d / "pytorch_vggish.pth")
    torch.save(state, paths["vggish"])
    return paths, frames, fps


def _examples(path, sub=1):
    from avtex.audio.mel import waveform_to_examples
    from avtex.media import read_wav
    x, sr = read_wav(path)
    return np.array(waveform_to_examples(x, sr * sub))


@pytest.fixture
def fp32(monkeypatch, media):
    """Both packages' models and scorer VGGish in fp32, the encoders at
    width 8, and the scorer's VGGish weights from the test's file."""
    monkeypatch.setitem(jax_encoders.ENCODER_REGISTRY, "slowfast", (
        lambda dtype=None, norm="group", remat=False: JaxSF(
            **SMALL, dtype=jnp.float32, norm=norm, remat=remat),
        "slowfast"))
    monkeypatch.setattr(jax_model, "ContrastiveTextures", functools.partial(
        jax_model.ContrastiveTextures, dtype=jnp.float32))
    monkeypatch.setattr(jax_vggish, "VGGish", functools.partial(
        jax_vggish.VGGish, dtype=jnp.float32))
    monkeypatch.setattr(pipeline, "VGGish", functools.partial(
        VGGish, dtype=torch.float32))
    monkeypatch.setenv("AVTEX_VGGISH_CKPT", media[0]["vggish"])


# --------------------------------------------------------------------- #
# The scorer
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("daf", ["Mel", "VGG"])
def test_scorer_rows_and_seed_match(daf, media, monkeypatch):
    monkeypatch.setenv("AVTEX_VGGISH_CKPT", media[0]["vggish"])
    src = _examples(media[0]["wav"])
    drv = _examples(media[0]["drive"])
    L, steps = 30, 20
    jcfg, cfg = JaxConfig(da_feats=daf), Config(da_feats=daf)
    want, wseed = jax_pipeline.make_audio_scorer(
        jcfg, None, src, L, 4, 2)(drv, steps)
    got, seed = pipeline.driving_audio_rows(cfg, None, src, drv, steps, L,
                                            4, 2, device="cpu")
    assert tuple(got.shape) == (steps, L) and got.dtype == torch.float32
    assert seed == wseed
    tol = 1e-5 if daf == "Mel" else 2e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=tol)


def test_scorer_seed_is_the_audio_match(monkeypatch):
    g = np.random.default_rng(4)
    src = g.standard_normal((40, 100, 64)).astype(np.float32)
    drv = np.concatenate([src[17:23] + 0.01, src[:3]])
    for daf in ("Mel", "VGG"):
        if daf == "VGG":
            monkeypatch.setattr(pipeline, "VGGish", functools.partial(
                VGGish, dtype=torch.float32))
        logits, seed = pipeline.driving_audio_rows(
            Config(da_feats=daf), None, src, drv, 12, 30, 4, 2,
            device="cpu")
        assert seed == 17
        # past the driving clip's end, rows repeat its last example's
        assert torch.equal(logits[8], logits[11])
        if daf == "Mel":
            assert int(logits[0].argmax()) == 17


def test_scorer_refusals():
    src = np.zeros((5, 100, 64), np.float32)
    with pytest.raises(NotImplementedError, match="Contrastive extras"):
        pipeline.make_audio_scorer(Config(da_feats="Contrastive"), None, src,
                                   5, 4, 2, device="cpu")
    for mod, cfg in ((pipeline, Config()), (jax_pipeline, JaxConfig())):
        with pytest.raises(ValueError, match="no audio track"):
            mod.make_audio_scorer(cfg, None, None, 5, 4, 2)
    with pytest.raises(ValueError, match="unknown -daf"):
        pipeline.make_audio_scorer(Config(da_feats="vgg"), None, src, 5, 4,
                                   2, device="cpu")


# --------------------------------------------------------------------- #
# End to end on the tiny clip
# --------------------------------------------------------------------- #

def _jax_params(frames, window):
    """avtex model_type=2 params as numpy, drawn directly (no init
    compile)."""
    from avtex.data.preprocess import preprocess_clip
    from avtex.nn.slowfast import slowfast_pathways
    model = jax_model.ContrastiveTextures(arch="slowfast", model_type=2,
                                          norm="affine")
    x = slowfast_pathways(preprocess_clip(
        jnp.asarray(frames[None, :window]), size=32, slowfast=True))
    shapes = jax.eval_shape(model.init, jax.random.key(0), x,
                            tuple(p[:, None] for p in x),
                            jnp.zeros((1, 100, 64)),
                            jnp.zeros((1, 1, 100, 64)))
    g = np.random.default_rng(0)

    def draw(path, s):
        if path[-1].key == "scale":
            return (1.0 + 0.1 * g.standard_normal(s.shape)).astype(np.float32)
        if path[-1].key == "bias":
            return (0.1 * g.standard_normal(s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (g.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
            np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


COMMON = dict(enc_arch="slowfast", norm="affine", img_size=32,
              mini_batchsize=8, new_video_length=4, seed=0, model_type=2)


@pytest.fixture
def servers(fp32, media):
    from avtex.synth.server import TextureServer as JaxServer
    from avtex_torch.convert import convert_params
    from avtex_torch.synth import TextureServer
    from avtex_torch.synth.pipeline import build_model

    def make(wav_key, **cfg_kw):
        paths, frames, fps = media
        jcfg = JaxConfig(**COMMON, **cfg_kw)
        cfg = Config(**COMMON, **cfg_kw, compute_dtype="float32")
        W = jcfg.derive_geometry(fps).window
        jparams = _jax_params(frames, W)
        params = convert_params(jparams, build_model(cfg, None, "cpu",
                                                     **SMALL))
        jserver = JaxServer(jcfg, paths["video"], params=jparams,
                            audio_path=paths[wav_key])
        server = TextureServer.from_frames(
            cfg, frames, fps, params, audio_path=paths[wav_key],
            device="cpu", **SMALL)
        return server, jserver, params, jparams
    return make


@pytest.mark.parametrize("wav_key", ["wav", "short_wav"])
def test_m2_tables_match_avtex(servers, wav_key):
    server, jserver, _, _ = servers(wav_key)
    n_ex = len(server.audio_examples)
    assert server.L == jserver.L == 30
    # the short wav has fewer examples than segments: ids clip to its last
    assert (n_ex < server.L) == (wav_key == "short_wav")
    np.testing.assert_allclose(server.audio_examples.numpy(),
                               jserver.audio_examples, rtol=0, atol=1e-4)
    for mine, theirs in ((server.q_table, jserver.q_table),
                         (server.t_table, jserver.t_table)):
        assert tuple(mine.shape) == (server.L, FEAT)
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   rtol=1e-4, atol=1e-4)
    if wav_key == "short_wav":
        # segments past the last example share its audio half
        a = server.t_table[n_ex - 1:, 288:].numpy()
        np.testing.assert_allclose(
            a / np.linalg.norm(a, axis=1, keepdims=True),
            np.broadcast_to(a[:1] / np.linalg.norm(a[:1]), a.shape),
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("daf", ["Mel", "VGG"])
def test_driving_audio_requests_match_avtex(servers, media, daf):
    from avtex.media import read_wav
    server, jserver, _, _ = servers("wav", da_feats=daf)
    paths = media[0]
    drive, d_sr = read_wav(paths["drive"])
    jumps = 0
    for req in (dict(seconds=3, seed=1, alpha=0.5),
                dict(seconds=30, seed=2, alpha=0.0, threshold=0.1),
                dict(seconds=30, seed=3, alpha=1.0)):
        got = server.synthesize(driving_audio=paths["drive"], **req)
        want = jserver.synthesize(driving_audio=paths["drive"], **req)
        r, w = got["result"], want["result"]
        assert r.seed_id == w.seed_id != server.cfg.start_segment
        jumps += int(w.jumps[1:].sum())
        np.testing.assert_array_equal(r.indices, w.indices)
        np.testing.assert_array_equal(r.jumps, w.jumps)
        assert len(got["frames"]) == len(want["frames"])
        np.testing.assert_array_equal(got["frames"], want["frames"])
        assert got["sample_rate"] == want["sample_rate"] == d_sr == 44100
        np.testing.assert_array_equal(got["audio"], drive)
        np.testing.assert_array_equal(got["audio"], want["audio"])
        assert "audio_rows_s" in got["timings"]
    assert jumps > 0  # the walks do leave the identity path
    # 30 s asked: the 5 s driving clip sets the length; 3 s asked: the
    # driving clip is longer than the request
    assert len(got["frames"]) < 30 * server.fps
    assert server.synthesize(driving_audio=paths["drive"], seconds=3,
                             seed=1, interpolate=False)["timings"].get(
        "scorer_s") is None  # built once, by the first request


def test_pipeline_with_driving_audio_matches_avtex(servers, media, tmp_path):
    from avtex_torch.synth import synthesize
    server, _, params, jparams = servers("wav", da_feats="Mel")
    paths = media[0]
    jcfg = JaxConfig(**COMMON, da_feats="Mel", alpha=0.3)
    cfg = Config(**COMMON, da_feats="Mel", alpha=0.3,
                 compute_dtype="float32")
    want = jax_pipeline.synthesize(jcfg, paths["video"], jparams,
                                   audio_path=paths["wav"],
                                   driving_audio_path=paths["drive16"])
    got = synthesize(cfg, paths["video"], params, audio_path=paths["wav"],
                     driving_audio_path=paths["drive16"],
                     out_dir=str(tmp_path), device="cpu", **SMALL)
    np.testing.assert_array_equal(got["result"].indices,
                                  want["result"].indices)
    assert got["result"].seed_id == want["result"].seed_id
    np.testing.assert_array_equal(got["stitched"]["frames"],
                                  want["stitched"]["frames"])
    assert "audio_rows_s" in got["timings"]
    from avtex_torch.media import read_wav
    d, _ = read_wav(paths["drive16"])
    np.testing.assert_array_equal(got["stitched"]["audio"], d)


def test_driving_audio_without_source_audio_raises(fp32, media):
    from avtex.synth.server import TextureServer as JaxServer
    from avtex_torch.synth import TextureServer
    paths, frames, fps = media
    kw = dict(enc_arch="slowfast", norm="affine", img_size=32,
              mini_batchsize=8)
    server = TextureServer.from_frames(Config(**kw, compute_dtype="float32"),
                                       frames, fps, device="cpu", **SMALL)
    with pytest.raises(ValueError, match="no audio track"):
        server.synthesize(seconds=2, driving_audio=paths["drive"])
    # avtex's model_type=1 params: the model_type=2 draw without VGGish
    jparams = _jax_params(frames, JaxConfig().derive_geometry(fps).window)
    del jparams["params"]["audio_encoder"]
    jserver = JaxServer(JaxConfig(**kw), paths["video"], params=jparams)
    with pytest.raises(ValueError, match="no audio track"):
        jserver.synthesize(seconds=2, driving_audio=paths["drive"])


def test_m2_without_audio_raises(fp32, media):
    from avtex_torch.synth import TextureServer
    _, frames, fps = media
    with pytest.raises(ValueError, match="requires audio examples"):
        TextureServer.from_frames(Config(**COMMON, compute_dtype="float32"),
                                  frames, fps, device="cpu", **SMALL)
