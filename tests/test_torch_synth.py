"""Synthesis in the port (avtex_torch/synth/) against avtex.

- the host walk: bit-exact indices, jumps and per-step stats given the
  same tables and ``np.random.default_rng(seed)``;
- stitching: identical frames, interpolated frames, ids and audio;
- end to end: ``avtex_torch``'s TextureServer (from decoded frames) and
  pipeline against ``avtex``'s (from the file), on one tiny clip and the
  same carried-over weights: identical transition indices for the same
  seed, embedding tables within 1e-4; with ``walk_on_device=True`` the
  same, the port's device walk fed avtex's noise (the walk alone is held
  in tests/test_torch_device_walk.py).
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avtex.config import Config as JaxConfig
from avtex.nn import encoders as jax_encoders
from avtex.nn.slowfast import SlowFastR50 as JaxSF
from avtex.synth import engine as jax_engine
from avtex.synth import stitcher as jax_stitcher
from avtex_torch.config import Config
from avtex_torch.synth import engine, stitcher

torch.set_num_threads(1)


def _tables(L, D=64, seed=0):
    """Unit rows with non-negative entries, as SlowFast's pooled ReLU
    features are."""
    g = np.random.default_rng(seed)
    q, t = np.abs(g.standard_normal((2, L, D))).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    return q, t


@pytest.mark.parametrize("L,threshold,seed_id,steps", [
    (20, 0.0, 10, 40), (50, 0.3, 3, 60), (297, 0.5, 10, 149),
    (8, 1.0, 7, 25), (120, 0.1, 119, 80)])
def test_host_walk_bit_exact(L, threshold, seed_id, steps):
    q, t = _tables(L, seed=L)
    want = jax_engine.synthesize_indices_host(
        jnp.asarray(q), jnp.asarray(t), steps, temp=0.1,
        threshold=threshold, seed_id=seed_id,
        rng=np.random.default_rng(5))
    got = engine.synthesize_indices_host(
        torch.from_numpy(q), torch.from_numpy(t), steps, temp=0.1,
        threshold=threshold, seed_id=seed_id,
        rng=np.random.default_rng(5))
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.jumps, want.jumps)
    np.testing.assert_array_equal(got.nonzero_counts, want.nonzero_counts)
    np.testing.assert_array_equal(got.greedy_ids, want.greedy_ids)
    # The [L, L] products are summed in another order (torch vs XLA), so
    # the float stats agree to fp32 rounding, not bit for bit.
    np.testing.assert_allclose(got.entropies, want.entropies, rtol=1e-5)
    np.testing.assert_allclose(got.pos_prob, want.pos_prob, rtol=1e-5)


@pytest.mark.parametrize("max_length,window,stride", [
    (300, 15, 6), (900, 15, 6), (10, 15, 6), (16, 15, 6), (61, 4, 2)])
def test_num_synthesis_steps_equal(max_length, window, stride):
    assert (engine.num_synthesis_steps(max_length, window, stride)
            == jax_engine.num_synthesis_steps(max_length, window, stride))


def test_seed_segment_matches():
    g = np.random.default_rng(0)
    ex = g.standard_normal((12, 10, 4)).astype(np.float32)
    drv = ex[7] + 0.01
    assert engine.seed_segment(None, drv) == 10
    assert (engine.seed_segment(ex, drv, num_segments=10)
            == jax_engine.seed_segment(jnp.asarray(ex), jnp.asarray(drv),
                                       num_segments=10) == 7)
    neg = -np.ones_like(ex[0])
    assert (engine.seed_segment(ex, neg)
            == jax_engine.seed_segment(jnp.asarray(ex), jnp.asarray(neg)))


@pytest.mark.parametrize("sub", [1, 2])
@pytest.mark.parametrize("bar", [False, True])
def test_stitch_texture_identical(sub, bar):
    g = np.random.default_rng(sub)
    video = g.integers(0, 256, (200, 30, 20, 3), dtype=np.uint8)
    audio = g.standard_normal(200 * 1000).astype(np.float32)
    indices = [3, 4, 5, 9, 10, 2, 3, 11]
    ids, jumps = stitcher.walk_frame_ids(indices, 6, 3)
    jids, jjumps = jax_stitcher.walk_frame_ids(indices, 6, 3)
    np.testing.assert_array_equal(ids, jids)
    assert jumps == jjumps
    kw = dict(sf=5, subsample_rate=sub, interpolate=True, frames_bar=bar,
              source_audio=audio, audio_sample_rate=30000, fps=30.0)
    got = stitcher.stitch_texture(video, indices, 6, 3, **kw)
    want = jax_stitcher.stitch_texture(video, indices, 6, 3, **kw)
    for key in ("frames", "frames_intp", "frame_ids", "audio"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["jump_count"] == want["jump_count"] == 3


# --------------------------------------------------------------------- #
# End to end on a tiny clip
# --------------------------------------------------------------------- #

SMALL = dict(width=8, layers=(2, 1, 1, 1))


def _small_jax_slowfast(dtype=None, norm="group", remat=False):
    return JaxSF(**SMALL, dtype=jnp.float32, norm=norm, remat=remat)


@pytest.fixture
def tiny_clip(tmp_path):
    from avtex.media import read_video, write_video
    t, h, w = 64, 32, 32
    yy, xx = np.mgrid[0:h, 0:w]
    vid = np.clip(127 + 60 * np.stack(
        [np.sin(xx / 3 + i / 2) + np.cos(yy / 5 - i / 7) for i in range(t)]
    )[..., None].repeat(3, -1) + (np.arange(t) % 9)[:, None, None, None],
        0, 255).astype(np.uint8)
    path = str(tmp_path / "clip.mp4")
    write_video(vid, path, fps=8.0)
    frames, fps = read_video(path)
    return path, frames, fps


def _jax_params(model, frames, window):
    """avtex params as numpy, drawn directly (no init compile)."""
    from avtex.data.preprocess import preprocess_clip
    from avtex.nn.slowfast import slowfast_pathways
    x = slowfast_pathways(preprocess_clip(
        jnp.asarray(frames[None, :window]), size=32, slowfast=True))
    shapes = jax.eval_shape(model.init, jax.random.key(0), x,
                            tuple(p[:, None] for p in x))
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


def test_server_and_pipeline_match_avtex(monkeypatch, tiny_clip):
    from avtex.contrastive.model import ContrastiveTextures as JaxCT
    from avtex.synth.pipeline import synthesize as jax_synthesize
    from avtex.synth.server import TextureServer as JaxServer
    from avtex_torch.synth import TextureServer, synthesize
    from avtex_torch.synth.pipeline import build_model
    from avtex_torch.convert import convert_params

    monkeypatch.setitem(jax_encoders.ENCODER_REGISTRY, "slowfast",
                        (_small_jax_slowfast, "slowfast"))
    path, frames, fps = tiny_clip
    common = dict(enc_arch="slowfast", norm="affine", img_size=32,
                  mini_batchsize=8, new_video_length=4, seed=0)
    jcfg = JaxConfig(**common)
    cfg = Config(**common, compute_dtype="float32")
    W = jcfg.derive_geometry(fps).window

    jparams = _jax_params(JaxCT(arch="slowfast", norm="affine"), frames, W)
    port_model = build_model(cfg, None, "cpu", **SMALL)
    params = convert_params(jparams, port_model)

    jserver = JaxServer(jcfg, path, params=jparams)
    server = TextureServer.from_frames(cfg, frames, fps, params,
                                       device="cpu", **SMALL)
    assert server.L == jserver.L > 20
    for mine, theirs in ((server.q_table, jserver.q_table),
                         (server.t_table, jserver.t_table)):
        assert tuple(mine.shape) == (server.L, 288)
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   rtol=1e-4, atol=1e-4)

    jumps = 0
    for req in (dict(seconds=4, seed=1), dict(seconds=6, threshold=0.2,
                                              seed=2),
                dict(seconds=3, threshold=0.05, seed=3,
                     seed_segment_id=5)):
        got = server.synthesize(**req)
        want = jserver.synthesize(**req)
        jumps += int(want["result"].jumps[1:].sum())
        np.testing.assert_array_equal(got["result"].indices,
                                      want["result"].indices)
        np.testing.assert_array_equal(got["frames"], want["frames"])
        np.testing.assert_array_equal(got["frames_intp"],
                                      want["frames_intp"])
    assert jumps > 0  # the walks do leave the identity path
    again = server.synthesize(seconds=4, seed=1)
    np.testing.assert_array_equal(
        again["result"].indices, server.synthesize(seconds=4, seed=1)[
            "result"].indices)

    # The one-shot pipeline (decode included) agrees too.
    got = synthesize(cfg, path, params, device="cpu", **SMALL)
    want = jax_synthesize(jcfg, path, jparams)
    np.testing.assert_array_equal(got["result"].indices,
                                  want["result"].indices)
    np.testing.assert_array_equal(got["stitched"]["frames_intp"],
                                  want["stitched"]["frames_intp"])


def test_server_and_pipeline_device_walk_match_avtex(monkeypatch, tiny_clip):
    """``walk_on_device=True`` in the server and in ``synthesize``: the
    port's device walk fed the draws of avtex's ``jax.random.key(seed)``
    picks avtex's indices and frames."""
    from avtex.contrastive.model import ContrastiveTextures as JaxCT
    from avtex.synth.pipeline import synthesize as jax_synthesize
    from avtex.synth.server import TextureServer as JaxServer
    from avtex_torch.convert import convert_params
    from avtex_torch.synth import TextureServer, server as server_mod
    from avtex_torch.synth import synthesize
    from avtex_torch.synth.pipeline import build_model
    from test_torch_device_walk import _avtex_noise

    def on_avtex_noise(q, t, steps, seed=0, **kw):
        return engine.synthesize_indices(
            q, t, steps, noise=_avtex_noise(seed, steps, q.shape[0]), **kw)

    monkeypatch.setenv("AVTEX_WALK_AOT", "0")
    monkeypatch.setattr(server_mod, "synthesize_indices", on_avtex_noise)
    monkeypatch.setitem(jax_encoders.ENCODER_REGISTRY, "slowfast",
                        (_small_jax_slowfast, "slowfast"))
    path, frames, fps = tiny_clip
    common = dict(enc_arch="slowfast", norm="affine", img_size=32,
                  mini_batchsize=8, new_video_length=4, seed=0)
    jcfg = JaxConfig(**common)
    cfg = Config(**common, compute_dtype="float32")
    W = jcfg.derive_geometry(fps).window
    jparams = _jax_params(JaxCT(arch="slowfast", norm="affine"), frames, W)
    params = convert_params(jparams, build_model(cfg, None, "cpu", **SMALL))
    jserver = JaxServer(jcfg, path, params=jparams)
    server = TextureServer.from_frames(cfg, frames, fps, params,
                                       device="cpu", **SMALL)
    jumps = 0
    for req in (dict(seconds=4, seed=1), dict(seconds=6, threshold=0.2,
                                              seed=2)):
        got = server.synthesize(walk_on_device=True, **req)
        want = jserver.synthesize(walk_on_device=True, **req)
        jumps += int(want["result"].jumps[1:].sum())
        for key in ("indices", "jumps", "nonzero_counts", "greedy_ids"):
            np.testing.assert_array_equal(getattr(got["result"], key),
                                          getattr(want["result"], key))
        np.testing.assert_allclose(got["result"].entropies,
                                   want["result"].entropies, rtol=1e-5)
        np.testing.assert_array_equal(got["frames"], want["frames"])
    assert jumps > 0
    got = synthesize(cfg, path, params, device="cpu", walk_on_device=True,
                     **SMALL)
    want = jax_synthesize(jcfg, path, jparams, walk_on_device=True)
    np.testing.assert_array_equal(got["result"].indices,
                                  want["result"].indices)
    np.testing.assert_array_equal(got["stitched"]["frames_intp"],
                                  want["stitched"]["frames_intp"])


def test_server_refuses_what_is_not_ported(tiny_clip):
    from avtex_torch.synth import TextureServer
    _, frames, fps = tiny_clip
    # every -daf mode is ported (-daf Contrastive is held against avtex in
    # tests/test_torch_retrieval.py); model_type=2 without source audio
    # raises as avtex does
    with pytest.raises(ValueError, match="requires audio examples"):
        TextureServer.from_frames(Config(enc_arch="slowfast", model_type=2),
                                  frames, fps, device="cpu", **SMALL)
