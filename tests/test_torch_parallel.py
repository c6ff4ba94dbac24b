"""The port's parallel layer (avtex_torch/parallel/) against avtex's
(avtex/parallel/), on the CPU.

The port's side runs in gloo worlds of 2 and 4 processes
(tests/torch_dist_worker.py: each rank imports torch and avtex_torch
only), started once for this file, and at world size 1 in this process;
avtex's side runs here on its eight virtual devices. Both models are
fp32 and carry the same weights (avtex's drawn, carried over by
``convert_params``); the tables agree within 1e-4.

- ``make_mesh``: data outer, model inner; ``shard_leading``,
  ``replicate`` and the shape error;
- ``param_shardings`` splits the tensors avtex's splits, on the torch
  dims that avtex's flax dims map to (``-m 2`` ContrastiveTextures and
  VideoForAudio); ``shard_params`` / ``gather_params`` round trip;
- ``sharded_embed_segments`` on avtex's own test geometry (resnet10, 11
  windows of 4 x 16^2: L pads at both world sizes), the SlowFast
  ``sharded_embed_from_video`` at width 8, 32 px, and a ``-m 2`` table
  through the tensor-parallel VGGish at meshes (2, 2) and (1, 4), and
  VideoForAudio's audio rows through the split VGGish and AudioMLP;
- ``embed_segments`` / ``precompute_embeddings`` over pre-gathered
  windows, a server with a one-process mesh, and ``write_frames_png``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtex.contrastive.model import ContrastiveTextures as JaxCT
from avtex.nn import encoders as jax_encoders
from avtex.nn.slowfast import SlowFastR50 as JaxSF
from avtex.parallel import make_mesh as jax_make_mesh
from avtex_torch.contrastive.model import ContrastiveTextures
from avtex_torch.convert import convert_params

from torch_dist_worker import run_world

torch.set_num_threads(1)

TOL = 1e-4
SMALL_SF = dict(width=8, layers=(2, 1, 1, 1))
RESNET = dict(arch="resnet10", model_type=1)
M2 = dict(arch="resnet10", model_type=2)
SLOWFAST = dict(arch="slowfast", model_type=1, norm="affine")


def _draw(path, s, g):
    if path[-1].key == "scale":
        return (1.0 + 0.1 * g.standard_normal(s.shape)).astype(np.float32)
    if path[-1].key == "bias":
        return (0.1 * g.standard_normal(s.shape)).astype(np.float32)
    fan_in = int(np.prod(s.shape[:-1]))
    return (g.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)


def _jax_params(model, *args, seed=0):
    """avtex parameters drawn as numpy from the init's shapes (no init
    compile)."""
    shapes = jax.eval_shape(model.init, jax.random.key(0), *args)
    g = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(lambda p, s: _draw(p, s, g),
                                            shapes)


def _small_jax_slowfast(dtype=None, norm="group", remat=False):
    return JaxSF(**SMALL_SF, dtype=jnp.float32, norm=norm, remat=remat)


@pytest.fixture(scope="module")
def small_slowfast():
    """avtex's registry builds the width-8 SlowFast for this module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_encoders.ENCODER_REGISTRY, "slowfast",
                   (_small_jax_slowfast, "slowfast"))
        yield


def _avtex_model(spec):
    return JaxCT(**spec, dtype=jnp.float32)


def _port_kw(spec):
    kw = dict(spec, dtype="float32")
    if spec["arch"] == "slowfast":
        kw.update(SMALL_SF)
    return kw


def _params_for(spec, frames, size, audio=None):
    """(avtex params tree, the port's state_dict as numpy) for ``spec``
    on clips of ``frames`` ([1, W, H, W, 3] uint8)."""
    from avtex.data.preprocess import preprocess_clip
    from avtex.nn.slowfast import slowfast_pathways
    model = _avtex_model(spec)
    x = preprocess_clip(jnp.asarray(frames), size=size,
                        slowfast=spec["arch"] == "slowfast")
    if spec["arch"] == "slowfast":
        x = slowfast_pathways(x)
        t = tuple(p[:, None] for p in x)
    else:
        t = x[:, None]
    a = () if audio is None else (jnp.asarray(audio[:1]),
                                  jnp.asarray(audio[:1])[:, None])
    tree = _jax_params(model, x, t, *a)
    port = ContrastiveTextures(**{**_port_kw(spec), "dtype": torch.float32})
    sd = convert_params(jax.tree.map(np.asarray, tree), port)
    return tree, {k: v.numpy() for k, v in sd.items()}


def _inputs():
    g = np.random.default_rng(0)
    windows = (g.random((11, 4, 16, 16, 3)) * 255).astype(np.uint8)
    sf_video = (g.random((22, 32, 32, 3)) * 255).astype(np.uint8)
    m2_video = (g.random((22, 16, 16, 3)) * 255).astype(np.uint8)
    audio = g.standard_normal((7, 100, 64)).astype(np.float32)
    return windows, sf_video, m2_video, audio


@pytest.fixture(scope="module")
def setup(small_slowfast):
    windows, sf_video, m2_video, audio = _inputs()
    out = {"windows": windows, "sf_video": sf_video, "m2_video": m2_video,
           "audio": audio}
    out["resnet"] = _params_for(RESNET, windows[:1], 16)
    out["slowfast"] = _params_for(SLOWFAST, sf_video[None, :4], 32)
    out["m2"] = _params_for(M2, m2_video[None, :4], 16, audio)
    return out


def _jobs(s, world):
    resnet = dict(model_kw=_port_kw(RESNET), params=s["resnet"][1],
                  tower="target", img_size=16, batch_size=4,
                  windows=s["windows"])
    slowfast = dict(model_kw=_port_kw(SLOWFAST), params=s["slowfast"][1],
                    tower="query", img_size=32, batch_size=4,
                    video=s["sf_video"], window=4, stride=2, num_segments=9)
    jobs = {"resnet": ("embed", dict(resnet, shape=None)),
            "slowfast": ("embed", dict(slowfast, shape=None))}
    if world == 4:
        m2 = dict(model_kw=_port_kw(M2), params=s["m2"][1], tower="target",
                  img_size=16, batch_size=4, video=s["m2_video"], window=4,
                  stride=2, num_segments=9, audio=s["audio"])
        jobs.update({
            "m2 (2, 2)": ("embed", dict(m2, shape=(2, 2))),
            "m2 (1, 4)": ("embed", dict(m2, shape=(1, 4))),
            "mesh (2, 2)": ("mesh_info", dict(shape=(2, 2))),
            "mesh (1, 4)": ("mesh_info", dict(shape=(1, 4))),
            "mesh None": ("mesh_info", dict(shape=None)),
            "mesh error": ("mesh_error", dict(shape=(3, 1))),
            "round trip (2, 2)": ("shard_round_trip", dict(
                shape=(2, 2), model_kw=_port_kw(M2), params=s["m2"][1])),
            "round trip (1, 4)": ("shard_round_trip", dict(
                shape=(1, 4), model_kw=_port_kw(M2), params=s["m2"][1])),
            "vfa (2, 2)": ("video_for_audio", dict(shape=(2, 2),
                                                   examples=s["audio"])),
            "vfa (1, 4)": ("video_for_audio", dict(shape=(1, 4),
                                                   examples=s["audio"])),
        })
    return jobs


@pytest.fixture(scope="module")
def worlds(setup, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("worlds")
    out = {}
    for world in (2, 4):
        jobs = _jobs(setup, world)
        results = run_world(tmp, world, list(jobs.values()))
        out[world] = dict(zip(jobs, results))
    return out


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh()


# ------------------------------------------------------------------ #
# The mesh
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("key,shape", [("mesh (2, 2)", (2, 2)),
                                       ("mesh (1, 4)", (1, 4)),
                                       ("mesh None", (4, 1))])
def test_make_mesh_lays_ranks_out_data_outer(worlds, key, shape):
    for rank, info in enumerate(worlds[4][key]):
        assert info["data"] == (shape[0], rank // shape[1])
        assert info["model"] == (shape[1], rank % shape[1])
        b = 8 // shape[0]
        d = rank // shape[1]
        np.testing.assert_array_equal(info["leading"],
                                      np.arange(d * b, (d + 1) * b))
        np.testing.assert_array_equal(info["replicated"], np.zeros(3))


def test_make_mesh_refuses_a_shape_that_is_not_the_world(worlds):
    assert worlds[4]["mesh error"] == ["mesh shape (3, 1) != 4 devices"] * 4
    with pytest.raises(ValueError, match="mesh shape"):
        jax_make_mesh((3, 1))


def test_make_mesh_one_process_world():
    from avtex_torch.parallel import make_mesh, shard_leading, shutdown
    mesh = make_mesh(device="cpu")
    try:
        assert mesh["data"].size() == mesh["model"].size() == 1
        assert mesh.mesh_dim_names == ("data", "model")
        np.testing.assert_array_equal(shard_leading(mesh, np.arange(5)),
                                      np.arange(5))
        with pytest.raises(ValueError, match="mesh shape"):
            make_mesh((2, 1), device="cpu")
    finally:
        shutdown()
    assert not torch.distributed.is_initialized()


def test_make_mesh_needs_a_gpu_unless_asked(monkeypatch):
    from avtex_torch.parallel import make_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()
    assert not torch.distributed.is_initialized()


# ------------------------------------------------------------------ #
# The tensor-parallel rules
# ------------------------------------------------------------------ #

def _avtex_split_dims(jax_model, args, port_model):
    """{port name: torch dim} of every tensor avtex's param_shardings
    splits, its flax dim mapped through convert's layout change."""
    from avtex.parallel import param_shardings as jax_param_shardings
    from avtex_torch.convert import _torch_key
    shapes = jax.eval_shape(jax_model.init, jax.random.key(0), *args)
    mesh = jax_make_mesh((4, 2))
    flat = jax.tree_util.tree_flatten_with_path(
        jax_param_shardings(shapes, mesh))[0]
    out = {}
    for path, sharding in flat:
        spec = tuple(sharding.spec)
        if "model" not in spec:
            continue
        keys = tuple(p.key for p in path)[1:]  # drop "params"
        ndim = len(spec)
        # distinct sizes show where each flax dim lands in torch's layout
        probe = np.zeros((2, 3, 5, 7)[:ndim], np.float32)
        name, arr = _torch_key(keys, probe)
        out[name] = arr.shape.index(probe.shape[spec.index("model")])
    assert set(out) <= set(port_model.state_dict())
    return out


@pytest.mark.parametrize("which", ["m2", "video_for_audio"])
def test_param_shardings_split_what_avtex_splits(which):
    from avtex.contrastive.audio_retrieval import VideoForAudio as JaxVFA
    from avtex_torch.contrastive.audio_retrieval import VideoForAudio
    from avtex_torch.parallel import make_mesh, param_shardings, shutdown
    with torch.device("meta"):
        if which == "m2":
            port = ContrastiveTextures("resnet10", 2)
            q = jnp.zeros((1, 2, 16, 16, 3))
            args = (q, q[:, None], jnp.zeros((1, 100, 64)),
                    jnp.zeros((1, 1, 100, 64)))
            jax_model = JaxCT(arch="resnet10", model_type=2)
        else:
            port = VideoForAudio("resnet10")
            args = (jnp.zeros((1, 100, 64)), jnp.zeros((1, 1, 2, 16, 16, 3)))
            jax_model = JaxVFA(arch="resnet10")
    want = _avtex_split_dims(jax_model, args, port)
    mesh = make_mesh(device="cpu")
    try:
        got = param_shardings(port.state_dict(), mesh)
    finally:
        shutdown()
    assert {k: v for k, v in got.items() if v is not None} == want
    expected = {"m2": 3, "video_for_audio": 6}[which]
    assert len(want) == expected
    if which == "m2":
        assert want == {"audio_encoder.Conv_4.weight": 0,
                        "audio_encoder.Conv_4.bias": 0,
                        "audio_encoder.Conv_5.weight": 1}
    else:
        assert want["audio_mlp.Dense_0.weight"] == 0
        assert want["audio_mlp.Dense_1.weight"] == 1


@pytest.mark.parametrize("key,model", [("round trip (2, 2)", 2),
                                       ("round trip (1, 4)", 4)])
def test_shard_and_gather_params(worlds, setup, key, model):
    full = setup["m2"][1]
    for r in worlds[4][key]:
        assert r["round_trip"]
        split = {k: d for k, d in r["dims"].items() if d is not None}
        assert set(split) == {"audio_encoder.Conv_4.weight",
                              "audio_encoder.Conv_4.bias",
                              "audio_encoder.Conv_5.weight"}
        for name, shape in r["local_shapes"].items():
            want = list(full[name].shape)
            if name in split:
                want[split[name]] //= model
            assert list(shape) == want, name


# ------------------------------------------------------------------ #
# The segment-sharded embed
# ------------------------------------------------------------------ #

@pytest.fixture(scope="module")
def avtex_tables(setup, jax_mesh):
    from avtex.parallel import (sharded_embed_from_video,
                                sharded_embed_segments)
    out = {}
    out["resnet"] = np.asarray(sharded_embed_segments(
        _avtex_model(RESNET), setup["resnet"][0], jax_mesh,
        setup["windows"], tower="target", img_size=16))
    out["slowfast"] = np.asarray(sharded_embed_from_video(
        _avtex_model(SLOWFAST), setup["slowfast"][0], jax_mesh,
        setup["sf_video"], 4, 2, 9, tower="query", img_size=32))
    out["m2"] = np.asarray(sharded_embed_from_video(
        _avtex_model(M2), setup["m2"][0], jax_make_mesh((4, 2)),
        setup["m2_video"], 4, 2, 9, setup["audio"], tower="target",
        img_size=16))
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("which", ["resnet", "slowfast"])
def test_sharded_embed_matches_avtex(worlds, avtex_tables, world, which):
    want = avtex_tables[which]
    assert want.shape == ((11, 512) if which == "resnet" else (9, 288))
    for table in worlds[world][which]:
        assert table.shape == want.shape
        np.testing.assert_allclose(table, want, rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(table, worlds[world][which][0])


@pytest.mark.parametrize("key", ["m2 (2, 2)", "m2 (1, 4)"])
def test_tensor_parallel_m2_table_matches_avtex(worlds, avtex_tables, key):
    want = avtex_tables["m2"]
    assert want.shape == (9, 512 + 12288)
    for table in worlds[4][key]:
        np.testing.assert_allclose(table, want, rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def vfa_rows(setup):
    from torch_dist_worker import video_for_audio
    return video_for_audio(None, setup["audio"])


@pytest.mark.parametrize("key", ["vfa (2, 2)", "vfa (1, 4)"])
def test_tensor_parallel_audio_mlp_matches_the_unsharded_one(worlds,
                                                             vfa_rows, key):
    """VideoForAudio's audio rows through the column/row-split VGGish
    and AudioMLP (12288 x 4096, 4096 x 4096) equal the unsharded
    module's within fp32 rounding of the reduce's order."""
    want = vfa_rows
    assert want.shape == (7, 128)
    for rows in worlds[4][key]:
        np.testing.assert_allclose(rows, want, rtol=1e-5, atol=1e-6)


def test_world_of_one_equals_the_unsharded_tables(setup):
    """At world size 1 the sharded embed runs the unsharded batch plan:
    the tables are bit-identical to precompute_embeddings_from_video's."""
    from avtex_torch.parallel import (make_mesh, sharded_embed_from_video,
                                      shutdown)
    from avtex_torch.synth.embeddings import precompute_embeddings_from_video
    from torch_dist_worker import _model
    model = _model(_port_kw(M2), setup["m2"][1])
    args = (setup["m2_video"], 4, 2, 9, setup["audio"])
    q, t = precompute_embeddings_from_video(model, *args, img_size=16,
                                            batch_size=4)
    mesh = make_mesh(device="cpu")
    try:
        for tower, want in (("query", q), ("target", t)):
            got = sharded_embed_from_video(model, mesh, *args, tower=tower,
                                           img_size=16, batch_size=4)
            assert torch.equal(got, want)
    finally:
        shutdown()


# ------------------------------------------------------------------ #
# Pre-gathered windows, the server, PNG frames
# ------------------------------------------------------------------ #

@pytest.fixture(scope="module")
def windows_case(setup):
    """Nine pre-gathered windows, seven audio examples (ids clipped) and
    avtex's (Q, T) tables over them at batch 4."""
    from avtex.synth.embeddings import precompute_embeddings as jax_pre
    g = np.random.default_rng(1)
    windows = (g.random((9, 4, 16, 16, 3)) * 255).astype(np.uint8)
    q, t = jax_pre(_avtex_model(M2), setup["m2"][0], windows,
                   setup["audio"], img_size=16, batch_size=4)
    return windows, np.asarray(q), np.asarray(t)


@pytest.mark.parametrize("batch_size", [4, 16])
def test_embed_segments_and_precompute_match_avtex(setup, windows_case,
                                                   batch_size):
    from avtex_torch.synth import embed_segments, precompute_embeddings
    from torch_dist_worker import _model
    windows, want_q, want_t = windows_case
    model = _model(_port_kw(M2), setup["m2"][1])
    kw = dict(img_size=16, batch_size=batch_size)
    got_t = embed_segments(model, windows, setup["audio"], tower="target",
                           **kw)
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=TOL, atol=TOL)
    got_q, got_t2 = precompute_embeddings(model, windows, setup["audio"],
                                          **kw)
    np.testing.assert_allclose(got_q.numpy(), want_q, rtol=TOL, atol=TOL)
    assert torch.equal(got_t2, got_t)


def test_server_with_a_one_process_mesh_serves_the_same(setup):
    from avtex_torch.config import Config
    from avtex_torch.parallel import make_mesh, shutdown
    from avtex_torch.synth import TextureServer
    from avtex_torch.synth.pipeline import synthesize_frames
    frames = setup["m2_video"]
    sd = {k: torch.from_numpy(v) for k, v in setup["resnet"][1].items()}
    cfg = Config(enc_arch="resnet10", img_size=16, window=4, stride=2,
                 mini_batchsize=4, new_video_length=1, compute_dtype="float32",
                 interpolation=False)
    plain = TextureServer.from_frames(cfg, frames, 8.0, sd, device="cpu")
    mesh = make_mesh(device="cpu")
    try:
        sharded = TextureServer.from_frames(cfg, frames, 8.0, sd,
                                            device="cpu", mesh=mesh)
        assert torch.equal(sharded.q_table, plain.q_table)
        assert torch.equal(sharded.t_table, plain.t_table)
        a = sharded.synthesize(seconds=2, seed=3)
        b = plain.synthesize(seconds=2, seed=3)
        np.testing.assert_array_equal(a["result"].indices,
                                      b["result"].indices)
        np.testing.assert_array_equal(a["frames"], b["frames"])
        out = synthesize_frames(cfg, frames, 8.0, sd, device="cpu",
                                mesh=mesh)
        np.testing.assert_array_equal(out["result"].indices,
                                      synthesize_frames(
                                          cfg, frames, 8.0, sd,
                                          device="cpu")["result"].indices)
    finally:
        shutdown()


def test_write_frames_png_matches_avtex(tmp_path):
    from avtex.media.video import write_frames_png as jax_write
    from avtex_torch.media import write_frames_png
    g = np.random.default_rng(2)
    frames = (g.random((3, 12, 10, 3)) * 255).astype(np.uint8)
    assert write_frames_png(frames, str(tmp_path / "port"), 5) == \
        str(tmp_path / "port")
    jax_write(frames, str(tmp_path / "avtex"), 5)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "avtex")) == [
        "000005.png", "000006.png", "000007.png"]
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "avtex" / n).read_bytes()
