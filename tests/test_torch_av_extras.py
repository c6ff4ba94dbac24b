"""AudioVisualFeatures and ClassicTemporal in the port against avtex, and
the parameter plumbing they need, on the same seeded numpy inputs and
parameters (drawn with numpy for avtex's tree, carried over by
``avtex_torch.convert``), fp32 on both sides.

- ``AudioVisualFeatures`` (flax ``SAME`` convs at stride 2 and ``SAME``
  max pools, written out as pads in the port) within 1e-5, on odd and
  even frame sizes and on a waveform short enough that the pools pad;
- ``ClassicTemporal`` for ResNet10 (width 8, 64 px) and SlowFast's
  ``(slow, fast)`` tuples (width 8, 32 px), and
  ``classic_temporal_distances``,
  within 1e-5, the appended query column exactly 0;
- ``convert_params`` / ``export_params`` carry flax ``Dense`` and 1-D conv
  kernels both ways (VideoForAudio's and AudioVisualFeatures' trees
  round-trip exactly);
- ``flax_style_init`` gives every existing model exactly what it gave
  before ``Linear`` and ``Conv1d`` were handled (a frozen copy of that
  version below), draws flax's ``lecun_normal`` for ``Linear`` and
  ``Conv1d`` weights, zeros their biases, and raises for other shapes.
"""

import functools
import math

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from avtex.contrastive import av_features as jax_avf
from avtex.contrastive import classic_temporal as jax_ct
from avtex.nn import encoders as jax_encoders
from avtex.nn import resnet3d as jax_resnet3d
from avtex.nn.slowfast import SlowFastR50 as JaxSF
from avtex_torch.contrastive.av_features import AudioVisualFeatures
from avtex_torch.contrastive.classic_temporal import (
    ClassicTemporal, classic_temporal_distances)
from avtex_torch.contrastive.model import ContrastiveTextures
from avtex_torch.convert import convert_params, export_params
from avtex_torch.nn.encoders import build_encoder
from avtex_torch.nn.vggish import VGGish
from avtex_torch.synth.pipeline import flax_style_init

torch.set_num_threads(1)

SMALL_SF = dict(width=8, layers=(2, 1, 1, 1))


def _draw(shapes, seed=0):
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


# --------------------------------------------------------------------- #
# AudioVisualFeatures
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def avf():
    jmodel = jax_avf.AudioVisualFeatures(dtype=jnp.float32)
    jparams = _draw(jax.eval_shape(jmodel.init, jax.random.key(0),
                                   jnp.zeros((1, 4, 32, 32, 3)),
                                   jnp.zeros((1, 1000))))
    model = AudioVisualFeatures(dtype=torch.float32)
    model.load_state_dict(convert_params(jparams, model))
    return jmodel, jparams, model


@pytest.mark.parametrize("t,h,w,samples", [(4, 32, 32, 1000),
                                           (5, 33, 30, 22050),
                                           (3, 17, 40, 100)])
def test_audio_visual_features_match(avf, t, h, w, samples):
    jmodel, jparams, model = avf
    g = np.random.default_rng(t * h)
    clip = g.standard_normal((2, t, h, w, 3)).astype(np.float32)
    wav = (0.3 * g.standard_normal((2, samples))).astype(np.float32)
    want = jmodel.apply(jparams, jnp.asarray(clip), jnp.asarray(wav))
    with torch.no_grad():
        got = model(torch.from_numpy(clip), torch.from_numpy(wav))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 128)
    np.testing.assert_allclose(
        torch.linalg.vector_norm(got, dim=-1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_audio_visual_features_towers_match(avf):
    jmodel, jparams, model = avf
    g = np.random.default_rng(9)
    clip = g.standard_normal((1, 4, 31, 32, 3)).astype(np.float32)
    wav = (0.3 * g.standard_normal((1, 700))).astype(np.float32)
    p = jparams["params"]
    want_v = jax_avf.VideoTower3D(jnp.float32).apply(
        {"params": p["VideoTower3D_0"]}, jnp.asarray(clip))
    want_a = jax_avf.AudioTower1D(jnp.float32).apply(
        {"params": p["AudioTower1D_0"]}, jnp.asarray(wav))
    with torch.no_grad():
        got_v = model.VideoTower3D_0(torch.from_numpy(clip))
        got_a = model.AudioTower1D_0(torch.from_numpy(wav))
    assert tuple(got_v.shape) == (1, 256, 4, 2, 2)
    np.testing.assert_allclose(got_v.permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(want_v), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------------- #
# ClassicTemporal
# --------------------------------------------------------------------- #

def test_classic_temporal_distances_match():
    g = np.random.default_rng(1)
    q = g.standard_normal((3, 16)).astype(np.float32)
    t = g.standard_normal((3, 5, 16)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    t[0, 2] = q[0]  # a target equal to its query: distance 0, not NaN
    want = jax_ct.classic_temporal_distances(jnp.asarray(q), jnp.asarray(t))
    got = classic_temporal_distances(torch.from_numpy(q),
                                     torch.from_numpy(t))
    assert tuple(got.shape) == (3, 6) and torch.isfinite(got).all()
    assert bool((got[:, -1] == 0).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def _clips(g, shape, slowfast):
    from avtex.data.preprocess import preprocess_clip as jpre
    from avtex.nn.slowfast import slowfast_pathways as jpath
    from avtex_torch.data.preprocess import preprocess_clip
    from avtex_torch.nn.slowfast import slowfast_pathways
    u8 = g.integers(0, 256, shape).astype(np.uint8)
    size = shape[-2]
    jx = jpre(jnp.asarray(u8), size=size, slowfast=slowfast)
    x = preprocess_clip(torch.from_numpy(u8), size, slowfast)
    if slowfast:
        return jpath(jx), slowfast_pathways(x)
    return jx, x


@pytest.mark.parametrize("arch", ["resnet10", "slowfast"])
def test_classic_temporal_matches(monkeypatch, arch):
    slowfast = arch == "slowfast"
    if slowfast:
        monkeypatch.setitem(jax_encoders.ENCODER_REGISTRY, "slowfast", (
            lambda dtype=None, norm="group", remat=False: JaxSF(
                **SMALL_SF, dtype=jnp.float32, norm=norm, remat=remat),
            "slowfast"))
        port_kw = SMALL_SF
    else:
        monkeypatch.setitem(jax_encoders.ENCODER_REGISTRY, "resnet10", (
            functools.partial(jax_resnet3d.resnet3d10, width=8), "clip"))
        port_kw = dict(width=8)
    g = np.random.default_rng(2)
    # ResNet10 at 64 px: at 32 px its res5 is one voxel, and GroupNorm
    # over two-value groups leaves the fp32 forward ill-posed
    b, n, window, size = 2, 2, 8, 32 if slowfast else 64
    jq, q = _clips(g, (b, window, size, size, 3), slowfast)
    jt, t = _clips(g, (b, n, window, size, size, 3), slowfast)
    jmodel = jax_ct.ClassicTemporal(arch=arch, dtype=jnp.float32)
    jparams = _draw(jax.eval_shape(jmodel.init, jax.random.key(0), jq, jt))
    model = ClassicTemporal(arch=arch, dtype=torch.float32, **port_kw)
    model.load_state_dict(convert_params(jparams, model))
    want = jax.jit(jmodel.apply)(jparams, jq, jt)
    with torch.no_grad():
        got = model(q, t)
    assert tuple(got.shape) == (b, n + 1)
    assert bool((got[:, -1] == 0).all()) and bool((got[:, :-1] > 0).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_classic_temporal_shares_one_audio_encoder():
    vg = VGGish(torch.float32)
    model = ClassicTemporal(arch="resnet10", model_type=2, audio_encoder=vg,
                            dtype=torch.float32, width=8)
    keys = list(model.state_dict())
    assert sum(k.startswith("audio_encoder.") for k in keys) == 12
    assert not any(k.startswith("embedder.audio_encoder") for k in keys)
    assert model.embedder.audio_encoder is vg
    with pytest.raises(ValueError, match="requires an audio_encoder"):
        ClassicTemporal(arch="resnet10", model_type=2, width=8)


# --------------------------------------------------------------------- #
# convert: Dense and 1-D conv kernels both ways
# --------------------------------------------------------------------- #

def _assert_trees_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)


def test_convert_round_trips_dense_and_conv1d(avf):
    _, jparams, model = avf
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    state = convert_params(tree, model)
    w = tree["params"]["Dense_0"]["kernel"]
    assert tuple(state["Dense_0.weight"].shape) == (w.shape[1], w.shape[0])
    k = tree["params"]["AudioTower1D_0"]["Conv_0"]["kernel"]   # [k, in, out]
    np.testing.assert_array_equal(
        state["AudioTower1D_0.Conv_0.weight"].numpy(), k.transpose(2, 1, 0))
    _assert_trees_equal(export_params(state), tree)


def test_convert_round_trips_video_for_audio():
    import avtex.contrastive.audio_retrieval as jax_ar
    from avtex_torch.contrastive.audio_retrieval import VideoForAudio
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_encoders.ENCODER_REGISTRY, "resnet10", (
            functools.partial(jax_resnet3d.resnet3d10, width=8), "clip"))
        shapes = jax.eval_shape(
            jax_ar.VideoForAudio(arch="resnet10").init, jax.random.key(0),
            jnp.zeros((1, 100, 64)), jnp.zeros((1, 1, 4, 32, 32, 3)))
    tree = jax.tree_util.tree_map(
        lambda s: np.arange(np.prod(s.shape), dtype=np.float32).reshape(
            s.shape) % 7, shapes)
    model = VideoForAudio(arch="resnet10", dtype=torch.float32, width=8)
    state = convert_params(tree, model)
    assert set(state) == set(model.state_dict())
    _assert_trees_equal(export_params(state), tree)


# --------------------------------------------------------------------- #
# flax_style_init
# --------------------------------------------------------------------- #

def _frozen_init(model, seed):
    """flax_style_init as it was before Linear and Conv1d were handled."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for key, value in model.state_dict().items():
        leaf = key.rsplit(".", 1)[-1]
        if value.ndim in (4, 5):
            fan_in = math.prod(value.shape[1:])
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            t = torch.empty(value.shape, dtype=torch.float32)
            torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                        generator=g)
        elif leaf in ("scale", "weight"):
            t = torch.ones(value.shape)
        elif leaf == "bias":
            t = torch.zeros(value.shape)
        else:
            raise KeyError(f"no initialiser for parameter {key!r}")
        out[key] = t
    return out


EXISTING = [
    ("resnet10", dict(width=8), "group"),
    ("resnet50", dict(width=8), "affine"),
    ("resnext50", dict(width=16, groups=4, layers=(1, 1, 1, 1)), "group"),
    ("densenet121", dict(growth_rate=32, init_features=32,
                         block_config=(1, 1, 1, 2)), "affine"),
    ("slowfast", SMALL_SF, "affine"),
    ("slowfast", SMALL_SF, "group"),
    ("resnet18_2d", {}, "group"),
]


@pytest.mark.parametrize("arch,kw,norm", EXISTING)
def test_flax_style_init_unchanged_for_existing_models(arch, kw, norm):
    enc, _, _ = build_encoder(arch, dtype=torch.float32, norm=norm, **kw)
    models = [enc]
    if arch in ("resnet10", "slowfast"):
        models.append(ContrastiveTextures(arch, model_type=2, norm=norm,
                                          **kw))
    for model in models:
        new, old = flax_style_init(model, 7), _frozen_init(model, 7)
        assert list(new) == list(old)
        for k in old:
            assert torch.equal(new[k], old[k]), k


class _Head(nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv_0 = nn.Conv1d(6, 40, 25)
        self.GroupNorm_0 = nn.GroupNorm(8, 40)
        self.Dense_0 = nn.Linear(300, 500)


def test_flax_style_init_linear_and_conv1d():
    out = flax_style_init(_Head(), 3)
    for key, fan_in in (("Conv_0.weight", 6 * 25), ("Dense_0.weight", 300)):
        w = out[key].double()
        std = math.sqrt(1.0 / fan_in)  # lecun_normal's, after the cut
        assert abs(float(w.std()) / std - 1) < 0.02, key
        assert abs(float(w.mean())) < 0.02 * std
        assert float(w.abs().max()) <= 2 * std / 0.87962566103423978
    for key in ("Conv_0.bias", "Dense_0.bias", "GroupNorm_0.bias"):
        assert not out[key].any()
    assert bool((out["GroupNorm_0.weight"] == 1).all())
    # drawn in state_dict order: the Linear's draws follow the conv's
    again = flax_style_init(_Head(), 3)
    assert all(torch.equal(out[k], again[k]) for k in out)


def test_flax_style_init_refuses_other_shapes():
    odd = nn.Module()
    odd.scale = nn.Parameter(torch.ones(3, 4))
    with pytest.raises(KeyError, match="no initialiser"):
        flax_style_init(odd, 0)
    odd = nn.Module()
    odd.weight = nn.Parameter(torch.ones(()))
    with pytest.raises(KeyError, match="no initialiser"):
        flax_style_init(odd, 0)
