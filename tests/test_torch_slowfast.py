"""SlowFast-R50 in the port (avtex_torch/nn/slowfast.py) against avtex's
flax SlowFastR50, with parameters carried over by avtex_torch.convert.

Small size (width 8, layers (2,1,1,1), 32 px, fp32, one CPU thread); the
same numpy inputs go through both. Tolerance rtol/atol 1e-4: the two
frameworks sum convolutions in different orders in fp32."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avtex.contrastive.model import ContrastiveTextures as JaxCT
from avtex.nn import encoders as jax_encoders
from avtex.nn.slowfast import SlowFastR50 as JaxSF
from avtex.nn.slowfast import slowfast_pathways as jax_pathways
from avtex_torch.contrastive.model import ContrastiveTextures
from avtex_torch.convert import convert_params
from avtex_torch.nn import slowfast as port_slowfast
from avtex_torch.nn.slowfast import SlowFastR50, slowfast_pathways

torch.set_num_threads(1)

SMALL = dict(width=8, layers=(2, 1, 1, 1))


def _small_jax_slowfast(dtype=None, norm="group", remat=False):
    return JaxSF(**SMALL, dtype=jnp.float32, norm=norm, remat=remat)


def _inputs(seed=0):
    g = np.random.default_rng(seed)
    return (g.standard_normal((2, 8, 32, 32, 3)).astype(np.float32),
            g.standard_normal((2, 32, 32, 32, 3)).astype(np.float32))


def _perturbed_norms(tree, seed=1):
    """Move norm scale/bias off ones/zeros so they are exercised."""
    g = np.random.default_rng(seed)

    def f(path, v):
        v = np.asarray(v)
        if path[-1].key in ("scale", "bias"):
            v = v + 0.1 * g.standard_normal(v.shape).astype(v.dtype)
        return v
    return jax.tree_util.tree_map_with_path(f, tree)


@functools.lru_cache(maxsize=None)
def _jax_run(norm, s2d, fuse):
    """(numpy params tree, output) of avtex's encoder, cached per config."""
    slow, fast = _inputs()
    m = JaxSF(**SMALL, dtype=jnp.float32, norm=norm, s2d_stem=s2d, fuse=fuse)
    p = _perturbed_norms(m.init(jax.random.key(0), slow, fast))
    return p, np.asarray(jax.jit(m.apply)(p, slow, fast))


def _port_encoder(tree, **kw):
    enc = SlowFastR50(**SMALL, dtype=torch.float32, **kw)
    holder = torch.nn.Module()
    holder.add_module("enc", enc)
    holder.load_state_dict(convert_params({"enc": tree["params"]}, holder))
    return enc


@pytest.mark.parametrize("s2d", [True, False])
@pytest.mark.parametrize("fuse,kernel_min_channels", [
    (False, 128), ("all", 0), ("all", 64), ("all", 128)])
def test_affine_encoder_matches_avtex(monkeypatch, s2d, fuse,
                                      kernel_min_channels):
    # 0 sends every fused 1x1 conv of the narrow test model down the
    # kernel's path (its plain version on the CPU); 64 is the port's rule,
    # which at width 8 sends the res5 convs there.
    monkeypatch.setattr(port_slowfast, "KERNEL_MIN_CHANNELS",
                        kernel_min_channels)
    tree, want = _jax_run("affine", s2d, fuse)
    enc = _port_encoder(tree, norm="affine", fuse=fuse)
    slow, fast = _inputs()
    with torch.no_grad():
        got = enc(torch.from_numpy(slow), torch.from_numpy(fast))
    assert got.dtype == torch.float32 and got.shape == (2, enc.feat_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_conv3_only_fusion_matches_avtex(monkeypatch):
    monkeypatch.setattr(port_slowfast, "KERNEL_MIN_CHANNELS", 0)
    tree, want = _jax_run("affine", False, "conv3")
    enc = _port_encoder(tree, norm="affine", fuse="conv3")
    slow, fast = _inputs()
    with torch.no_grad():
        got = enc(torch.from_numpy(slow), torch.from_numpy(fast))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_group_norm_encoder_matches_avtex():
    tree, want = _jax_run("group", True, False)
    enc = _port_encoder(tree, norm="group")
    slow, fast = _inputs()
    with torch.no_grad():
        got = enc(torch.from_numpy(slow), torch.from_numpy(fast))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_full_width_feature_dim_and_kernel_eligible_convs(monkeypatch):
    """SlowFast-R50 at width 64 sends 32 1x1 convs per tower forward to
    the kernel under the port's K, N >= 64 rule, 21 under avtex's >= 128
    (counted from the module tree; no forward pass)."""
    enc = SlowFastR50(norm="affine", dtype=torch.float32)
    assert enc.feat_dim == 2304
    assert port_slowfast.KERNEL_MIN_CHANNELS == 64

    def eligible():
        n = 0
        for name, blk in enc.named_children():
            if not name.startswith("SFBottleneck_"):
                continue
            n += blk.t_kernel == 1 and blk.kernel_eligible(0)
            n += blk.need_proj and blk.kernel_eligible(3)
            n += blk.kernel_eligible(2)
        return n

    assert eligible() == 32
    monkeypatch.setattr(port_slowfast, "KERNEL_MIN_CHANNELS", 128)
    assert eligible() == 21


@pytest.mark.parametrize("t", [15, 20, 32])
def test_slowfast_pathways_exact(t):
    frames = np.random.default_rng(t).standard_normal(
        (2, t, 4, 4, 3)).astype(np.float32)
    js, jf = jax_pathways(jnp.asarray(frames))
    ts, tf = slowfast_pathways(torch.from_numpy(frames))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def _contrastive_tree(monkeypatch, norm):
    monkeypatch.setitem(jax_encoders.ENCODER_REGISTRY, "slowfast",
                        (_small_jax_slowfast, "slowfast"))
    slow, fast = _inputs()
    model = JaxCT(arch="slowfast", norm=norm)
    shapes = jax.eval_shape(model.init, jax.random.key(0), (slow, fast),
                            (slow[:, None], fast[:, None]))
    g = np.random.default_rng(0)
    return jax.tree.map(
        lambda s: g.standard_normal(s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("norm", ["affine", "group"])
def test_converter_round_trip_shapes(monkeypatch, norm):
    tree = _contrastive_tree(monkeypatch, norm)
    port = ContrastiveTextures(arch="slowfast", norm=norm,
                               dtype=torch.float32, **SMALL)
    sd = convert_params(tree, port)
    port.load_state_dict(sd)  # strict: every key present, none extra
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == len(sd)
    k = tree["params"]["q_embedder"]["video_encoder"]["SFBottleneck_0"][
        "Conv_1"]["kernel"]
    got = sd["q_embedder.video_encoder.SFBottleneck_0.Conv_1.weight"]
    np.testing.assert_array_equal(got.numpy(), k.transpose(4, 3, 0, 1, 2))
    # The towers keep separate parameters.
    assert not torch.equal(
        sd["q_embedder.video_encoder.Conv_0.weight"],
        sd["t_embedder.video_encoder.Conv_0.weight"])


def test_converter_rejects_unknown_missing_and_misshapen(monkeypatch):
    tree = _contrastive_tree(monkeypatch, "affine")
    port = ContrastiveTextures(arch="slowfast", norm="affine",
                               dtype=torch.float32, **SMALL)
    enc = tree["params"]["q_embedder"]["video_encoder"]

    extra = jax.tree.map(lambda v: v, tree)
    extra["params"]["q_embedder"]["video_encoder"]["Dense_0"] = {
        "kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="Dense_0"):
        convert_params(extra, port)

    missing = jax.tree.map(lambda v: v, tree)
    del missing["params"]["t_embedder"]["video_encoder"]["Affine_5"]
    with pytest.raises(KeyError, match="Affine_5"):
        convert_params(missing, port)

    bad = jax.tree.map(lambda v: v, tree)
    bad["params"]["q_embedder"]["video_encoder"]["Affine_0"]["scale"] = (
        np.zeros(enc["Affine_0"]["scale"].shape[0] + 1, np.float32))
    with pytest.raises(ValueError, match="Affine_0"):
        convert_params(bad, port)
