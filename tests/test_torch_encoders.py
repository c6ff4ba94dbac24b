"""The remaining encoders in the port (avtex_torch/nn/{resnext3d,densenet3d,
resnet2d}.py) against avtex's flax modules, parameters carried over by
avtex_torch.convert; and the full registry against avtex's.

fp32 on both sides, one CPU thread, the same numpy clips; norm scales and
biases moved off ones/zeros; tolerance rtol/atol 1e-4 (convs summed in
other orders). Sizes keep every GroupNorm group above two values:
ResNeXt at width 16 in 4 groups and 48 px; DenseNet at growth 32 from 32
channels over blocks (1, 1, 1, 2), 16 frames of 64 px (its three
transitions halve T after the pool, so T >= 15); the 2D ResNets at full
width on 4 frames of 48 px.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avtex.nn import densenet3d as jax_densenet3d
from avtex.nn import encoders as jax_encoders
from avtex.nn import resnet2d as jax_resnet2d
from avtex.nn import resnext3d as jax_resnext3d
from avtex_torch.convert import convert_params, export_params
from avtex_torch.nn import densenet3d, encoders, resnet2d, resnext3d
from test_torch_slowfast import _perturbed_norms

torch.set_num_threads(1)

# name -> (avtex factory, port factory, kwargs, clip shape)
ARCHS = {
    "resnext50": (jax_resnext3d.resnext3d50, resnext3d.resnext3d50,
                  {"width": 16, "groups": 4, "layers": (1, 1, 1, 1)},
                  (2, 8, 48, 48, 3)),
    "resnext101": (jax_resnext3d.resnext3d101, resnext3d.resnext3d101,
                   {"width": 16, "groups": 4, "layers": (1, 2, 1, 1)},
                   (2, 8, 48, 48, 3)),
    "densenet121": (jax_densenet3d.densenet3d121, densenet3d.densenet3d121,
                    {"growth_rate": 32, "init_features": 32,
                     "block_config": (1, 1, 1, 2)}, (2, 16, 64, 64, 3)),
    "resnet18_2d": (functools.partial(jax_resnet2d.FrameMean2D,
                                      layers=(2, 2, 2, 2)),
                    functools.partial(resnet2d.FrameMean2D,
                                      layers=(2, 2, 2, 2)),
                    {}, (2, 4, 48, 48, 3)),
    "resnet34_2d": (functools.partial(jax_resnet2d.FrameMean2D,
                                      layers=(3, 4, 6, 3)),
                    functools.partial(resnet2d.FrameMean2D,
                                      layers=(3, 4, 6, 3)),
                    {}, (1, 2, 48, 48, 3)),
}


def _clips(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _avtex(arch, norm):
    jax_factory, _, kw, shape = ARCHS[arch]
    m = jax_factory(dtype=jnp.float32, norm=norm, **kw)
    x = _clips(shape)
    tree = _perturbed_norms(jax.jit(m.init)(jax.random.key(0), x))
    return tree, np.asarray(jax.jit(m.apply)(tree, x)), m.feat_dim


def _port(arch, norm, tree):
    _, factory, kw, _ = ARCHS[arch]
    enc = factory(dtype=torch.float32, norm=norm, **kw)
    holder = torch.nn.Module()
    holder.add_module("enc", enc)
    holder.load_state_dict(convert_params({"enc": tree["params"]}, holder))
    return enc.eval()


@pytest.mark.parametrize("norm", ["group", "affine"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_encoder_matches_avtex(arch, norm):
    tree, want, feat_dim = _avtex(arch, norm)
    enc = _port(arch, norm, tree)
    with torch.no_grad():
        got = enc(torch.from_numpy(_clips(ARCHS[arch][3])))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert enc.feat_dim == feat_dim == want.shape[1]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["resnext50", "densenet121",
                                  "resnet18_2d"])
def test_parameters_round_trip_to_avtex_tree(arch):
    """export_params gives back avtex's tree (grouped kernels
    [kt, kh, kw, in/groups, out], 2D kernels HWIO) bit for bit."""
    tree, _, _ = _avtex(arch, "group")
    enc = _port(arch, "group", tree)
    back = export_params(enc.state_dict())["params"]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(tree["params"])[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert ({jax.tree_util.keystr(k) for k in flat_got}
            == {jax.tree_util.keystr(k) for k in flat_want})
    got = {jax.tree_util.keystr(k): v for k, v in flat_got.items()}
    for k, v in flat_want.items():
        np.testing.assert_array_equal(got[jax.tree_util.keystr(k)],
                                      np.asarray(v))


def test_resnet2d_matches_avtex_on_images():
    """ResNet2D (the classic features' net) on [B, H, W, 3] images."""
    x = _clips((3, 40, 40, 3), seed=2)
    m = jax_resnet2d.resnet2d18(dtype=jnp.float32, norm="affine")
    tree = _perturbed_norms(jax.jit(m.init)(jax.random.key(1), x))
    want = np.asarray(jax.jit(m.apply)(tree, x))
    enc = resnet2d.resnet2d18(dtype=torch.float32, norm="affine")
    holder = torch.nn.Module()
    holder.add_module("enc", enc)
    holder.load_state_dict(convert_params({"enc": tree["params"]}, holder))
    with torch.no_grad():
        got = enc.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("size,k,s", [(224, 7, 2), (112, 3, 2), (15, 3, 2),
                                      (15, 7, 1), (8, 3, 2), (7, 2, 2)])
def test_same_pads_are_flax_pads(size, k, s):
    """densenet3d's explicit pads equal flax's SAME padding."""
    from jax import lax
    want = lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0]
    assert densenet3d.same_pads(size, k, s) == tuple(want)


@pytest.mark.parametrize("arch", sorted(jax_encoders.ENCODER_REGISTRY))
def test_registry_matches_avtex(arch, capsys):
    """All twelve names build; feat_dim and input kind as avtex reports
    them; remat warns exactly where avtex warns."""
    module, dim, kind = encoders.build_encoder(arch, remat=True)
    port_warn = "does not support remat" in capsys.readouterr().err
    jax_module, jax_dim, jax_kind = jax_encoders.build_encoder(
        arch, remat=True)
    jax_warn = "does not support remat" in capsys.readouterr().err
    assert (dim, kind) == (jax_dim, jax_kind)
    assert module.feat_dim == dim
    assert port_warn == jax_warn
    assert sorted(encoders.ENCODER_REGISTRY) == sorted(
        jax_encoders.ENCODER_REGISTRY)


def test_bf16_encoders_keep_norms_fp32():
    for arch, kw in (("resnext50", {"width": 16, "groups": 4}),
                     ("densenet121", {"growth_rate": 32,
                                      "init_features": 32,
                                      "block_config": (1, 1, 1, 1)}),
                     ("resnet18_2d", {})):
        enc, _, _ = encoders.build_encoder(arch, norm="affine", **kw)
        norms = [p for n, p in enc.named_parameters()
                 if "Affine" in n]
        assert norms and all(p.dtype == torch.float32 for p in norms)
        with torch.no_grad():
            y = enc(torch.from_numpy(_clips((1, 16, 32, 32, 3))))
        assert y.dtype == torch.float32 and torch.isfinite(y).all()
