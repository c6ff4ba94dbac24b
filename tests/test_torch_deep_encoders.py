"""avtex's three deeper constructors in the port: ``resnet2d34``
(avtex_torch/nn/resnet2d.py), ``densenet3d201`` and ``densenet3d264``
(avtex_torch/nn/densenet3d.py), against avtex's at their own depths,
parameters carried over by avtex_torch.convert.

fp32 on both sides, one CPU thread, the same numpy inputs; parameters
drawn in numpy on avtex's shapes (norm scales and biases off ones and
zeros); tolerance rtol/atol 1e-4 (convs summed in other orders). Small
widths: ResNet2D-34 at width 16 on 48 px images, in both norms; the
DenseNets at growth 8 from 16 channels on one clip of 16 frames of 32 px
(their three transitions halve T after the pool, so T >= 15), folded-BN
norm (``"affine"``: GroupNorm's 32 groups want channel counts that
growth 8 does not give; the norm is the one tests/test_torch_encoders.py
holds at depth 121). Neither package registers them as ``-ea`` names.
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
from avtex_torch.convert import convert_params, export_params
from avtex_torch.nn import densenet3d, encoders, resnet2d

torch.set_num_threads(1)

DENSE_KW = {"growth_rate": 8, "init_features": 16}
# name -> (avtex factory, port factory, kwargs, input shape)
ARCHS = {
    "resnet2d34": (jax_resnet2d.resnet2d34, resnet2d.resnet2d34,
                   {"width": 16}, (2, 48, 48, 3)),
    "densenet3d201": (jax_densenet3d.densenet3d201, densenet3d.densenet3d201,
                      DENSE_KW, (1, 16, 32, 32, 3)),
    "densenet3d264": (jax_densenet3d.densenet3d264, densenet3d.densenet3d264,
                      DENSE_KW, (1, 16, 32, 32, 3)),
}


def _inputs(shape):
    return np.random.default_rng(0).standard_normal(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _avtex(arch, norm):
    jax_factory, _, kw, shape = ARCHS[arch]
    m = jax_factory(dtype=jnp.float32, norm=norm, **kw)
    x = _inputs(shape)
    shapes = jax.eval_shape(m.init, jax.random.key(0), x)
    g = np.random.default_rng(1)

    def draw(path, s):
        if path[-1].key in ("scale", "bias"):
            return (float(path[-1].key == "scale")
                    + 0.1 * g.standard_normal(s.shape)).astype(np.float32)
        return (g.standard_normal(s.shape)
                / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return tree, np.asarray(jax.jit(m.apply)(tree, x))


@pytest.mark.parametrize("arch, norm", [
    ("resnet2d34", "affine"), ("resnet2d34", "group"),
    ("densenet3d201", "affine"), ("densenet3d264", "affine")])
def test_deep_constructor_matches_avtex(arch, norm):
    jax_factory, factory, kw, shape = ARCHS[arch]
    tree, want = _avtex(arch, norm)
    enc = factory(dtype=torch.float32, norm=norm, **kw)
    holder = torch.nn.Module()
    holder.add_module("enc", enc)
    holder.load_state_dict(convert_params({"enc": tree["params"]}, holder))
    with torch.no_grad():
        got = enc.eval()(torch.from_numpy(_inputs(shape)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    if arch == "densenet3d264" or norm == "group":  # back to avtex's tree
        back = export_params(enc.state_dict())["params"]
        flat = jax.tree_util.tree_flatten_with_path
        got_leaves = {jax.tree_util.keystr(k): v for k, v in flat(back)[0]}
        want_leaves = {jax.tree_util.keystr(k): v
                       for k, v in flat(tree["params"])[0]}
        assert got_leaves.keys() == want_leaves.keys()
        for k, v in want_leaves.items():
            np.testing.assert_array_equal(got_leaves[k], np.asarray(v))


def test_depths_and_widths_are_avtex():
    for name in ("densenet3d121", "densenet3d169", "densenet3d201",
                 "densenet3d264"):
        assert (getattr(densenet3d, name).keywords["block_config"]
                == getattr(jax_densenet3d, name).keywords["block_config"])
        assert (getattr(densenet3d, name)().feat_dim
                == getattr(jax_densenet3d, name)().feat_dim)
    for name in ("resnet2d18", "resnet2d34"):
        assert (getattr(resnet2d, name).keywords["layers"]
                == getattr(jax_resnet2d, name).keywords["layers"])
    # avtex registers neither; nor does the port
    for name in ("densenet201", "densenet264", "resnet2d34"):
        assert name not in jax_encoders.ENCODER_REGISTRY
        assert name not in encoders.ENCODER_REGISTRY
