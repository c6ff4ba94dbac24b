"""3D ResNets in the port (avtex_torch/nn/resnet3d.py) against avtex's
flax ResNet3D (avtex/nn/resnet3d.py), parameters carried over by
avtex_torch.convert; and their place in the encoder registry.

Width 8, 48 px, 8 frames, fp32, one CPU thread; the same numpy inputs
through both. Norm scales and biases are moved off ones/zeros. Tolerance
rtol/atol 1e-4 (convs summed in other orders). Not 32 px: there the last
stage's GroupNorm normalises groups of two values (1x1x1 positions, two
channels), and avtex's own fp32 resnet18 output lies 5e-4 from a
float64 run of the same weights."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avtex.nn import encoders as jax_encoders
from avtex.nn import resnet3d as jax_resnet3d
from avtex_torch.convert import convert_params
from avtex_torch.nn import encoders, resnet3d
from test_torch_slowfast import _perturbed_norms

torch.set_num_threads(1)

ARCHS = {"resnet10": (jax_resnet3d.resnet3d10, resnet3d.resnet3d10, {}),
         "resnet18": (jax_resnet3d.resnet3d18, resnet3d.resnet3d18, {}),
         # Bottleneck3D, cut to one block a stage
         "resnet50": (jax_resnet3d.resnet3d50, resnet3d.resnet3d50,
                      {"layers": (1, 1, 1, 1)})}


def _clips(seed=0):
    return np.random.default_rng(seed).standard_normal(
        (2, 8, 48, 48, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _avtex(arch, norm):
    jax_factory, _, kw = ARCHS[arch]
    m = jax_factory(width=8, dtype=jnp.float32, norm=norm, **kw)
    x = _clips()
    tree = _perturbed_norms(jax.jit(m.init)(jax.random.key(0), x))
    return tree, np.asarray(jax.jit(m.apply)(tree, x))


@pytest.mark.parametrize("norm", ["group", "affine"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_resnet3d_matches_avtex(arch, norm):
    tree, want = _avtex(arch, norm)
    _, factory, kw = ARCHS[arch]
    enc = factory(width=8, dtype=torch.float32, norm=norm, **kw)
    holder = torch.nn.Module()
    holder.add_module("enc", enc)
    holder.load_state_dict(convert_params({"enc": tree["params"]}, holder))
    with torch.no_grad():
        got = enc.eval()(torch.from_numpy(_clips()))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["resnet10", "resnet18", "resnet34",
                                  "resnet50"])
def test_registry_builds_what_avtex_builds(arch):
    module, dim, kind = encoders.build_encoder(arch, dtype=torch.float32)
    jax_module, jax_dim, jax_kind = jax_encoders.build_encoder(arch)
    assert (dim, kind) == (jax_dim, jax_kind) == (module.feat_dim, "clip")
    assert arch in encoders.ENCODER_REGISTRY
    n_blocks = sum(jax_module.layers)
    assert module.n_blocks == n_blocks
    assert module.Conv_0.weight.dtype == torch.float32
    bf16, _, _ = encoders.build_encoder(arch)
    assert bf16.Conv_0.weight.dtype == torch.bfloat16


def test_bf16_resnet_runs_and_keeps_norms_fp32():
    enc = resnet3d.resnet3d18(width=8, norm="affine")
    assert enc.Affine_0.scale.dtype == torch.float32
    with torch.no_grad():
        y = enc(torch.from_numpy(_clips()))
    assert y.dtype == torch.float32 and y.shape == (2, 64)
    assert torch.isfinite(y).all()
