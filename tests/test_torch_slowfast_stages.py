"""``SlowFastR50.max_stage`` and the stems' ``stem_f`` / ``stem_pool``
fields in the port (avtex_torch/nn/slowfast.py): ``max_stage`` against
avtex's ``SlowFastR50(max_stage=k)``; the stem fields reach the s2d
stems, whose forms tests/test_torch_s2d_stem.py holds against avtex.

The test model of tests/test_torch_slowfast.py (width 8, layers
(2, 1, 1, 1), 32 px, fp32, one CPU thread), ``norm="affine"`` with
``fuse="all"`` and ``KERNEL_MIN_CHANNELS`` at 0, so every fused 1x1 conv
takes the kernel's path (its plain version on the CPU); avtex runs its
convs unfused, the same arithmetic. One set of parameters of avtex's full
model (drawn in numpy on its shapes, norms off ones/zeros) serves every
truncation, as in avtex's tools/embed_stage_bench.py.
Tolerance rtol/atol 1e-4 (the frameworks sum convolutions in other
orders). The fused convs of a truncated forward are those of the stages
it runs.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avtex.nn.slowfast import SlowFastR50 as JaxSF
from avtex_torch.nn import slowfast as port_slowfast
from test_torch_slowfast import SMALL, _inputs, _port_encoder

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _tree():
    """avtex's parameters as numpy, drawn directly (no init compile)."""
    slow, fast = _inputs()
    m = JaxSF(**SMALL, dtype=jnp.float32, norm="affine")
    shapes = jax.eval_shape(m.init, jax.random.key(0), slow, fast)
    g = np.random.default_rng(0)

    def draw(path, s):
        if path[-1].key == "scale":
            return (1.0 + 0.1 * g.standard_normal(s.shape)).astype(np.float32)
        if path[-1].key == "bias":
            return (0.1 * g.standard_normal(s.shape)).astype(np.float32)
        return (g.standard_normal(s.shape)
                / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _avtex_prefix(k):
    slow, fast = _inputs()
    m = JaxSF(**SMALL, dtype=jnp.float32, norm="affine", max_stage=k)
    return np.asarray(jax.jit(m.apply)(_tree(), slow, fast))


def _kernel_convs_in_stages(enc, k):
    """The 1x1 convs that ``fuse="all"`` sends to the kernel's path in the
    stages below k (conv1 when its temporal kernel is 1, the projection,
    conv3; each passing the shape rule)."""
    n, idx = 0, 0
    for i, n_blocks in enumerate(enc.layers):
        for _ in range(2 * n_blocks):
            b = getattr(enc, f"SFBottleneck_{idx}")
            fused = [2] + [3] * b.need_proj + [0] * (b.t_kernel == 1)
            if i < k:
                n += sum(b.kernel_eligible(c) for c in fused)
            idx += 1
    return n


@pytest.mark.parametrize("k", [0, 1, 2, 3, 4])
def test_max_stage_matches_avtex(monkeypatch, k):
    monkeypatch.setattr(port_slowfast, "KERNEL_MIN_CHANNELS", 0)
    calls = []
    real = port_slowfast.fused_conv1x1

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)
    monkeypatch.setattr(port_slowfast, "fused_conv1x1", counting)
    want = _avtex_prefix(k)
    enc = _port_encoder(_tree(), norm="affine", fuse="all", max_stage=k)
    slow, fast = _inputs()
    with torch.no_grad():
        got = enc(torch.from_numpy(slow), torch.from_numpy(fast))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert len(calls) == _kernel_convs_in_stages(enc, k)
    if k == 4:
        assert got.shape == (2, enc.feat_dim)
    else:
        assert got.shape[1] < enc.feat_dim


def test_max_stage_default_is_the_full_network():
    a = _port_encoder(_tree(), norm="affine")
    b = _port_encoder(_tree(), norm="affine", max_stage=4)
    assert a.max_stage == 4
    slow, fast = (torch.from_numpy(x) for x in _inputs())
    with torch.no_grad():
        assert torch.equal(a(slow, fast), b(slow, fast))


def test_stem_fields_reach_the_s2d_stems(monkeypatch):
    """``stem_f`` / ``stem_pool`` are ``fast_stem_s2d_pooled``'s ``f`` and
    ``pool`` for both stems (tests/test_torch_s2d_stem.py holds each form
    against avtex's ``STEM_F`` / ``POOL_IMPL``); every form gives the
    default's output (the pools are exact, the factors sum the same
    products in other orders, and the lateral on the two pools' output
    layouts may sum in another order)."""
    seen = []
    real = port_slowfast.fast_stem_s2d_pooled

    def recording(*args, **kwargs):
        seen.append((kwargs["f"], kwargs["pool"]))
        return real(*args, **kwargs)
    monkeypatch.setattr(port_slowfast, "fast_stem_s2d_pooled", recording)
    slow, fast = (torch.from_numpy(x) for x in _inputs())
    outs = {}
    with torch.no_grad():
        for f in (None, 4, 8):
            for pool in ("shuffle", "phase"):
                enc = _port_encoder(_tree(), norm="affine", max_stage=0,
                                    stem_f=f, stem_pool=pool)
                outs[f, pool] = enc(slow, fast).numpy()
                assert seen[-2:] == [(f, pool)] * 2
    want = outs[None, "shuffle"]
    for key, got in outs.items():
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=str(key))
