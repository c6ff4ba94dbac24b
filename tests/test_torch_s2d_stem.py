"""The space-to-depth stems in the port (avtex_torch/ops/s2d_stem.py, the
``s2d_stem`` field of avtex_torch/nn/slowfast.py) against avtex's
(avtex/ops/s2d_stem.py) and against the port's plain conv stem.

Same seeded numpy inputs through both, fp32, one CPU thread, small
shapes. Tolerances: against avtex 1e-4 (rtol and atol; the two frameworks
sum the conv in different orders), against the port's plain stem 1e-5;
the scattered weights bit-exact against avtex's (a pure rearrangement);
the two pool forms bit-identical (max is exact). The encoder with
``s2d_stem`` against avtex's: 1e-4, as tests/test_torch_slowfast.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avtex.nn.slowfast import SlowFastR50 as JaxSF
from avtex.ops import s2d_stem as jax_s2d
from avtex_torch.nn.slowfast import SlowFastR50
from avtex_torch.ops import s2d_stem
from avtex_torch.convert import convert_params
from test_torch_slowfast import _perturbed_norms

torch.set_num_threads(1)

AVTEX_TOL = dict(rtol=1e-4, atol=1e-4)
PLAIN_TOL = dict(rtol=1e-5, atol=1e-5)


def _stem_inputs(t, h, w, kt, o, seed=0):
    """x [2, T, H, W, 3], avtex kernel [kt, 7, 7, 3, O], signed
    non-uniform scale and bias (a channel in the wrong phase shows)."""
    g = np.random.default_rng(seed)
    return (g.standard_normal((2, t, h, w, 3)).astype(np.float32),
            (g.standard_normal((kt, 7, 7, 3, o)) / 8).astype(np.float32),
            g.standard_normal(o).astype(np.float32),
            g.standard_normal(o).astype(np.float32))


def _oidhw(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(4, 3, 0, 1, 2)))


def _np(y):
    return y.detach().numpy()


@pytest.mark.parametrize("f", [4, 8])
@pytest.mark.parametrize("kt,o", [(1, 64), (1, 8), (5, 8), (5, 16)])
def test_scattered_weights_bit_exact_against_avtex(f, kt, o):
    _, k, _, _ = _stem_inputs(1, 8, 8, kt, o)
    want = np.asarray(jax_s2d.s2d_stem_kernel(jnp.asarray(k), f))
    got = s2d_stem.s2d_stem_kernel(_oidhw(k), f)
    np.testing.assert_array_equal(_np(got).transpose(2, 3, 4, 1, 0), want)


def test_scattered_weights_follow_the_weights():
    """Built from the weights on every call: nothing goes stale."""
    _, k, _, _ = _stem_inputs(1, 8, 8, 5, 8)
    w = _oidhw(k)
    a = s2d_stem.s2d_stem_kernel(w, 4)
    w.mul_(2)
    np.testing.assert_array_equal(_np(s2d_stem.s2d_stem_kernel(w, 4)),
                                  2 * _np(a))


@pytest.mark.parametrize("t,h,w,kt,o", [
    (6, 16, 20, 5, 8),     # the fast stem's kt, H != W
    (3, 16, 20, 1, 16),    # the slow stem's kt = 1
    (4, 32, 32, 5, 8),
    (2, 64, 64, 1, 8),
])
def test_unpooled_stem_matches_avtex_and_plain(t, h, w, kt, o):
    x, k, _, _ = _stem_inputs(t, h, w, kt, o)
    want = np.asarray(jax_s2d.fast_stem_s2d(jnp.asarray(x), jnp.asarray(k)))
    got = s2d_stem.fast_stem_s2d(torch.from_numpy(x), _oidhw(k))
    plain = s2d_stem.stem_conv_plain(torch.from_numpy(x), _oidhw(k))
    assert got.shape == want.shape == plain.shape
    np.testing.assert_allclose(_np(got), want, **AVTEX_TOL)
    np.testing.assert_allclose(_np(got), _np(plain), **PLAIN_TOL)


@pytest.mark.parametrize("f", [4, 8])
@pytest.mark.parametrize("t,h,w,kt,o", [
    (6, 16, 24, 5, 8),     # f = 8 only along H: falls back to 4
    (3, 16, 20, 1, 16),    # slow-stem geometry; O > 8: f = 8 falls back
    (4, 32, 32, 5, 8),     # multiples of 8
    (2, 64, 64, 1, 8),
    (2, 64, 32, 5, 8),
])
def test_pooled_stem_matches_avtex_and_plain(monkeypatch, f, t, h, w, kt,
                                             o):
    x, k, sc, bi = _stem_inputs(t, h, w, kt, o)
    monkeypatch.setattr(jax_s2d, "STEM_F", f)
    xt, wt = torch.from_numpy(x), _oidhw(k)
    sct, bit = torch.from_numpy(sc), torch.from_numpy(bi)
    plain = s2d_stem.stem_pooled_plain(xt, wt, sct, bit)
    outs = {}
    for pool, jax_impl in (("shuffle", "slice9"), ("phase", "rw")):
        monkeypatch.setattr(jax_s2d, "POOL_IMPL", jax_impl)
        want = np.asarray(jax_s2d.fast_stem_s2d_pooled(
            jnp.asarray(x), jnp.asarray(k), jnp.asarray(sc),
            jnp.asarray(bi)))
        outs[pool] = s2d_stem.fast_stem_s2d_pooled(xt, wt, sct, bit, f=f,
                                                   pool=pool)
        assert outs[pool].shape == want.shape == plain.shape
        np.testing.assert_allclose(_np(outs[pool]), want, **AVTEX_TOL)
        np.testing.assert_allclose(_np(outs[pool]), _np(plain),
                                   **PLAIN_TOL)
    assert torch.equal(outs["shuffle"], outs["phase"])


@pytest.mark.parametrize("o,h,w,want", [
    (8, 32, 32, 8), (8, 64, 32, 8), (16, 32, 32, 4), (8, 36, 32, 4),
    (8, 32, 20, 4), (64, 224, 224, 4)])
def test_f8_falls_back_where_avtex_does(o, h, w, want):
    assert s2d_stem.stem_factor(o, h, w, 8) == want
    assert s2d_stem.stem_factor(o, h, w, None) == 4
    assert s2d_stem.stem_factor(o, h, w, 4) == 4


def test_pooled_stem_f8_fallback_is_the_f4_result():
    x, k, sc, bi = _stem_inputs(3, 16, 20, 1, 16)
    args = (torch.from_numpy(x), _oidhw(k), torch.from_numpy(sc),
            torch.from_numpy(bi))
    assert torch.equal(s2d_stem.fast_stem_s2d_pooled(*args, f=8),
                       s2d_stem.fast_stem_s2d_pooled(*args, f=4))


def test_stems_refuse_sizes_that_are_not_multiples_of_4():
    x, k, sc, bi = _stem_inputs(2, 18, 20, 5, 8)
    with pytest.raises(ValueError, match="multiples of 4"):
        s2d_stem.fast_stem_s2d(torch.from_numpy(x), _oidhw(k))
    with pytest.raises(ValueError, match="multiples of 4"):
        s2d_stem.fast_stem_s2d_pooled(torch.from_numpy(x), _oidhw(k),
                                      torch.from_numpy(sc),
                                      torch.from_numpy(bi))
    with pytest.raises(ValueError, match="pool"):
        s2d_stem.fast_stem_s2d_pooled(torch.zeros(1, 1, 8, 8, 3),
                                      _oidhw(k), torch.from_numpy(sc),
                                      torch.from_numpy(bi), pool="nope")


TINY = dict(width=8, layers=(1, 1, 1, 1))


def _port_encoder(tree, **kw):
    enc = SlowFastR50(**TINY, dtype=torch.float32, **kw)
    holder = torch.nn.Module()
    holder.add_module("enc", enc)
    holder.load_state_dict(convert_params({"enc": tree["params"]}, holder))
    return enc.eval()


def _inputs(h, seed=0):
    g = np.random.default_rng(seed)
    return (g.standard_normal((2, 8, h, h, 3)).astype(np.float32),
            g.standard_normal((2, 32, h, h, 3)).astype(np.float32))


@pytest.mark.parametrize("norm", ["affine", "group"])
def test_encoder_with_s2d_stems_matches_avtex(norm):
    slow, fast = _inputs(16)
    m = JaxSF(**TINY, dtype=jnp.float32, norm=norm, s2d_stem=True)
    tree = _perturbed_norms(jax.jit(m.init)(jax.random.key(0), slow, fast))
    want = np.asarray(jax.jit(m.apply)(tree, slow, fast))
    enc = _port_encoder(tree, norm=norm, s2d_stem=True)
    plain = _port_encoder(tree, norm=norm, s2d_stem=False)
    with torch.no_grad():
        got = enc(torch.from_numpy(slow), torch.from_numpy(fast))
        ref = plain(torch.from_numpy(slow), torch.from_numpy(fast))
    np.testing.assert_allclose(_np(got), want, **AVTEX_TOL)
    np.testing.assert_allclose(_np(got), _np(ref), **AVTEX_TOL)


def test_encoder_falls_back_to_the_plain_stem_off_multiples_of_4():
    slow, fast = _inputs(30)
    enc = SlowFastR50(**TINY, dtype=torch.float32, norm="affine").eval()
    with torch.no_grad():
        a = enc(torch.from_numpy(slow), torch.from_numpy(fast))
        enc.s2d_stem = False
        b = enc(torch.from_numpy(slow), torch.from_numpy(fast))
    assert torch.equal(a, b)
