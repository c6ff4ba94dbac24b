"""SuperSloMo in the port (avtex_torch/nn/slomo.py, avtex_torch/synth/
interp.py, the loader in avtex_torch/checkpoints.py) against avtex's
(avtex/nn/slomo.py, avtex/synth/interp.py, avtex/utils/convert.py).

Weights from one seeded flax init carried over by
``convert_slomo_params``; fp32 on both sides, one CPU thread.
Tolerances: ``backwarp`` 1e-5 on normalised frames (the grid's
normalisation rounds the sample position); the UNet
and the whole net 1e-4 on normalised values (convs summed in other
orders); uint8 frames within 1 level (a value near a rounding edge may
truncate either way). A ``SuperSloMo.ckpt`` written by the port from
seeded weights is loaded by both loaders, which pair convs in call
order: frames within 1 level."""

import functools
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avtex.nn import slomo as jax_slomo
from avtex.synth import interp as jax_interp
from avtex.utils import convert as jax_convert
from avtex_torch.checkpoints import (convert_slomo_params, load_torch_state,
                                     maybe_make_slomo_interp_fn,
                                     save_slomo_checkpoint)
from avtex_torch.nn.slomo import SLOMO_MEAN, SuperSloMo, backwarp
from avtex_torch.synth.interp import init_slomo, make_interp_fn

torch.set_num_threads(1)

TS = (0.25, 0.5, 0.75)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(y):
    return y.detach().numpy().transpose(*range(y.ndim - 3), -2, -1, -3)


@functools.lru_cache(maxsize=None)
def _nets():
    """(avtex module, flax params, port model) with the same weights."""
    m = jax_slomo.SuperSloMo(dtype=jnp.float32)
    z = jnp.zeros((1, 32, 32, 3))
    params = jax.jit(m.init, static_argnums=3)(jax.random.key(3), z, z,
                                                (0.5,))
    params = jax.tree_util.tree_map(np.asarray, params)
    port = SuperSloMo(torch.float32)
    port.load_state_dict(convert_slomo_params(params))
    return m, params, port.eval()


def _frames(h, w, seed=0):
    g = np.random.default_rng(seed)
    return [(g.random((h, w, 3)) * 255).astype(np.uint8) for _ in range(2)]


@pytest.mark.parametrize("h,w", [(12, 20), (32, 96)])
def test_backwarp_matches_avtex_off_the_image_too(h, w):
    # images as the interp path feeds them: frames/255 - SLOMO_MEAN. The
    # grid's normalisation by W rounds a sample's position by about
    # W * 2^-24 px, so the difference scales with the image's local
    # steps (here < 1); avtex samples at x + u - 0.5 directly.
    g = np.random.default_rng(1)
    img = (g.random((2, h, w, 3)) - np.asarray(SLOMO_MEAN)).astype(
        np.float32)
    flow = g.uniform(-3, 3, (2, h, w, 2)).astype(np.float32)
    want = np.asarray(jax_slomo.backwarp(jnp.asarray(img),
                                         jnp.asarray(flow)))
    got = backwarp(_nchw(img), _nchw(flow))
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-5)
    # the taps really leave the image at the border (zeros there)
    assert (np.abs(flow[:, 0, :, 0]) > 1).any()


def test_unet_matches_avtex():
    m, params, port = _nets()
    x = np.random.default_rng(2).standard_normal((1, 32, 96, 6)).astype(
        np.float32)
    unet = jax_slomo.UNet(4, jnp.float32)
    want = np.asarray(jax.jit(unet.apply)(
        {"params": params["params"]["flow_comp"]}, x))
    with torch.no_grad():
        got = port.flow_comp(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-4, atol=1e-4)


def test_superslomo_matches_avtex():
    m, params, port = _nets()
    g = np.random.default_rng(4)
    i0, i1 = (g.standard_normal((1, 32, 64, 3)).astype(np.float32) * 0.3
              for _ in range(2))
    want = np.asarray(jax.jit(m.apply, static_argnums=3)(params, i0, i1,
                                                          TS))
    with torch.no_grad():
        got = port(_nchw(i0), _nchw(i1), TS)
    assert got.shape == (3, 1, 3, 32, 64)
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("h,w,n_mid", [(40, 40, 4), (32, 72, 2)])
def test_interp_fn_matches_avtex_where_frames_pad(h, w, n_mid):
    """40 pads to 64 and 72 to 96: the crop and the pad-after-normalise."""
    m, params, port = _nets()
    f0, f1 = _frames(h, w)
    want = jax_interp.make_interp_fn(m, params)(f0, f1, n_mid)
    got = make_interp_fn(port)(f0, f1, n_mid)
    assert got.shape == want.shape == (n_mid, h, w, 3)
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_init_slomo_is_seeded_flax_style():
    a = init_slomo(seed=5, dtype=torch.float32, device="cpu")
    b = init_slomo(seed=5, dtype=torch.float32, device="cpu")
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q)
        if name.endswith("bias"):
            assert not p.any()
    w = a.flow_comp.Conv_0.weight.detach()
    std = (1.0 / w[0].numel()) ** 0.5
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert abs(float(w.std()) - std) < 0.1 * std
    assert init_slomo(seed=5, device="cpu").flow_comp.Conv_0.weight.dtype \
        == torch.bfloat16


@pytest.fixture(scope="module")
def slomo_ckpt(tmp_path_factory):
    model = init_slomo(seed=9, dtype=torch.float32, device="cpu")
    path = tmp_path_factory.mktemp("slomo") / "SuperSloMo.ckpt"
    return model, save_slomo_checkpoint(model, str(path))


def test_checkpoint_file_has_the_reference_layout(slomo_ckpt):
    model, path = slomo_ckpt
    raw = torch.load(path, weights_only=True)
    assert set(raw) == {"state_dictFC", "state_dictAT"}
    assert list(raw["state_dictFC"])[:4] == [
        "conv1.weight", "conv1.bias", "conv2.weight", "conv2.bias"]
    assert "down5.conv2.weight" in raw["state_dictAT"]
    assert list(raw["state_dictAT"])[-1] == "conv3.bias"
    state = load_torch_state(path)
    assert list(state)[0] == "flowComp.conv1.weight"
    assert len(state) == 2 * 2 * 23  # 23 convs per UNet, weight + bias


def test_checkpoint_loads_as_avtex_loads_it(monkeypatch, slomo_ckpt):
    """Both loaders on the same file; fp32 nets on both sides (avtex's
    loader builds its module through avtex.synth.interp.SuperSloMo)."""
    _, path = slomo_ckpt
    monkeypatch.setattr(jax_interp, "SuperSloMo", functools.partial(
        jax_slomo.SuperSloMo, dtype=jnp.float32))
    want_fn = jax_convert.maybe_make_slomo_interp_fn(path, size=(40, 40))
    got_fn = maybe_make_slomo_interp_fn(path, device="cpu",
                                        dtype=torch.float32)
    f0, f1 = _frames(40, 40, seed=3)
    want, got = want_fn(f0, f1, 4), got_fn(f0, f1, 4)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    # and it is the model that was written
    model, _ = slomo_ckpt
    np.testing.assert_array_equal(got, make_interp_fn(model)(f0, f1, 4))


def test_loader_refuses_what_does_not_pair(monkeypatch, tmp_path,
                                           slomo_ckpt):
    monkeypatch.delenv("AVTEX_SLOMO_CKPT", raising=False)
    monkeypatch.chdir(tmp_path)
    model, _ = slomo_ckpt
    assert maybe_make_slomo_interp_fn(str(tmp_path / "absent.ckpt"),
                                      device="cpu") is None
    state = {k: v.clone() for k, v in model.state_dict().items()}
    bad = str(tmp_path / "short.ckpt")
    torch.save({"state_dictFC": {"conv1.weight": state[
        "flow_comp.Conv_0.weight"], "conv1.bias": state[
        "flow_comp.Conv_0.bias"]}, "state_dictAT": {}}, bad)
    with pytest.raises(ValueError, match="conv count"):
        maybe_make_slomo_interp_fn(bad, device="cpu")
    garbage = tmp_path / "garbage.ckpt"
    garbage.write_bytes(b"not a real checkpoint")
    with pytest.raises(pickle.UnpicklingError):
        maybe_make_slomo_interp_fn(str(garbage), device="cpu")
