"""Train-time augmentation in the port (avtex_torch/data/preprocess.py)
against avtex's (avtex/data/preprocess.py), on the same uint8 frames.

torch cannot reproduce ``jax.random``, so the port splits each random
function into a draw (``draw_augment_params``, from a torch.Generator)
and an apply (``apply_augment``). Here avtex's draws are computed with
``jax.random`` from avtex's own key splits and handed to the port's apply:
the outputs agree within 1e-5 (both build the same float32 triangle-
filter weights; only the contraction order differs). avtex runs here op
by op (``jax.disable_jit``): jitted, XLA's CPU fusion of the weight build
and products lands up to 7e-6 from an fp64 evaluation of the same
scale-and-translate, 2.6e-5 after the normalisation's 1/0.2768, while
the port stays within 1.1e-7 of it (the test that says so is below).
The port's draws are held to avtex's ranges and, by chi-square, to its
flip rate and short-side distribution. The host-side jitters take the same legacy
``np.random.RandomState`` and are bit-exact in their draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtex.data import preprocess as jax_pre
from avtex_torch.data import preprocess as pre

torch.set_num_threads(1)

SIZE = 32
TOL = 1e-5


def _frames(shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, shape, dtype=np.uint8)


def avtex_draws(rng, b, h, w, size, scale_range=(0.8, 1.2), jitter=0.2):
    """The draws avtex's augment_and_preprocess makes from ``rng``, from its
    own key splits (avtex/data/preprocess.py:96-148)."""
    k_scale, k_crop, k_flip, k_bright, k_contrast, k_sat = \
        jax.random.split(rng, 6)
    min_size = max(size, int(round(size * scale_range[0])))
    max_size = max(min_size + 1, int(round(size * scale_range[1])))
    s = jnp.round(jax.random.uniform(k_scale, (b,), minval=float(min_size),
                                     maxval=float(max_size)))
    if w < h:
        nw, nh = s, jnp.floor(h / w * s)
    elif h < w:
        nh, nw = s, jnp.floor(w / h * s)
    else:
        nh = nw = s
    u = jax.random.uniform(k_crop, (b, 2))
    lim_y, lim_x = nh - size, nw - size
    oy = jnp.where(lim_y > 0, jnp.floor(u[:, 0] * lim_y), 0.0)
    ox = jnp.where(lim_x > 0, jnp.floor(u[:, 1] * lim_x), 0.0)
    flip = jax.random.bernoulli(k_flip, 0.5, (b,))

    def factors(key):
        return 1.0 + jax.random.uniform(key, (b,), minval=-jitter,
                                        maxval=jitter)

    out = {"s": s, "oy": oy, "ox": ox, "flip": flip,
           "bright": factors(k_bright), "contrast": factors(k_contrast),
           "sat": factors(k_sat)}
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.mark.parametrize("slowfast", [False, True])
@pytest.mark.parametrize("hw", [(40, 56), (56, 40), (44, 44)])
@pytest.mark.parametrize("key", [0, 3])
def test_apply_matches_avtex_under_its_draws(hw, slowfast, key):
    frames = _frames((6, 4) + hw + (3,), seed=key)
    rng = jax.random.key(key)
    with jax.disable_jit():
        want = np.asarray(jax_pre.augment_and_preprocess(
            jnp.asarray(frames), rng, size=SIZE, slowfast=slowfast))
    draws = avtex_draws(rng, 6, *hw, SIZE)
    got = pre.apply_augment(torch.from_numpy(frames), draws, SIZE, slowfast)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def _jax_scale_crop(clip, nh, nw, oy, ox, size):
    """avtex's per-clip scale-and-translate (its ``one``), on given draws."""
    h, w = clip.shape[1:3]
    return np.asarray(jax.image.scale_and_translate(
        jnp.asarray(clip), (clip.shape[0], size, size, clip.shape[3]),
        (1, 2), jnp.asarray([nh / h, nw / w], jnp.float32),
        jnp.asarray([-oy, -ox], jnp.float32), "bilinear", antialias=False))


def test_scale_crop_is_closer_to_fp64_than_jitted_avtex():
    hw = (40, 56)
    frames = _frames((6, 4) + hw + (3,))
    rng = jax.random.key(0)
    k_scale, k_crop = jax.random.split(rng, 6)[:2]
    x = frames.astype(np.float32) / 255.0
    jitted = np.asarray(jax.jit(
        jax_pre._jittered_scale_crop, static_argnums=(3, 4, 5))(
        jnp.asarray(x), k_scale, k_crop, SIZE, 32, 38))
    draws = avtex_draws(rng, 6, *hw, SIZE)
    got = pre._jittered_scale_crop(torch.from_numpy(x), draws, SIZE)
    nh, nw = pre._short_side(draws["s"], *hw)
    wy = pre._scale_translate_weights(hw[0], SIZE, nh / hw[0], -draws["oy"])
    wx = pre._scale_translate_weights(hw[1], SIZE, nw / hw[1], -draws["ox"])
    exact = torch.einsum("boh,bthwc->btowc", wy.double(),
                         torch.from_numpy(x).double())
    exact = torch.einsum("bpw,btowc->btopc", wx.double(), exact).numpy()
    port_err = np.abs(got.numpy() - exact).max()
    assert port_err <= 2e-7 and port_err < np.abs(jitted - exact).max()


@pytest.mark.parametrize("hw", [(40, 56), (56, 40), (44, 44)])
@pytest.mark.parametrize("where", ["first", "last"])
def test_border_crops_match_avtex(hw, where):
    h, w = hw
    s = np.array([32.0, 37.0, 38.0], np.float32)
    params = {"s": torch.from_numpy(s)}
    nh, nw = (t.numpy() for t in pre._short_side(params["s"], h, w))
    if where == "first":
        oy, ox = np.zeros(3, np.float32), np.zeros(3, np.float32)
    else:  # the last offset the crop can take
        oy, ox = nh - SIZE, nw - SIZE
    params.update(oy=torch.from_numpy(oy), ox=torch.from_numpy(ox))
    x = _frames((3, 2, h, w, 3), seed=5).astype(np.float32) / 255.0
    got = pre._jittered_scale_crop(torch.from_numpy(x), params, SIZE)
    want = np.stack([_jax_scale_crop(x[i], nh[i], nw[i], oy[i], ox[i], SIZE)
                     for i in range(3)])
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_draws_are_in_avtex_ranges():
    h, w, b = 40, 56, 4000
    g = torch.Generator().manual_seed(0)
    p = pre.draw_augment_params(b, h, w, SIZE, g)
    lo, hi = pre.augment_sizes(SIZE)
    assert (lo, hi) == (32, 38)
    s = p["s"].numpy()
    assert s.min() == lo and s.max() == hi and (s == np.round(s)).all()
    nh, nw = pre._short_side(p["s"], h, w)
    assert torch.equal(nh, p["s"]) and torch.equal(nw, torch.floor(
        p["s"] * (w / h)))
    for off, n in (("oy", nh), ("ox", nw)):
        o = p[off]
        assert (o == torch.floor(o)).all() and (o >= 0).all()
        # the last offset is never drawn (0 where the side equals SIZE)
        assert (o < torch.clamp(n - SIZE, min=1)).all()
    for k in ("bright", "contrast", "sat"):
        assert 0.8 <= float(p[k].min()) and float(p[k].max()) <= 1.2
    assert p["flip"].dtype == torch.bool


def test_draws_follow_avtex_distribution():
    """Chi-square of the port's flip rate and short-side targets against
    avtex's distribution: s = round(U[32, 38]) puts half-width bins at 32
    and 38."""
    n = 6000
    p = pre.draw_augment_params(n, 40, 40, SIZE,
                                torch.Generator().manual_seed(1))
    flips = int(p["flip"].sum())
    chi2_flip = ((flips - n / 2) ** 2 + (n - flips - n / 2) ** 2) / (n / 2)
    assert chi2_flip < 10.83, flips  # dof 1, 99.9th percentile
    counts = np.bincount(p["s"].numpy().astype(int) - 32, minlength=7)
    exp = n * np.array([0.5, 1, 1, 1, 1, 1, 0.5]) / 6
    chi2 = float(((counts - exp) ** 2 / exp).sum())
    assert chi2 < 22.46, counts  # dof 6, 99.9th percentile
    # avtex's own draws pass the same test
    s = np.asarray(jnp.round(jax.random.uniform(
        jax.random.key(1), (n,), minval=32.0, maxval=38.0)))
    counts = np.bincount(s.astype(int) - 32, minlength=7)
    assert float(((counts - exp) ** 2 / exp).sum()) < 22.46


def test_generator_replays_and_lands_on_the_card_unchanged():
    frames = torch.from_numpy(_frames((3, 2, 40, 40, 3)))
    a = pre.augment_and_preprocess(frames, torch.Generator().manual_seed(9),
                                   size=SIZE)
    b = pre.augment_and_preprocess(frames, torch.Generator().manual_seed(9),
                                   size=SIZE)
    assert torch.equal(a, b)


@pytest.mark.parametrize("hw,minmax,inverse", [
    ((24, 40), (20, 30), False), ((40, 24), (20, 30), False),
    ((32, 32), (20, 40), True), ((24, 40), (24, 25), False)])
def test_short_side_scale_jitter_matches_avtex(hw, minmax, inverse):
    x = _frames((2,) + hw + (3,), seed=2)
    for seed in range(4):
        want = np.asarray(jax_pre.random_short_side_scale_jitter(
            x, *minmax, rng=np.random.RandomState(seed),
            inverse_uniform_sampling=inverse))
        rs = np.random.RandomState(seed)
        got = pre.random_short_side_scale_jitter(
            x, *minmax, rng=rs, inverse_uniform_sampling=inverse)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=1e-3)
        # the same draws: both streams end in the same state
        ref = np.random.RandomState(seed)
        jax_pre.random_short_side_scale_jitter(
            x, *minmax, rng=ref, inverse_uniform_sampling=inverse)
        assert rs.uniform() == ref.uniform()


def test_lighting_jitter_matches_avtex():
    eigval = np.array([0.2175, 0.0188, 0.0045])
    eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                       [-0.5808, -0.0045, -0.8140],
                       [-0.5836, -0.6948, 0.4203]])
    x = np.random.default_rng(3).random((2, 8, 8, 3)).astype(np.float32)
    for seed in range(3):
        want = np.asarray(jax_pre.lighting_jitter(
            x, 0.1, eigval, eigvec, rng=np.random.RandomState(seed)))
        got = pre.lighting_jitter(x, 0.1, eigval, eigvec,
                                  rng=np.random.RandomState(seed))
        np.testing.assert_array_equal(got.numpy(), want)
    assert pre.lighting_jitter(x, 0.0, eigval, eigvec) is x


@pytest.mark.parametrize("hw", [(40, 56), (56, 40), (40, 40)])
@pytest.mark.parametrize("spatial_idx", [0, 1, 2])
def test_uniform_crop_and_eval_composite_match_avtex(hw, spatial_idx):
    x = _frames((2, 3) + hw + (3,), seed=4)
    want = np.asarray(jax_pre.uniform_crop(jnp.asarray(x), 32, spatial_idx))
    np.testing.assert_array_equal(
        pre.uniform_crop(torch.from_numpy(x), 32, spatial_idx).numpy(), want)
    want = np.asarray(jax_pre.scale_uniform_crop_norm(
        jnp.asarray(x), scale_size=36, crop_size=32,
        spatial_idx=spatial_idx))
    got = pre.scale_uniform_crop_norm(torch.from_numpy(x), 36, 32,
                                      spatial_idx)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=1e-4)
