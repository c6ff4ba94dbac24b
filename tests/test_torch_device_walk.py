"""The device walks in the port against avtex's ``lax.scan`` walks, fed
avtex's own noise.

avtex draws each step's noise as ``jax.random.uniform(k, (L_pad,))`` over
``jax.random.split(key, steps_pad)`` (L padded to a multiple of 128, the
steps to a multiple of 64); ``_avtex_noise`` rebuilds it and keeps the
first ``steps`` rows and ``L`` columns, which the port's walks take as
``noise=``. ``AVTEX_WALK_AOT=0`` keeps avtex from writing its compile
cache.

- contrastive (``synthesize_indices``): indices, jumps, greedy ids and
  survivor counts bit-exact on non-negative tables, entropies and
  pos_prob within rtol 1e-5 (the ``[L, L]`` logits are summed in another
  order), with and without driving-audio rows;
- classic (``sample_texture_walk``): indices and jumps bit-exact, for
  ``advance = 0`` and ``advance = k``;
- the torch walks' own draws: uniform over the survivors (chi-square).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avtex.classic import future_cost as j_fc
from avtex.classic import d1 as j_d1
from avtex.classic import d2 as j_d2
from avtex.classic import sampler as j_sampler
from avtex.synth import engine as jax_engine
from avtex_torch.classic import sampler
from avtex_torch.synth import engine

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_aot(monkeypatch):
    monkeypatch.setenv("AVTEX_WALK_AOT", "0")


def _avtex_noise(seed, steps, n):
    """avtex's per-step uniform draws for ``jax.random.key(seed)``."""
    steps_pad = -(-steps // 64) * 64
    n_pad = n + (-n) % 128
    keys = jax.random.split(jax.random.key(seed), steps_pad)
    noise = jax.vmap(lambda k: jax.random.uniform(k, (n_pad,)))(keys)
    return torch.from_numpy(np.asarray(noise)[:steps, :n].copy())


def _tables(L, D=64, seed=0):
    """Unit rows with non-negative entries (SlowFast's pooled ReLU
    features are)."""
    g = np.random.default_rng(seed)
    q, t = np.abs(g.standard_normal((2, L, D))).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    return q, t


@pytest.mark.parametrize("audio", [False, True])
@pytest.mark.parametrize("L,threshold,seed_id,steps", [
    (20, 0.0, 10, 40), (50, 0.3, 3, 60), (297, 0.5, 10, 144),
    (8, 1.0, 7, 25), (120, 0.1, 119, 80)])
def test_device_walk_matches_avtex(L, threshold, seed_id, steps, audio):
    q, t = _tables(L, seed=L)
    rows = None
    if audio:
        rows = np.abs(np.random.default_rng(L + 1).standard_normal(
            (steps, L))).astype(np.float32) / 0.1
    want = jax_engine.synthesize_indices(
        jnp.asarray(q), jnp.asarray(t), steps, temp=0.1,
        threshold=threshold, alpha=0.5,
        audio_logits=None if rows is None else jnp.asarray(rows),
        seed_id=seed_id, rng=jax.random.key(4))
    got = engine.synthesize_indices(
        torch.from_numpy(q), torch.from_numpy(t), steps, temp=0.1,
        threshold=threshold, alpha=0.5,
        audio_logits=None if rows is None else torch.from_numpy(rows),
        seed_id=seed_id, noise=_avtex_noise(4, steps, L))
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.jumps, want.jumps)
    np.testing.assert_array_equal(got.nonzero_counts, want.nonzero_counts)
    np.testing.assert_array_equal(got.greedy_ids, want.greedy_ids)
    np.testing.assert_allclose(got.entropies, want.entropies, rtol=1e-5)
    np.testing.assert_allclose(got.pos_prob, want.pos_prob, rtol=1e-5)
    assert got.seed_id == want.seed_id == seed_id
    assert 0 < got.jumps.sum() or threshold == 0.0


def test_device_walk_repeats_and_stays_on_survivors():
    """The same seed gives the same walk; every chosen id survives its
    step's threshold (checked against the host walk's per-step rule)."""
    q, t = _tables(60, seed=3)
    a = engine.synthesize_indices(torch.from_numpy(q), torch.from_numpy(t),
                                  50, threshold=0.4, seed=9)
    b = engine.synthesize_indices(torch.from_numpy(q), torch.from_numpy(t),
                                  50, threshold=0.4, seed=9)
    np.testing.assert_array_equal(a.indices, b.indices)
    logits = (q @ t.T) / 0.1
    prev = 10
    for nxt in a.indices:
        pos = min(prev + 1, len(q) - 1)
        cand = np.ones(len(q), bool)
        cand[prev] = pos == prev
        row = np.where(cand, logits[prev], 0.0)
        p = row / row.sum()
        mx = p[cand].max()
        assert cand[nxt] and p[nxt] >= mx - 0.4 * mx
        prev = int(nxt)


def test_device_walk_survivor_sampling_uniform():
    """The torch walk's argmax-of-noise race over its own draws is uniform
    over the survivors: seeded chi-square over the first step's choice,
    as tests/test_synth.py checks avtex's."""
    L, D = 8, 4
    g = np.random.default_rng(7)
    q = np.abs(g.standard_normal((L, D))).astype(np.float32)
    t = np.abs(g.standard_normal((L, D))).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    qt, tt = torch.from_numpy(q), torch.from_numpy(t)
    survivors = np.arange(1, L)  # threshold 1: every candidate survives
    n_trials = 400
    counts = np.zeros(L)
    for i in range(n_trials):
        r = engine.synthesize_indices(qt, tt, 1, threshold=1.0, seed_id=0,
                                      seed=i)
        counts[int(r.indices[0])] += 1
    assert counts[0] == 0, counts
    exp = n_trials / len(survivors)
    chi2 = float(((counts[survivors] - exp) ** 2 / exp).sum())
    # dof = 6; the chi-square 99.9th percentile for dof <= 7 is < 24.3
    assert chi2 < 24.3, (chi2, counts)


def _p3():
    """avtex's P3_new on tests/test_classic.py's 60 frames of moving
    gradients."""
    g = np.random.default_rng(7)
    t = np.linspace(0, 2 * np.pi, 60, endpoint=False)
    y, x = np.mgrid[0:8, 0:8]
    f = (np.sin(x[None] / 2 + t[:, None, None])
         + np.cos(y[None] / 3 - t[:, None, None]))
    frames = (127 * (f + 2 + 0.01 * g.standard_normal(f.shape)) / 4
              ).astype(np.float32)
    d1, _, _ = j_d1.compute_d1(frames, 4.5)
    d2, _, _ = j_d2.compute_d2(d1, 4.5, filter_size=8)
    return np.asarray(j_fc.compute_d3(d2, 4.5, thresholding=0.08)[2])


@pytest.mark.parametrize("advance", [0, 3])
@pytest.mark.parametrize("start,steps", [(5, 200), (0, 70), (40, 1)])
def test_classic_device_walk_matches_avtex(advance, start, steps):
    p3 = _p3()
    want = j_sampler.sample_texture_walk(p3, start, steps,
                                         jax.random.key(11),
                                         advance=advance)
    got = sampler.sample_texture_walk(
        torch.from_numpy(p3.copy()), start, steps,
        noise=_avtex_noise(11, steps, len(p3)), advance=advance)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if steps > 50:
        assert 0 < int(got[1].sum()) < steps


def test_classic_device_walk_from_a_generator_is_uniform():
    """Every row of a matrix with k nonzero entries per row: the choices
    from one row are uniform over them (chi-square), and a repeat with
    the same generator seed is identical."""
    n, k = 12, 5
    p = torch.zeros(n, n)
    for r in range(n):
        p[r, (r + torch.arange(1, k + 1)) % n] = torch.rand(k) + 0.1
    walks = [sampler.sample_texture_walk(
        p, 0, 600, generator=torch.Generator().manual_seed(2))
        for _ in range(2)]
    assert torch.equal(walks[0][0], walks[1][0])
    idx = walks[0][0].numpy()
    rows, nxts = idx[:-1], idx[1:]
    assert all(p[r, c] > 0 for r, c in zip(rows, nxts))
    offs = (nxts - rows) % n
    counts = np.bincount(offs, minlength=k + 1)[1:]
    exp = len(offs) / k
    chi2 = float(((counts - exp) ** 2 / exp).sum())
    assert chi2 < 18.5, counts  # dof 4: 99.9th percentile 18.47
