"""The classic chain sharded by row blocks
(avtex_torch/classic/sharded.py::classic_transition_matrix_sharded)
against avtex's ``classic_transition_matrix``, on the CPU.

avtex's own test geometry (tests/test_parallel.py::
test_classic_sharded_matches_fused): 60 x 48 features, ``filter_size=8``,
so m = 53 rows, which pad over 2 and 4 shards (27 and 14 rows a shard);
plain with ``thresholding=0.5`` and ``normalize=True`` with the default.
The port runs in gloo worlds of 2 and 4 processes
(tests/torch_dist_worker.py) and at world size 1 in this process: P3
within rtol 1e-4 / atol 1e-5 of avtex's, on every rank, and the value
iteration stops after as many sweeps as the port's unsharded
``anticipated_future_cost`` (at world size 1, P3 is bit-identical to the
port's ``classic_transition_matrix``).
"""

import numpy as np
import pytest
import torch

from avtex.classic import classic_transition_matrix as jax_classic
from avtex_torch.classic import (anticipated_future_cost,
                                 classic_transition_matrix,
                                 classic_transition_matrix_sharded,
                                 diagonal_filter_smooth, pairwise_l2)

from torch_dist_worker import run_world

torch.set_num_threads(1)

CASES = {"plain": dict(sigma_factor=4.5, filter_size=8, thresholding=0.5),
         "normalize": dict(sigma_factor=4.5, filter_size=8, normalize=True)}


def _feats():
    return np.random.default_rng(3).standard_normal((60, 48)).astype(
        np.float32)


def _port_sweeps(feats, kw):
    d1 = pairwise_l2(torch.from_numpy(feats),
                     normalize=kw.get("normalize", False))
    d2 = diagonal_filter_smooth(d1, kw["filter_size"])
    return anticipated_future_cost(d2, return_sweeps=True)[1]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    feats = _feats()
    tmp = tmp_path_factory.mktemp("classic")
    out = {}
    for world in (2, 4):
        jobs = [("classic", dict(shape=None, feats=feats, kwargs=kw))
                for kw in CASES.values()]
        out[world] = dict(zip(CASES, run_world(tmp, world, jobs)))
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_classic_matches_avtex(worlds, world, case):
    feats, kw = _feats(), CASES[case]
    want = np.asarray(jax_classic(feats, **kw))
    sweeps = _port_sweeps(feats, kw)
    assert sweeps > 1
    assert want.shape == (53, 53)
    for r in worlds[world][case]:
        assert r["p3"].shape == want.shape
        np.testing.assert_allclose(r["p3"], want, rtol=1e-4, atol=1e-5)
        assert r["sweeps"] == sweeps
        np.testing.assert_array_equal(r["p3"], worlds[world][case][0]["p3"])


@pytest.mark.parametrize("case", list(CASES))
def test_world_of_one_is_the_unsharded_chain(case):
    from avtex_torch.parallel import make_mesh, shutdown
    feats, kw = torch.from_numpy(_feats()), CASES[case]
    mesh = make_mesh(device="cpu")
    try:
        got, sweeps = classic_transition_matrix_sharded(
            feats, mesh, return_sweeps=True, **kw)
    finally:
        shutdown()
    assert torch.equal(got, classic_transition_matrix(feats, **kw))
    assert sweeps == _port_sweeps(feats.numpy(), kw)
