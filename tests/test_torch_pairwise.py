"""D1's all-pairs distance in the port (avtex_torch/ops/pairwise.py) against
avtex's XLA version (avtex.classic.d1.pairwise_l2) and its Pallas kernel
run in interpret mode (as tests/test_ops.py runs it), on the same numpy
rows.

On the CPU the port's ``pairwise_l2`` is its plain Gram-form version; the
CUDA kernel itself is held against that version on the card
(tests/test_torch_cuda.py, chip_smoke.py). Tolerances as
tests/test_classic.py: the Gram form cancels ~|x|^2 * eps, so raw rows
get rtol 1e-4 / atol 1e-2, unit rows atol 1e-5.
"""

import numpy as np
import pytest
import torch

from avtex.classic.d1 import pairwise_l2 as jax_pairwise_l2
from avtex.ops import pairwise_l2_pallas
from avtex_torch.ops import pairwise
from avtex_torch.ops.pairwise import pairwise_l2, pairwise_l2_reference

torch.set_num_threads(1)

CASES = {
    # name: (shape, normalize, rows)
    "raw": ((37, 75), False, "normal"),
    "normalized": ((20, 600), True, "normal"),
    # ragged across avtex's 128-row / 512-feature tiles, RGB magnitudes
    "ragged_rgb": ((130, 1030), False, "rgb"),
}


def _rows(shape, kind, seed=0):
    g = np.random.default_rng(seed)
    if kind == "rgb":
        return g.integers(0, 256, shape).astype(np.float32)
    return g.standard_normal(shape).astype(np.float32)


def _avtex(x, normalize, impl):
    if impl == "xla":
        return np.asarray(jax_pairwise_l2(x, normalize=normalize))
    return np.asarray(pairwise_l2_pallas(x, normalize=normalize,
                                         interpret=True))


@pytest.mark.parametrize("port_fn", [pairwise_l2, pairwise_l2_reference],
                         ids=["pairwise_l2", "reference"])
@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pairwise_l2_matches_avtex(case, impl, port_fn):
    shape, normalize, kind = CASES[case]
    x = _rows(shape, kind)
    want = _avtex(x, normalize, impl)
    before = pairwise.launches
    got = port_fn(torch.from_numpy(x), normalize=normalize).numpy()
    assert pairwise.launches == before  # the CPU never reaches the kernel
    assert got.shape == want.shape == (shape[0], shape[0])
    assert got.dtype == np.float32
    atol = 1e-5 if normalize else 1e-2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)
    assert np.all(np.diag(got) == 0.0)


def test_pairwise_l2_flattens_frames_like_avtex():
    """[N, H, W, C] frames are rows of H*W*C features, as in avtex."""
    frames = _rows((9, 4, 5, 3), "rgb", seed=1)
    got = pairwise_l2(torch.from_numpy(frames)).numpy()
    want = np.asarray(jax_pairwise_l2(frames))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)


def test_kernel_launch_refuses_cpu_tensors():
    """The kernel entry takes CUDA tensors only; a CPU tensor there raises
    instead of running anything."""
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        pairwise.pairwise_l2_gram(x, (x * x).sum(1))
    with pytest.raises(ValueError, match="one row"):
        pairwise_l2(torch.zeros(0, 8))
