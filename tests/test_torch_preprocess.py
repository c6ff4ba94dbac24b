"""preprocess_clip in the port (avtex_torch/data/preprocess.py) against
avtex's, on the same uint8 frames. Tolerance 1e-5: both resize with the
same float32 triangle-filter weights; only the contraction order differs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avtex.data.preprocess import _resize_clip as jax_resize
from avtex.data.preprocess import preprocess_clip as jax_preprocess
from avtex_torch.data.preprocess import _resize_clip, preprocess_clip

torch.set_num_threads(1)


def _frames(shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("slowfast", [True, False])
@pytest.mark.parametrize("hw,size", [((32, 32), 32), ((40, 40), 32),
                                     ((24, 40), 32), ((20, 20), 32)])
def test_preprocess_matches_avtex(hw, size, slowfast):
    frames = _frames((2, 3) + hw + (3,))
    want = np.asarray(jax_preprocess(jnp.asarray(frames), size=size,
                                     slowfast=slowfast))
    got = preprocess_clip(torch.from_numpy(frames), size=size,
                          slowfast=slowfast)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_identity_size_skips_the_resize():
    x = torch.rand(1, 2, 16, 16, 3)
    assert _resize_clip(x, 16) is x


@pytest.mark.parametrize("h,size", [(40, 32), (64, 16), (7, 32)])
def test_resize_weights_match_jax_image_resize(h, size):
    x = np.random.default_rng(h).random((1, h, h, 3)).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), size))
    got = _resize_clip(torch.from_numpy(x), size).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
