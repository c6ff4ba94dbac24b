"""The port's fused_conv1x1 (avtex_torch/ops/fused_matmul.py) against
avtex's Pallas kernel in interpret mode and its jnp reference.

On the CPU the port's wrapper runs its plain version; the CUDA kernel is
held against that plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avtex.ops.fused_matmul import _jnp_reference, fused_conv1x1 as jax_fused
from avtex_torch.ops import fused_matmul as port_mod
from avtex_torch.ops import fused_conv1x1, fused_conv1x1_reference

torch.set_num_threads(1)

# Every (K, N) the SlowFast-R50 main path sends to the kernel
# (avtex_torch/nn/slowfast.py, width 64): res3 conv1 (block 0, then the
# rest), res3 projection, conv3 of res3/res4/res5, res4/res5 projections,
# the fast pathway's res5 projection.
MAIN_PATH_KN = [(320, 128), (512, 128), (320, 512), (128, 512), (640, 1024),
                (256, 1024), (1280, 2048), (512, 2048), (128, 256)]


def _inputs(M, K, N, residual, seed=0):
    g = np.random.default_rng(seed)
    x = g.standard_normal((M, K)).astype(np.float32)
    w = (g.standard_normal((K, N)) * 0.1).astype(np.float32)
    scale = (g.random(N) + 0.5).astype(np.float32)
    bias = (g.standard_normal(N) * 0.1).astype(np.float32)
    r = g.standard_normal((M, N)).astype(np.float32) if residual else None
    return x, w, scale, bias, r


def _bf16_case(M, K, N, residual, relu):
    x, w, scale, bias, r = _inputs(M, K, N, residual)
    want = np.asarray(jax_fused(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(scale), jnp.asarray(bias),
        residual=None if r is None else jnp.asarray(r, jnp.bfloat16),
        relu=relu, interpret=True), dtype=np.float32)
    bf = torch.bfloat16
    got = fused_conv1x1(
        torch.from_numpy(x).to(bf), torch.from_numpy(w.T.copy()).to(bf),
        torch.from_numpy(scale), torch.from_numpy(bias),
        residual=None if r is None else torch.from_numpy(r).to(bf),
        relu=relu)
    assert got.dtype == bf and got.shape == (M, N)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("K,N", [(128, 512), (256, 1024)])
def test_port_matches_pallas_no_fold(K, N):
    _bf16_case(512, K, N, residual=True, relu=True)


@pytest.mark.parametrize("K,N,G", [(8, 32, 16), (16, 64, 8), (64, 256, 2)])
def test_port_matches_small_channels(K, N, G):
    _bf16_case(256 * G * 2, K, N, residual=True, relu=True)


def test_port_matches_no_residual_no_relu():
    _bf16_case(512, 128, 512, residual=False, relu=False)


@pytest.mark.parametrize("M,N,residual", [(8 * 49, 256, True),
                                          (100, 256, False)])
def test_port_matches_odd_rows(M, N, residual):
    _bf16_case(M, 128, N, residual=residual, relu=True)


@pytest.mark.parametrize("K,N", [(1280, 256), (320, 1024)])
def test_port_matches_non_pow2_k(K, N):
    _bf16_case(512, K, N, residual=True, relu=True)


@pytest.mark.parametrize("K,N", MAIN_PATH_KN)
@pytest.mark.parametrize("residual,relu", [(True, True), (False, True),
                                           (False, False)])
def test_port_matches_main_path_shapes(K, N, residual, relu):
    """The main path's (K, N) pairs at a small M, through Pallas."""
    _bf16_case(64, K, N, residual=residual, relu=relu)


@pytest.mark.parametrize("M,K,N,residual,relu", [
    (392, 128, 256, True, True), (100, 320, 128, False, True),
    (64, 1280, 2048, False, False), (37, 20, 13, True, True)])
def test_fp32_matches_jnp_reference(M, K, N, residual, relu):
    x, w, scale, bias, r = _inputs(M, K, N, residual, seed=1)
    want = np.asarray(_jnp_reference(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
        jnp.asarray(bias), None if r is None else jnp.asarray(r), relu))
    got = fused_conv1x1(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                        torch.from_numpy(scale), torch.from_numpy(bias),
                        None if r is None else torch.from_numpy(r), relu)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cpu_runs_plain_version_and_counts_no_launch():
    x, w, scale, bias, r = _inputs(16, 8, 4, True)
    args = (torch.from_numpy(x), torch.from_numpy(w.T.copy()),
            torch.from_numpy(scale), torch.from_numpy(bias),
            torch.from_numpy(r))
    before = port_mod.launches
    out = fused_conv1x1(*args)
    assert port_mod.launches == before
    torch.testing.assert_close(out, fused_conv1x1_reference(*args),
                               rtol=0, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, w, scale, bias, r = _inputs(16, 8, 4, True)
    x, wt = torch.from_numpy(x), torch.from_numpy(w.T.copy())
    scale, bias = torch.from_numpy(scale), torch.from_numpy(bias)
    with pytest.raises(ValueError):            # K mismatch
        fused_conv1x1(x, wt[:, :7], scale, bias)
    with pytest.raises(ValueError):            # weight given as [K, N]
        fused_conv1x1(x, wt.t(), scale, bias)
    with pytest.raises(ValueError):            # non-contiguous x
        fused_conv1x1(x.t().contiguous().t(), wt, scale, bias)
    with pytest.raises(TypeError):             # scale not fp32
        fused_conv1x1(x, wt, scale.double(), bias)
    with pytest.raises(ValueError):            # residual shape
        fused_conv1x1(x, wt, scale, bias, residual=torch.zeros(16, 5))
    with pytest.raises(TypeError):             # mixed dtypes
        fused_conv1x1(x.bfloat16(), wt, scale, bias)


def _bottleneck_with_conv(K, N):
    """An affine SFBottleneck whose conv 0 is a 1x1 conv of K -> N."""
    from avtex_torch.nn.slowfast import SFBottleneck
    blk = SFBottleneck(8, 8, norm="affine")
    blk.Conv_0 = torch.nn.Conv3d(K, N, 1, bias=False)
    return blk


@pytest.mark.parametrize("K,N", MAIN_PATH_KN)
def test_kernel_eligible_takes_every_main_path_shape(K, N):
    assert _bottleneck_with_conv(K, N).kernel_eligible(0)


@pytest.mark.parametrize("K,N", [(128, 132), (128, 250), (136, 1028),
                                 (132, 256), (32, 512), (512, 56)])
def test_kernel_eligible_refuses_what_the_kernel_does_not_take(K, N):
    """N % 8, K % 8 (TMA's 16-byte rows) and the channel rule."""
    assert not _bottleneck_with_conv(K, N).kernel_eligible(0)
