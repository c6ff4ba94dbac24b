"""Tests that need an NVIDIA GPU (marked ``cuda``; they skip elsewhere).

On a machine with a card, without JAX installed::

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

The kernel is held against its plain version on the same bf16 inputs:
that version accumulates in fp32 and rounds once, like the kernel, so the
two differ by the accumulation order and one bf16 rounding of the output
(tolerance 2e-2 relative + 2e-2 absolute, as tests/test_fused_matmul.py).
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(M, K, N, residual, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(M, K, generator=g).to(device, torch.bfloat16)
    w = (torch.randn(N, K, generator=g) * K ** -0.5).to(device,
                                                        torch.bfloat16)
    scale = (torch.rand(N, generator=g) + 0.5).to(device)
    bias = (torch.randn(N, generator=g) * 0.1).to(device)
    r = (torch.randn(M, N, generator=g).to(device, torch.bfloat16)
         if residual else None)
    return x, w, scale, bias, r


@pytest.mark.parametrize("M,K,N,residual,relu", [
    (1000, 320, 128, False, True),      # ragged M
    (392 * 3, 1280, 2048, False, False),
    (777, 128, 512, True, True),
    (300, 104, 200, True, True),        # K not a multiple of the k slab
    (129, 24, 200, False, True),        # K < k slab, N not a multiple of 128
])
def test_kernel_matches_plain_version(cuda, M, K, N, residual, relu):
    from avtex_torch.ops import fused_matmul
    x, w, scale, bias, r = _operands(M, K, N, residual, cuda)
    before = fused_matmul.launches
    got = fused_matmul.fused_conv1x1(x, w, scale, bias, r, relu)
    torch.cuda.synchronize()
    assert fused_matmul.launches == before + 1
    want = fused_matmul.fused_conv1x1_reference(x, w, scale, bias, r, relu)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_kernel_refuses_float32_on_cuda(cuda):
    from avtex_torch.ops import fused_conv1x1
    x, w, scale, bias, _ = _operands(64, 32, 16, False, cuda)
    with pytest.raises(TypeError):
        fused_conv1x1(x.float(), w.float(), scale, bias)



@pytest.mark.parametrize("K,N,offset", [
    (100, 200, 0),      # K % 8 != 0
    (24, 9, 0),         # odd N
    (24, 200, 1),       # x starts 2 bytes past a 16-byte boundary
])
def test_kernel_refuses_shapes_it_does_not_take(cuda, K, N, offset):
    from avtex_torch.ops import fused_matmul
    x, w, scale, bias, _ = _operands(65, K, N, False, cuda)
    x = x.view(-1)[offset:offset + 64 * K].view(64, K)
    before = fused_matmul.launches
    with pytest.raises(ValueError):
        fused_matmul.fused_conv1x1(x, w, scale, bias)
    assert fused_matmul.launches == before
