"""Fused 1x1 conv + folded-norm affine + residual + ReLU (Hopper CUDA kernel).

``fused_conv1x1(x, weight, scale, bias, residual, relu)`` computes
``act((x @ weight.T) * scale + bias (+ residual))`` for ``x [M, K]`` and
``weight [N, K]`` (torch's [out, in] layout, as ``F.linear`` takes it; a
1x1x1 conv weight viewed as ``[N, K]``), fp32 ``scale``/``bias [N]`` and an
optional ``residual [M, N]``.

Kernel: ``avtex_torch/csrc/fused_conv1x1.cu``. It replaces the TPU kernel
``avtex/ops/fused_matmul.py::fused_conv1x1`` (``_kernel_res`` /
``_kernel_nores``, ``pallas_call`` at line 192). On an H100 most SlowFast
bottleneck shapes are bound by device-memory bytes and the largest
projections by operations; the kernel is a persistent grid of one block
per SM over 128-row tiles in which all N-chunks of one M tile run
together (x comes from device memory once), TMA loads of x and w into a
ring of swizzled k slabs, bf16 ``wgmma`` with fp32 accumulators, and the
whole epilogue in registers before one bf16 rounding and a TMA store of
the tile, which overlaps the next tile's product.

Dispatch: a CUDA tensor launches the kernel or raises (there is no
fallback inside the wrapper, by shape or otherwise); the kernel takes
bf16, K % 8 == 0 and N % 8 == 0 (TMA's 16-byte row strides), and x,
weight, residual, scale and bias 16-byte aligned. A CPU tensor runs
``fused_conv1x1_reference``, the same expression in plain torch with an
fp32 accumulate. Which convs go to the kernel is decided by the caller
(``avtex_torch/nn/slowfast.py::SFBottleneck.kernel_eligible``), not here.

``launches`` counts the kernel launches made by this wrapper.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

launches = 0
_lib = None


def fused_conv1x1_reference(x: torch.Tensor, weight: torch.Tensor,
                            scale: torch.Tensor, bias: torch.Tensor,
                            residual: Optional[torch.Tensor] = None,
                            relu: bool = True) -> torch.Tensor:
    """Plain torch version: fp32 product and epilogue, one cast at the end."""
    y = torch.matmul(x.float(), weight.float().t())
    y = y * scale.float() + bias.float()
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("fused_conv1x1")
        fn = lib.avtex_fused_conv1x1
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(x, weight, scale, bias, residual):
    if x.ndim != 2 or weight.ndim != 2:
        raise ValueError(f"x must be [M, K] and weight [N, K]; got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    M, K = x.shape
    N = weight.shape[0]
    if weight.shape[1] != K:
        raise ValueError(f"weight {tuple(weight.shape)} does not match "
                         f"K={K} of x {tuple(x.shape)}")
    if M == 0 or N == 0 or K == 0:
        raise ValueError(f"empty operand: M={M}, N={N}, K={K}")
    if scale.shape != (N,) or bias.shape != (N,):
        raise ValueError(f"scale/bias must be [{N}]; got "
                         f"{tuple(scale.shape)}, {tuple(bias.shape)}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("scale and bias must be float32")
    if residual is not None and residual.shape != (M, N):
        raise ValueError(f"residual must be [{M}, {N}]; got "
                         f"{tuple(residual.shape)}")
    tensors = [x, weight, scale, bias] + ([] if residual is None
                                         else [residual])
    if any(t.device != x.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if any(t.dtype != x.dtype for t in (weight, residual) if t is not None):
        raise TypeError("x, weight and residual must share one dtype")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous (x [M, K] row-major, "
                         "weight [N, K] row-major)")


def fused_conv1x1(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, residual: Optional[torch.Tensor] = None,
                  relu: bool = True) -> torch.Tensor:
    """``act((x @ weight.T) * scale + bias (+ residual))`` -> [M, N].

    CUDA: bf16 x/weight/residual, fp32 scale/bias, bf16 output, launched
    on the current stream without synchronising. CPU: the plain version.
    """
    _check(x, weight, scale, bias, residual)
    if x.device.type == "cpu":
        return fused_conv1x1_reference(x, weight, scale, bias, residual, relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bfloat16 x/weight/residual, "
                        f"got {x.dtype}")
    M, K = x.shape
    N = weight.shape[0]
    if K % 8 or N % 8 or M >= 2 ** 31:
        raise ValueError(f"the CUDA kernel takes K % 8 == 0, N % 8 == 0 and "
                         f"M < 2^31; got M={M}, K={K}, N={N}")
    if any(t.data_ptr() % 16 for t in (x, weight, scale, bias, residual)
           if t is not None):
        raise ValueError("the CUDA kernel takes x, weight, residual, scale "
                         "and bias 16-byte aligned")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _kernel_lib().avtex_fused_conv1x1(
            x.data_ptr(), weight.data_ptr(), scale.data_ptr(),
            bias.data_ptr(),
            None if residual is None else residual.data_ptr(),
            out.data_ptr(), M, N, K, int(bool(relu)), stream)
    if rc != 0:
        raise RuntimeError(f"fused_conv1x1 kernel launch failed: CUDA error "
                           f"{rc} (M={M}, N={N}, K={K})")
    global launches
    launches += 1
    return out
