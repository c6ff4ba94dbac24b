"""The port's guard against torch's CPU bf16 conv3d weight gradient
(``avtex_torch/nn/resnet3d.py``: ``conv_in`` -> ``_Fp32WeightGradConv3d``).

On the CPU, oneDNN's bf16 conv3d weight gradient of a stride-2 conv on a
one-voxel input leaves the 26 taps that meet only padding holding
whatever the memory held, where they should be 0 (the last stage's
stride-2 3^3 conv of a ResNet at 16 px). ``conv_in`` takes such a conv's
weight gradient in fp32 from fp32 copies of the saved bf16 tensors and
rounds it once. These tests use ROADMAP.md's recipe: a freed buffer of
NaNs allocated and dropped before each try, so the allocator hands that
memory back. Tolerance against an fp64 evaluation: one bf16 rounding
(2^-8 relative) plus 1e-5 of the largest entry for the fp32 sums. The
forward and the input gradient are torch's own, bit for bit. One epoch
of ``train_video`` at avtex's default batch (704 clips a step) on a
width-8 ResNet10 at 16 px ends with a finite loss.
"""

import functools

import numpy as np
import pytest
import torch
from torch import nn

from avtex_torch.config import Config
from avtex_torch.contrastive.model import ContrastiveTextures
from avtex_torch.nn.resnet3d import _needs_fp32_weight_grad, conv_in
from avtex_torch.train import train_video
from test_torch_train import _video

torch.set_num_threads(1)

TRIES = 6
BF16_REL = 2.0 ** -8
SUM_ABS = 1e-5


def _nan_buffer_dropped(numel: int = 1 << 20) -> None:
    junk = torch.full((numel,), float("nan"), dtype=torch.bfloat16)
    del junk


def _one_voxel_conv():
    torch.manual_seed(0)
    return nn.Conv3d(32, 64, 3, 2, padding=1, bias=False).to(torch.bfloat16)


def test_padding_taps_are_zero_and_the_gradient_is_right():
    conv = _one_voxel_conv()
    g = torch.Generator().manual_seed(1)
    mask = torch.ones(3, 3, 3, dtype=torch.bool)
    mask[1, 1, 1] = False  # the one tap that meets the input
    for i in range(TRIES):
        _nan_buffer_dropped()
        x = torch.randn(32, 32, 1, 1, 1, generator=g).to(torch.bfloat16)
        up = torch.randn(32, 64, 1, 1, 1, generator=g).to(torch.bfloat16)
        conv.weight.grad = None
        conv_in(conv, x).backward(up)
        gw = conv.weight.grad
        assert gw.dtype == torch.bfloat16
        assert bool((gw[:, :, mask] == 0).all()), i
        want = torch.nn.grad.conv3d_weight(
            x.double(), conv.weight.shape, up.double(), 2, 1)
        err = (gw.double() - want).abs()
        bound = BF16_REL * want.abs() + SUM_ABS * float(want.abs().max())
        assert bool((err <= bound).all()), (i, float(err.max()))


def test_forward_and_input_gradient_are_torchs():
    conv = _one_voxel_conv()
    g = torch.Generator().manual_seed(2)
    for shape in ((4, 32, 1, 1, 1), (2, 32, 3, 5, 4)):
        x = torch.randn(shape, generator=g).to(torch.bfloat16)
        xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
        ya, yb = conv_in(conv, xa), conv(xb)
        assert torch.equal(ya, yb)
        up = torch.randn(ya.shape, generator=g).to(torch.bfloat16)
        ya.backward(up)
        yb.backward(up)
        assert torch.equal(xa.grad, xb.grad)


def test_the_guard_is_for_strided_bf16_cpu_convs_under_grad():
    conv = _one_voxel_conv()
    x = torch.zeros(1, 32, 2, 2, 2, dtype=torch.bfloat16)
    assert _needs_fp32_weight_grad(conv, x)
    with torch.no_grad():
        assert not _needs_fp32_weight_grad(conv, x)
    # a tensor on another device (here "meta", as a CUDA tensor) keeps
    # the conv's own path
    assert not _needs_fp32_weight_grad(conv, x.to("meta"))
    assert not _needs_fp32_weight_grad(conv.float(), x.float())
    assert not _needs_fp32_weight_grad(
        nn.Conv3d(32, 8, 3, 1, 1).to(torch.bfloat16), x)
    assert not _needs_fp32_weight_grad(
        nn.Conv2d(32, 8, 3, 2, 1).to(torch.bfloat16), x[:, :, 0])


def test_train_video_at_16_px_has_a_finite_loss(monkeypatch):
    """avtex's default ``-bs 32 -negs 20`` on a width-8 ResNet10 at 16 px:
    one epoch of two steps, its last stage's stride-2 conv on one voxel,
    after a dropped NaN buffer."""
    from avtex_torch.train import loop
    monkeypatch.setattr(loop, "ContrastiveTextures", functools.partial(
        ContrastiveTextures, width=8))
    cfg = Config(enc_arch="resnet10", img_size=16, window=4, stride=2,
                 train_stride=1, epochs=1, seed=0, early_stop_loss=1e-9)
    _nan_buffer_dropped(1 << 24)
    state, hist = train_video(cfg, _video(t=70, h=16, w=16), device="cpu")
    assert state.step == 2 and len(hist) == 1
    assert np.isfinite(hist).all()
    for name, p in state.params.items():
        assert bool(torch.isfinite(p).all()), name


@pytest.mark.parametrize("stride", [1, 2])
def test_guarded_weight_gradient_matches_fp64_on_larger_inputs(stride):
    """Away from the fault too, the guarded gradient is one rounding of
    the exact one."""
    torch.manual_seed(3)
    conv = nn.Conv3d(8, 16, 3, stride, padding=1,
                     bias=False).to(torch.bfloat16)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 8, 4, 6, 6, generator=g).to(torch.bfloat16)
    y = conv_in(conv, x)
    up = torch.randn(y.shape, generator=g).to(torch.bfloat16)
    y.backward(up)
    want = torch.nn.grad.conv3d_weight(x.double(), conv.weight.shape,
                                       up.double(), stride, 1)
    err = (conv.weight.grad.double() - want).abs()
    bound = BF16_REL * want.abs() + SUM_ABS * float(want.abs().max())
    if stride == 2:
        assert bool((err <= bound).all()), float(err.max())
    else:  # stride 1 keeps oneDNN's bf16 gradient: finite, near exact
        assert bool(torch.isfinite(conv.weight.grad).all())
        assert float(err.max()) <= 2e-2 * float(want.abs().max())
