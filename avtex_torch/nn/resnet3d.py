"""3D ResNet video encoders and the norm layers of every 3D encoder (the
port of avtex/nn/resnet3d.py).

- ``ResNet3D`` with ``BasicBlock3D`` / ``Bottleneck3D``: the reference's
  r3d family (conv1 7^3 with spatial stride (1,2,2), a 3^3 stride-2 max
  pool, stage strides 2 from the second stage, global average pool);
  ``resnet3d10/18/34/50``. The stem has 64 channels whatever ``width``
  is, as in avtex. ``forward`` takes avtex's ``[B, T, H, W, 3]`` clips;
  inside, NCDHW tensors in ``channels_last_3d`` memory. Module names
  follow the flax tree (``Conv_k``, ``Affine_k`` / ``GroupNorm_k``,
  ``BasicBlock3D_i`` / ``Bottleneck3D_i``), so ``avtex_torch.convert``
  carries avtex's parameters over.
- Training memory. With ``remat`` (avtex's field, for training) each
  residual block runs under activation checkpointing (``run_block``), and
  so does the stem (conv, norm, ReLU, pool; ``run_stem``), in chunks of
  clips. ``REMAT_POLICY`` (avtex's name, read at call time by every
  encoder with ``remat``) says what a block keeps besides its input:
  ``None`` nothing (avtex's default), ``"conv_out"`` the output of every
  conv, so that only the norm/ReLU tail is recomputed (avtex's
  ``save_only_these_names("conv_out")``). The stems are checkpointed
  whatever the policy, keeping their conv outputs and recomputing their
  norm, ReLU and pool (avtex checkpoints none). Unchecked, their
  full-batch activations and gradients do not fit avtex's default batch;
  keeping nothing, ResNet3D's 7^3 conv on 3 channels over every frame
  runs twice, a quarter of a step (measured on an H100, PERF.md). The
  names do not change.
- ``Affine``: folded frozen-BatchNorm, ``x * scale + bias`` per channel in
  the activation dtype; parameters stay float32.
- ``GroupNorm``: flax's GroupNorm semantics — ``num_groups = min(32, ch)``,
  ``eps = 1e-6`` (torch defaults to 1e-5), statistics in float32, output in
  the activation dtype, or in float32 under ``GN_F32_OUT`` (avtex's
  switch, read at call time; ``gn_dtype``). For its backward it keeps its
  input in the activation dtype and the fp32 mean and rstd, never an fp32
  copy of the activation.
- ``max_pool3d``: the stems' max pool with a deterministic backward that
  keeps no index tensor between the passes.

Both norms act on channel dim 1 (NCDHW, any memory format).
"""

from __future__ import annotations

import functools
import itertools
from typing import Callable, Sequence, Tuple, Type

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from avtex_torch.utils.batching import row_chunks

# GroupNorm's output dtype switch (``gn_dtype``): True returns fp32, as
# avtex's pre-bf16 GroupNorm did. Read at call time.
GN_F32_OUT = False

# What a checkpointed block keeps for its backward, read at call time by
# every encoder with ``remat`` (ResNet3D, ResNeXt3D, SlowFastR50): None
# keeps nothing and recomputes the whole block; "conv_out" keeps every
# conv's output and recomputes only the norm/ReLU tail (avtex's
# ``save_only_these_names("conv_out")`` over the outputs it tags with
# ``_tag_conv``).
REMAT_POLICY = None

# Under remat the stem runs in chunks of clips, each checkpointed on its
# own, so that no more than this many elements of stem activation (its
# conv output, before the pool) are live at once in the recomputation
# and the backward: 1 GiB in bf16, 2 GiB per fp32 transient.
STEM_CHUNK_ELEMENTS = 2 ** 29

# GroupNorm runs in chunks of samples of at most this many elements, so
# that each of its fp32 transients (the upcast input and output, and in
# the backward the upcast gradient and the input's gradient) stays
# within 1 GiB; so does max_pool3d's backward (its fp32 sums).
GN_CHUNK_ELEMENTS = 2 ** 28

# every conv of the encoders reaches the dispatcher as aten.convolution
_CONV_OPS = frozenset({torch.ops.aten.convolution.default})


def _save_conv_outputs(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op in _CONV_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _conv_out_contexts():
    return create_selective_checkpoint_contexts(_save_conv_outputs)


def run_block(block: nn.Module, x: torch.Tensor, remat: bool
              ) -> torch.Tensor:
    """``block(x)``, under activation checkpointing when ``remat`` and a
    backward can follow (grad enabled), keeping what ``REMAT_POLICY``
    says."""
    if not (remat and torch.is_grad_enabled()):
        return block(x)
    if REMAT_POLICY is None:
        return torch.utils.checkpoint.checkpoint(block, x,
                                                 use_reentrant=False)
    if REMAT_POLICY == "conv_out":
        return torch.utils.checkpoint.checkpoint(
            block, x, use_reentrant=False, context_fn=_conv_out_contexts)
    raise ValueError(f"unknown REMAT_POLICY {REMAT_POLICY!r}; have None, "
                     "'conv_out'")


def run_stem(stem: Callable, inputs: Tuple[torch.Tensor, ...], remat: bool,
             clip_elements: int):
    """``stem(*inputs)``; under ``remat`` with grad enabled, in chunks of
    clips (dim 0), each under activation checkpointing that keeps the
    chunk's inputs and its conv outputs (module docstring), the outputs
    concatenated. ``clip_elements`` is the stem activation's size per
    clip, which sets the chunk (``STEM_CHUNK_ELEMENTS``). Every op of a
    stem acts clip by clip, so the forward is the same; the weights'
    gradients sum the chunks'."""
    if not (remat and torch.is_grad_enabled()):
        return stem(*inputs)
    outs = [torch.utils.checkpoint.checkpoint(
        stem, *(x[rows] for x in inputs), use_reentrant=False,
        context_fn=_conv_out_contexts)
        for rows in row_chunks(len(inputs[0]), clip_elements,
                               STEM_CHUNK_ELEMENTS)]
    if len(outs) == 1:
        return outs[0]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


class _Fp32WeightGradConv3d(torch.autograd.Function):
    """``F.conv3d`` without bias whose weight gradient is summed in fp32
    from fp32 copies of the saved bf16 input and output gradient, then
    rounded to bf16 once. The forward and the input gradient are torch's
    own.

    This works around torch's CPU backend, and is no difference from
    avtex: oneDNN's bf16 conv3d weight gradient of a strided conv on a
    one-voxel input leaves the taps that meet only padding holding
    whatever the memory held, where they should be 0 (the last stage's
    stride-2 conv of a ResNet at 16 px; ROADMAP.md, "Not faults").
    ``conv_in`` takes this route for CPU tensors only."""

    @staticmethod
    def forward(ctx, x, weight, stride, padding, groups):
        ctx.save_for_backward(x, weight)
        ctx.geometry = (stride, padding, groups)
        return F.conv3d(x, weight, None, stride, padding, 1, groups)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, padding, groups = ctx.geometry
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv3d_input(x.shape, weight, grad, stride,
                                            padding, 1, groups)
        if ctx.needs_input_grad[1]:
            gw = torch.nn.grad.conv3d_weight(
                x.float(), weight.shape, grad.float(), stride, padding, 1,
                groups).to(weight.dtype)
        return gx, gw, None, None, None


def _needs_fp32_weight_grad(conv: nn.Module, x: torch.Tensor) -> bool:
    """A bf16 strided ``nn.Conv3d`` (no bias, no dilation: the encoders'
    convs) on a CPU tensor whose weight gradient would be taken
    (``_Fp32WeightGradConv3d``)."""
    return (isinstance(conv, nn.Conv3d) and x.device.type == "cpu"
            and conv.weight.dtype == torch.bfloat16
            and max(conv.stride) > 1 and conv.bias is None
            and max(conv.dilation) == 1
            and torch.is_grad_enabled() and conv.weight.requires_grad)


def conv_in(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` with ``x`` cast to the conv's weight dtype, as flax's
    ``nn.Conv(dtype=...)`` casts its input (under ``GN_F32_OUT`` a norm's
    fp32 output reaches a bf16 conv). On the CPU a bf16 strided 3D conv
    takes its weight gradient in fp32 (``_Fp32WeightGradConv3d``); CUDA
    tensors take ``conv(x)`` as it is."""
    x = x.to(conv.weight.dtype)
    if _needs_fp32_weight_grad(conv, x):
        return _Fp32WeightGradConv3d.apply(x, conv.weight, conv.stride,
                                           conv.padding, conv.groups)
    return conv(x)


class _MaxPool3d(torch.autograd.Function):
    """``F.max_pool3d`` whose backward is deterministic and keeps no index
    tensor between the passes: it recomputes torch's argmax indices (the
    first position holding each window's max) and adds each window's
    gradient there in fp32, one class of windows at a time. Windows ``o``
    and ``o + m`` of a dim are disjoint once ``m * stride >= kernel``, so
    within a class of ``o mod m`` no two windows share a position and no
    two adds meet; the classes come in a fixed order. CUDA's own
    backward adds with atomics in the input dtype, in any order. In chunks
    of samples (``GN_CHUNK_ELEMENTS``), which bound the fp32 sums."""

    @staticmethod
    def forward(ctx, x, kernel, stride, padding):
        ctx.save_for_backward(x)
        ctx.geometry = (kernel, stride, padding)
        return F.max_pool3d(x, kernel, stride, padding)

    @staticmethod
    def backward(ctx, grad):
        x, = ctx.saved_tensors
        kernel, stride, padding = ctx.geometry
        period = [-(-k // s) for k, s in zip(kernel, stride)]
        gx = torch.empty_like(x)
        for rows in row_chunks(len(x), x[0].numel(), GN_CHUNK_ELEMENTS):
            xc = x[rows]
            with torch.no_grad():
                _, idx = F.max_pool3d(xc, kernel, stride, padding,
                                      return_indices=True)
            n, c = xc.shape[:2]
            acc = torch.zeros((n, c, xc[0, 0].numel()), device=x.device,
                              dtype=torch.promote_types(x.dtype,
                                                        torch.float32))
            for start in itertools.product(*(range(m) for m in period)):
                cls = (slice(None), slice(None)) + tuple(
                    slice(j, None, m) for j, m in zip(start, period))
                acc.scatter_add_(2, idx[cls].reshape(n, c, -1),
                                 grad[rows][cls].reshape(n, c, -1).to(
                                     acc.dtype))
            gx[rows] = acc.view(xc.shape)
        return gx, None, None, None


def max_pool3d(x: torch.Tensor, kernel, stride, padding) -> torch.Tensor:
    """``F.max_pool3d(x, kernel, stride, padding)`` (no dilation, floor
    mode) with ``_MaxPool3d``'s backward; sizes are ints or triples."""
    def triple(v):
        return tuple(v) if isinstance(v, (tuple, list)) else (v,) * 3
    return _MaxPool3d.apply(x, triple(kernel), triple(stride),
                            triple(padding))


def _per_channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.to(x.dtype).view((1, -1) + (1,) * (x.ndim - 2))


class Affine(nn.Module):
    """Folded frozen-BatchNorm: y = x*scale + bias, per channel."""

    def __init__(self, ch: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * _per_channel(self.scale, x) + _per_channel(self.bias, x)


def gn_dtype(dtype: torch.dtype) -> torch.dtype:
    """GroupNorm's output dtype for activations in ``dtype``: ``dtype``,
    or float32 under ``GN_F32_OUT``. The statistics are fp32 either
    way."""
    return torch.float32 if GN_F32_OUT else dtype


def _gn_format(x: torch.Tensor) -> torch.memory_format:
    """The memory format ``F.group_norm`` hands its kernels for input
    ``x``: the input's own on the CPU (channels-last kept), contiguous
    elsewhere."""
    cl = {4: torch.channels_last, 5: torch.channels_last_3d}.get(x.dim())
    if (x.device.type == "cpu" and cl is not None and not x.is_contiguous()
            and x.is_contiguous(memory_format=cl)):
        return cl
    return torch.contiguous_format


class _GroupNormFn(torch.autograd.Function):
    """``F.group_norm(x.float(), ...).to(out_dtype)`` that keeps ``x`` in
    its own dtype and the fp32 mean and rstd for the backward, which
    upcasts ``x`` again: bf16 -> fp32 is exact, so the gradients are those
    of the fp32 GroupNorm, bit for bit. Both directions run in chunks of
    samples (``GN_CHUNK_ELEMENTS``), which bounds the fp32 transients: the
    statistics, the output and the input's gradient are per sample and
    come out the same; the weight and bias gradients sum the chunks'."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, out_dtype):
        c = x.shape[1]
        hw = x[0].numel() // max(1, c)
        ctx.fmt, ctx.groups = _gn_format(x), groups
        y = torch.empty_like(x, dtype=out_dtype, memory_format=ctx.fmt)
        stats = []
        for rows in row_chunks(len(x), x[0].numel(), GN_CHUNK_ELEMENTS):
            xc = x[rows].float().contiguous(memory_format=ctx.fmt)
            yc, mean, rstd = torch.native_group_norm(
                xc, weight, bias, len(xc), c, hw, groups, eps)
            y[rows] = yc
            stats.append((mean, rstd))
        mean, rstd = (torch.cat(t) for t in zip(*stats))
        ctx.save_for_backward(x, weight, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, grad):
        x, weight, mean, rstd = ctx.saved_tensors
        c = x.shape[1]
        hw = x[0].numel() // max(1, c)
        mask = list(ctx.needs_input_grad[:3])
        dx = (torch.empty_like(x, memory_format=ctx.fmt) if mask[0]
              else None)
        dw = db = None
        for rows in row_chunks(len(x), x[0].numel(), GN_CHUNK_ELEMENTS):
            xc = x[rows].float().contiguous(memory_format=ctx.fmt)
            dxc, dwc, dbc = torch.ops.aten.native_group_norm_backward(
                grad[rows].float().contiguous(memory_format=ctx.fmt), xc,
                mean[rows], rstd[rows], weight, len(xc), c, hw, ctx.groups,
                mask)
            if dx is not None:
                dx[rows] = dxc
            dw = dwc if dw is None else dw + dwc
            db = dbc if db is None else db + dbc
        return dx, dw, db, None, None, None


class GroupNorm(nn.GroupNorm):
    """flax-compatible GroupNorm (min(32, ch) groups, eps 1e-6, fp32 stats,
    output dtype ``gn_dtype``)."""

    def __init__(self, ch: int):
        super().__init__(min(32, ch), ch, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _GroupNormFn.apply(x, self.weight, self.bias, self.num_groups,
                                  self.eps, gn_dtype(x.dtype))


def make_norm(kind: str, ch: int) -> nn.Module:
    """``"affine"`` or ``"group"`` norm for ``ch`` channels."""
    if kind == "affine":
        return Affine(ch)
    if kind == "group":
        return GroupNorm(ch)
    raise ValueError(f"unknown norm {kind!r}; have 'affine', 'group'")


def norm_prefix(kind: str) -> str:
    """Module-name prefix of a norm kind (matches the flax param tree)."""
    return "Affine" if kind == "affine" else "GroupNorm"


def _conv(cin: int, cout: int, k: int,
          stride: Tuple[int, int, int] = (1, 1, 1),
          groups: int = 1) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, k, stride, padding=k // 2, groups=groups,
                     bias=False)


class _Block(nn.Module):
    """Conv/norm pairs ``Conv_k`` + ``{Affine,GroupNorm}_k``, ReLU between
    them, a projection shortcut when the shape changes, ReLU after the
    residual add."""

    def _pairs(self, norm: str, specs, conv=None) -> None:
        self.norm = norm
        for i, (cin, cout, k, stride, groups) in enumerate(specs):
            self.add_module(f"Conv_{i}",
                            (conv or _conv)(cin, cout, k, stride, groups))
            self.add_module(f"{norm_prefix(norm)}_{i}", make_norm(norm, cout))

    def _conv_norm(self, i: int, x: torch.Tensor) -> torch.Tensor:
        y = conv_in(getattr(self, f"Conv_{i}"), x)
        return getattr(self, f"{norm_prefix(self.norm)}_{i}")(y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for i in range(self.n_main):
            y = self._conv_norm(i, y)
            if i < self.n_main - 1:
                y = torch.relu(y)
        r = self._conv_norm(self.n_main, x) if self.need_proj else x
        return torch.relu(y + r.to(y.dtype))


class BasicBlock3D(_Block):
    """Two 3^3 convs (the first strided)."""

    expansion = 1

    def __init__(self, in_ch: int, features: int,
                 stride: Tuple[int, int, int] = (1, 1, 1),
                 norm: str = "group", groups: int = 1):
        super().__init__()
        self.n_main = 2
        self.need_proj = in_ch != features or stride != (1, 1, 1)
        specs = [(in_ch, features, 3, stride, 1),
                 (features, features, 3, (1, 1, 1), 1)]
        if self.need_proj:
            specs.append((in_ch, features, 1, stride, 1))
        self._pairs(norm, specs)


class Bottleneck3D(_Block):
    """1^3 reduce, 3^3 (strided, ``groups``), 1^3 expand by 4."""

    expansion = 4

    def __init__(self, in_ch: int, features: int,
                 stride: Tuple[int, int, int] = (1, 1, 1),
                 norm: str = "group", groups: int = 1):
        super().__init__()
        out_ch = features * self.expansion
        self.n_main = 3
        self.need_proj = in_ch != out_ch or stride != (1, 1, 1)
        specs = [(in_ch, features, 1, (1, 1, 1), 1),
                 (features, features, 3, stride, groups),
                 (features, out_ch, 1, (1, 1, 1), 1)]
        if self.need_proj:
            specs.append((in_ch, out_ch, 1, stride, 1))
        self._pairs(norm, specs)


class ResNet3D(nn.Module):
    """Video encoder on ``[B, T, H, W, 3]`` clips; returns ``[B, feat_dim]``
    float32. Conv weights and activations in ``dtype``; norm parameters
    float32. ``remat`` checkpoints the stem and each residual block
    (training memory; module docstring)."""

    def __init__(self, block: Type[_Block] = BasicBlock3D,
                 layers: Sequence[int] = (2, 2, 2, 2), groups: int = 1,
                 width: int = 64, dtype: torch.dtype = torch.bfloat16,
                 norm: str = "group", remat: bool = False):
        super().__init__()
        self.dtype, self.norm, self.remat = dtype, norm, remat
        self.Conv_0 = nn.Conv3d(3, 64, 7, (1, 2, 2), padding=3, bias=False)
        self.add_module(f"{norm_prefix(norm)}_0", make_norm(norm, 64))
        in_ch, idx = 64, 0
        for i, n_blocks in enumerate(layers):
            feats = width * (2 ** i)
            for j in range(n_blocks):
                stride = (2, 2, 2) if (i > 0 and j == 0) else (1, 1, 1)
                self.add_module(f"{block.__name__}_{idx}", block(
                    in_ch, feats, stride, norm, groups))
                in_ch = feats * block.expansion
                idx += 1
        self.n_blocks = idx
        self.block_name = block.__name__
        self.feat_dim = width * 8 * block.expansion
        for m in self.modules():
            if isinstance(m, nn.Conv3d):
                m.weight.data = m.weight.data.to(dtype)

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        x = getattr(self, f"{norm_prefix(self.norm)}_0")(self.Conv_0(x))
        return max_pool3d(torch.relu(x), 3, 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 4, 1, 2, 3).contiguous(
            memory_format=torch.channels_last_3d)
        t, h, w = x.shape[2:]
        clip = 64 * t * ((h + 1) // 2) * ((w + 1) // 2)
        x = run_stem(self._stem, (x,), self.remat, clip)
        for i in range(self.n_blocks):
            x = run_block(getattr(self, f"{self.block_name}_{i}"), x,
                          self.remat)
        # avtex averages in the compute dtype, then casts to float32
        return x.mean(dim=(2, 3, 4)).float()


resnet3d10 = functools.partial(ResNet3D, block=BasicBlock3D,
                               layers=(1, 1, 1, 1))
resnet3d18 = functools.partial(ResNet3D, block=BasicBlock3D,
                               layers=(2, 2, 2, 2))
resnet3d34 = functools.partial(ResNet3D, block=BasicBlock3D,
                               layers=(3, 4, 6, 3))
resnet3d50 = functools.partial(ResNet3D, block=Bottleneck3D,
                               layers=(3, 4, 6, 3))
