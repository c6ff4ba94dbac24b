"""Segment-sharded embedding, tensor-parallel layers and the DP+TP train
step (the port of avtex/parallel/sharded.py).

The embed-once pass shards the *segment* axis over ``data``: each data
rank embeds its contiguous block of the L segments (L padded to a
multiple of the data size by repeating the last window) and the blocks
are all-gathered into the ``[L, D]`` table that every rank returns.

Training shards the batch over ``data`` (the fp32 gradients all-reduced
to their mean) and the audio path's widest layers over ``model``
(Megatron-style tensor parallelism): the shared VGGish's 512-channel conv
pair (``Conv_4`` column-split, ``Conv_5`` row-split) and, in
``VideoForAudio``, the 12288x4096 / 4096x4096 ``AudioMLP`` pair
(``Dense_0`` column, ``Dense_1`` row). Each model rank holds 1/tp of
them: ``parallelize`` swaps in ``ColumnParallel`` / ``RowParallel``
layers under the same names, and ``shard_params`` / ``gather_params`` cut
a full state_dict to this rank's slices and back.

avtex's rules are written on flax's layouts (HWIO conv kernels, ``[in,
out]`` Dense kernels); torch's are OIHW and ``[out, in]``, so an output
split is torch dim 0 and an input split torch dim 1.
"""

from __future__ import annotations

import functools
import re
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from avtex_torch.device import module_device
from avtex_torch.synth.embeddings import (_batch_plan, _embed_batches,
                                          _windows_as_video)

from .mesh import axis_info

# (parameter name, torch dim split over 'model', rank of avtex's spec):
# avtex/parallel/sharded.py:34-41 on the port's names and layouts.
_TP_RULES = (
    (re.compile(r"audio_mlp.*Dense_0.*weight"), 0, 2),  # P(None, "model")
    (re.compile(r"audio_mlp.*Dense_0.*bias"), 0, 1),  # P("model")
    (re.compile(r"audio_mlp.*Dense_1.*weight"), 1, 2),  # P("model", None)
    # P(None, None, None, "model") on HWIO
    (re.compile(r"audio_encoder.*Conv_4.*weight"), 0, 4),
    (re.compile(r"audio_encoder.*Conv_4.*bias"), 0, 1),  # P("model")
    # P(None, None, "model", None) on HWIO
    (re.compile(r"audio_encoder.*Conv_5.*weight"), 1, 4),
)


def param_shardings(state_dict: Dict[str, torch.Tensor], mesh: DeviceMesh
                    ) -> Dict[str, Optional[int]]:
    """Per tensor of ``state_dict``, the dim split over ``mesh["model"]``
    (None: replicated). A split dim that the model size does not divide
    raises."""
    size = mesh["model"].size()
    out = {}
    for name, value in state_dict.items():
        out[name] = None
        for pattern, dim, rank in _TP_RULES:
            if pattern.search(name) and rank <= value.ndim:
                if value.shape[dim] % size:
                    raise ValueError(f"{name}: dim {dim} of "
                                     f"{tuple(value.shape)} does not split "
                                     f"over {size} model ranks")
                out[name] = dim
                break
    return out


def shard_params(state_dict: Dict[str, torch.Tensor], mesh: DeviceMesh
                 ) -> Dict[str, torch.Tensor]:
    """A full state_dict cut to this rank's slices (the counterpart of
    avtex's ``device_put`` with ``param_shardings``)."""
    size, rank, _ = axis_info(mesh, "model")
    out = {}
    for name, dim in param_shardings(state_dict, mesh).items():
        v = state_dict[name]
        if dim is not None:
            k = v.shape[dim] // size
            v = v.narrow(dim, rank * k, k).clone()
        out[name] = v
    return out


def gather_params(state_dict: Dict[str, torch.Tensor], mesh: DeviceMesh
                  ) -> Dict[str, torch.Tensor]:
    """This rank's slices gathered into the full state_dict (for
    ``export_params`` and checkpoints); every model rank calls it."""
    size, _, group = axis_info(mesh, "model")
    out = {}
    for name, dim in param_shardings(state_dict, mesh).items():
        v = state_dict[name]
        if dim is not None and size > 1:
            local = v.detach().float().contiguous()
            parts = [torch.empty_like(local) for _ in range(size)]
            dist.all_gather(parts, local, group=group)
            v = torch.cat(parts, dim).to(v.dtype)
        out[name] = v
    return out


# ------------------------------------------------------------------ #
# Tensor-parallel layers
# ------------------------------------------------------------------ #

def _all_reduce_fp32(x: torch.Tensor, group) -> torch.Tensor:
    y = x.to(torch.float32, memory_format=torch.contiguous_format,
             copy=True)
    dist.all_reduce(y, group=group)
    return y


class _CopyToModel(torch.autograd.Function):
    """Identity forward; backward, the gradient's all-reduce over the
    model group (in front of a column split, whose ranks each give part
    of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_fp32(grad, ctx.group).to(grad.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """Forward, the fp32 all-reduce of the partial sums over the model
    group (after a row split); identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        return _all_reduce_fp32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


def _functional(full: nn.Module) -> Callable:
    if isinstance(full, nn.Conv2d):
        if full.groups != 1 or full.padding_mode != "zeros":
            raise ValueError("only plain zero-padded Conv2d splits")
        return functools.partial(F.conv2d, stride=full.stride,
                                 padding=full.padding,
                                 dilation=full.dilation)
    if isinstance(full, nn.Linear):
        return F.linear
    raise TypeError(f"no tensor-parallel form of {type(full).__name__}")


class ColumnParallel(nn.Module):
    """A ``Conv2d`` / ``Linear`` holding this rank's share of the output
    channels (weight dim 0 and the bias); its output is split too."""

    def __init__(self, full: nn.Module, group, rank: int, size: int):
        super().__init__()
        self.group, self._op = group, _functional(full)
        self.weight = nn.Parameter(
            full.weight.detach().chunk(size, 0)[rank].clone())
        self.bias = (None if full.bias is None else nn.Parameter(
            full.bias.detach().chunk(size, 0)[rank].clone()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._op(_CopyToModel.apply(x, self.group), self.weight,
                        self.bias)


class RowParallel(nn.Module):
    """A ``Conv2d`` / ``Linear`` holding this rank's share of the input
    channels (weight dim 1): partial sums all-reduced in fp32, the
    (replicated) bias added once after the reduce."""

    def __init__(self, full: nn.Module, group, rank: int, size: int):
        super().__init__()
        self.group, self._op = group, _functional(full)
        self.weight = nn.Parameter(
            full.weight.detach().chunk(size, 1)[rank].clone())
        self.bias = (None if full.bias is None
                     else nn.Parameter(full.bias.detach().clone()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._op(x, self.weight, None)
        z = _ReduceFromModel.apply(y, self.group)
        if self.bias is not None:
            bias = self.bias.float()
            z = z + (bias.view(1, -1, 1, 1) if z.ndim == 4 else bias)
        return z.to(y.dtype)


def parallelize(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Swap the layers that ``param_shardings`` splits for their
    tensor-parallel forms, holding this rank's slices of the current
    weights, when ``mesh["model"]`` has more than one rank; a model size
    of 1 leaves the model as it is. Idempotent; returns ``model``."""
    size, rank, group = axis_info(mesh, "model")
    if size == 1:
        return model
    dims = param_shardings(model.state_dict(), mesh)
    for name, module in list(model.named_modules()):
        dim = dims.get(f"{name}.weight")
        if dim is None or isinstance(module, (ColumnParallel, RowParallel)):
            continue
        cls = ColumnParallel if dim == 0 else RowParallel
        parent, _, attr = name.rpartition(".")
        setattr(model.get_submodule(parent), attr,
                cls(module, group, rank, size))
    return model


# ------------------------------------------------------------------ #
# The segment-sharded embed
# ------------------------------------------------------------------ #

def _pad_to(a: np.ndarray, multiple: int) -> np.ndarray:
    """``a`` padded to a multiple of ``multiple`` by repeating its last
    entry."""
    pad = (-len(a)) % multiple
    return np.concatenate([a, np.repeat(a[-1:], pad, 0)]) if pad else a


def _sharded_table(model, mesh: DeviceMesh, video_u8, window: int,
                   stride: int, num_segments: int, audio_examples,
                   tower: str, img_size: int, batch_size: int
                   ) -> torch.Tensor:
    n, i, group = axis_info(mesh, "data")
    L = num_segments
    starts = _pad_to(np.arange(L, dtype=np.int64) * stride, n)
    k = len(starts) // n
    bs = _batch_plan(k, batch_size)
    mine = _pad_to(starts[i * k:(i + 1) * k], bs)
    audio = None
    if audio_examples is not None and model.model_type == 2:
        dev = module_device(model)
        examples = torch.as_tensor(audio_examples).to(dev)
        ids = np.minimum(np.arange(len(starts)), len(examples) - 1)
        ids = _pad_to(ids[i * k:(i + 1) * k], bs)
        audio = examples[torch.from_numpy(ids).to(dev)]
    (table,) = _embed_batches(model, video_u8, window, mine, bs, img_size,
                              (tower,), audio)
    with torch.inference_mode():
        local = table[:k].contiguous()
        parts = [torch.empty_like(local) for _ in range(n)]
        dist.all_gather(parts, local, group=group)
        return torch.cat(parts)[:L]


def sharded_embed_from_video(model, mesh: DeviceMesh, video_u8,
                             window: int, stride: int, num_segments: int,
                             audio_examples=None, *, tower: str = "target",
                             img_size: int = 224, batch_size: int = 32
                             ) -> torch.Tensor:
    """[L, D] table of one tower with the segment axis sharded over
    ``data``; every rank returns the whole table, on its device.

    L is padded to a multiple of the data size by repeating the last
    start; segment i takes audio example ``min(i, N - 1)`` over the padded
    range (avtex/parallel/sharded.py:110-161). Each data rank gathers
    and embeds its contiguous block of windows from the whole video on
    its device, in batches of ``batch_size`` shrunk as
    ``precompute_embeddings_from_video`` shrinks them; the blocks are
    all-gathered over the data group. The model is ``parallelize``d
    first (a no-op at model size 1)."""
    parallelize(model, mesh)
    return _sharded_table(model, mesh, video_u8, window, stride,
                          num_segments, audio_examples, tower, img_size,
                          batch_size)


def sharded_embed_segments(model, mesh: DeviceMesh, windows_u8,
                           audio_examples=None, *, tower: str = "target",
                           img_size: int = 224, batch_size: int = 32
                           ) -> torch.Tensor:
    """``sharded_embed_from_video`` over pre-gathered uint8 windows
    ``[L, W, H, W, 3]`` (avtex/parallel/sharded.py:56-81)."""
    parallelize(model, mesh)
    video, window = _windows_as_video(windows_u8)
    return _sharded_table(model, mesh, video, window, window,
                          len(video) // window, audio_examples, tower,
                          img_size, batch_size)


# ------------------------------------------------------------------ #
# The DP+TP train step
# ------------------------------------------------------------------ #

def make_sharded_train_step(model, mesh: DeviceMesh, size: int,
                            slowfast: bool, augment: bool = True
                            ) -> Callable:
    """DP+TP ``make_train_step`` (avtex/parallel/sharded.py:164-184):
    ``step(state, batch, generator) -> (state, metrics)`` on the global
    batch, of which this data rank trains on its contiguous rows (B must
    be a multiple of the data size). The augmentation draws are made for
    the whole batch and cut, so the result does not depend on the mesh
    shape. The fp32 gradients of the master copy are all-reduced to their
    mean over the data group before the optimizer step; TP slices step
    locally. ``metrics`` are averaged over the data ranks.

    The model is ``parallelize``d here: build its ``TrainState`` after
    this call, from ``shard_params`` of the full parameters."""
    from avtex_torch.train.loop import make_train_step

    parallelize(model, mesh)
    n, i, group = axis_info(mesh, "data")

    def rows(b: int) -> slice:
        if b % n:
            raise ValueError(f"batch of {b} does not split over {n} data "
                             f"ranks")
        k = b // n
        return slice(i * k, (i + 1) * k)

    def mean_over_data(grads: List[torch.Tensor]) -> None:
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat /= n
        for g, r in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(r.view_as(g))

    base = make_train_step(model, size, slowfast, augment, rows=rows,
                           grad_hook=mean_over_data)

    def step(state, batch: Dict, generator: torch.Generator):
        state, metrics = base(state, batch, generator)
        m = torch.stack([metrics["loss"], metrics["acc"]]).float()
        dist.all_reduce(m, group=group)
        m /= n
        return state, {"loss": m[0], "acc": m[1]}

    return step
