"""The data x model device mesh on ``torch.distributed`` (the port of
avtex/parallel/mesh.py).

``make_mesh`` lays the ranks of the world out as avtex reshapes
``jax.devices()``: the data axis outer, the model axis inner, so rank
``d * model + m`` holds data block ``d`` and model slice ``m``. Each rank
drives one device: ``cuda:LOCAL_RANK`` under NCCL, or the CPU under gloo
(``device="cpu"``).

When no process group exists, ``make_mesh`` starts one: from torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) when it is set, else a one-process world through a
``FileStore`` in a temporary directory (no TCP port). ``shutdown()``
destroys a group that ``make_mesh`` started.

``shard_leading`` and ``replicate`` are avtex's placement helpers as
operations on tensors: this rank's contiguous block of the leading
dimension, and a broadcast from the mesh's first rank.
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from avtex_torch.device import resolve_device

# Whether make_mesh started this process's default group (and the
# FileStore directory it made, "" under torchrun): the group is
# process-wide, so is the record of who owns it.
_started_dir: Optional[str] = None


def _start_world(dev: torch.device) -> None:
    global _started_dir
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
        _started_dir = ""
        return
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    _started_dir = tempfile.mkdtemp(prefix="avtex_torch_mesh_")
    store = dist.FileStore(os.path.join(_started_dir, "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Tuple[str, ...] = ("data", "model"),
              device=None) -> DeviceMesh:
    """Mesh over every rank of the world (started here if none exists).

    Default: all ranks on ``data``, the other axes trivial. Pass
    ``shape=(2, 2)`` etc. for tensor parallelism. ``device`` (``cuda``
    unless given ``"cpu"``) picks the backend; asking for CUDA without a
    GPU raises."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        _start_world(dev)
    n = dist.get_world_size()
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} devices")
    return init_device_mesh(dev.type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axis_names))


def shutdown() -> None:
    """Destroy the process group if ``make_mesh`` started it."""
    global _started_dir
    if _started_dir is None:
        return
    if dist.is_initialized():
        dist.destroy_process_group()
    if _started_dir:
        shutil.rmtree(_started_dir, ignore_errors=True)
    _started_dir = None


def rank_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def is_first_rank(mesh: Optional[DeviceMesh]) -> bool:
    """Whether this process is the mesh's first rank (True without a
    mesh): the one that writes output files and logs."""
    return mesh is None or dist.get_rank() == int(mesh.mesh.flatten()[0])


def axis_info(mesh: DeviceMesh, axis: str):
    """(size, this rank's index, process group) of one mesh axis."""
    return (mesh[axis].size(), mesh.get_local_rank(axis),
            mesh.get_group(axis))


def shard_leading(mesh: DeviceMesh, x, axis: str = "data"):
    """This rank's contiguous block of ``x``'s leading dimension over
    ``mesh[axis]``; the dimension must divide evenly."""
    n, i, _ = axis_info(mesh, axis)
    if len(x) % n:
        raise ValueError(f"leading dimension {len(x)} does not split over "
                         f"{n} ranks of '{axis}'")
    b = len(x) // n
    return x[i * b:(i + 1) * b]


def replicate(mesh: DeviceMesh, x) -> torch.Tensor:
    """``x`` as the mesh's first rank holds it, on this rank's device
    (every rank passes a tensor of the same shape and dtype)."""
    t = torch.as_tensor(x).to(rank_device(mesh)).clone()
    dist.broadcast(t, src=int(mesh.mesh.flatten()[0]))
    return t
