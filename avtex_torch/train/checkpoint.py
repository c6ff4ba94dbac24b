"""avtex's checkpoint files, read and written without flax (the port of
avtex/train/checkpoint.py).

avtex keeps the reference's latest/best contract: ``save_checkpoint``
writes ``<ckpt_dir>/<logname>_latest`` and copies it to ``_best`` on
improvement; the file is flax's msgpack of ``{"epoch", "arch",
"best_loss", "step", "state"[, "opt_state"]}``, with ``state`` the flax
parameter tree. The port reads and writes the same bytes with its own
codec (``_msgpack.py``): ``restore_checkpoint`` returns ``state`` as the
numpy tree that ``avtex_torch.convert.convert_params`` takes.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Mapping, Optional

import torch

from . import _msgpack


def _paths(ckpt_dir: str, logname: str):
    os.makedirs(ckpt_dir, exist_ok=True)
    return (os.path.join(ckpt_dir, f"{logname}_latest"),
            os.path.join(ckpt_dir, f"{logname}_best"))


def _state_dict(tree: Any) -> Any:
    """flax's ``to_state_dict`` for a tree of dicts, lists and arrays:
    str keys, lists as ``{"0": ...}`` maps, tensors as numpy arrays."""
    if isinstance(tree, Mapping):
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def save_checkpoint(ckpt_dir: str, logname: str, state: Any, epoch: int,
                    arch: str, best_loss: float, is_best: bool,
                    opt_state: Any = None, step: int = 0) -> str:
    """Write the latest checkpoint; copy it to best on improvement.
    ``state`` is avtex's parameter tree (numpy arrays or tensors; see
    ``avtex_torch.convert.export_params``). Returns the path written
    last."""
    latest, best = _paths(ckpt_dir, logname)
    payload = {"epoch": epoch, "arch": arch, "best_loss": float(best_loss),
               "step": int(step), "state": _state_dict(state)}
    if opt_state is not None:
        payload["opt_state"] = _state_dict(opt_state)
    with open(latest, "wb") as f:
        f.write(_msgpack.packb(payload))
    if is_best:
        shutil.copyfile(latest, best)
    return best if is_best else latest


def restore_checkpoint(path: str) -> Optional[Dict[str, Any]]:
    """Read a checkpoint that avtex's or the port's ``save_checkpoint``
    wrote: ``{"epoch", "arch", "best_loss", "step", "state"[,
    "opt_state"]}`` with ``state`` a tree of numpy arrays (``opt_state``
    as a plain tree too), or None if the file does not exist."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        payload = _msgpack.unpackb(f.read())
    if not isinstance(payload, dict) or "state" not in payload:
        raise ValueError(f"{path} is not an avtex checkpoint (no 'state')")
    payload.setdefault("step", 0)
    return payload

