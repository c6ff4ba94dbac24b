"""Pretrained checkpoints: where they are looked for and how SuperSloMo's
is loaded (the port's copies of the lookups and loaders in
avtex/utils/convert.py).

Each ``find_*_checkpoint`` tries, in order, an explicit path, its
environment variable and the reference's conventional file names, and
returns the first that exists (None if none does).

``SuperSloMo.ckpt`` (a torch file holding ``state_dictFC`` and
``state_dictAT``) loads through ``maybe_make_slomo_interp_fn``: its 4-D
conv weights pair with the port's convs in call order, every shape
checked, as avtex's ``convert_slomo`` does. The encoder and VGGish files
are not loadable yet; where avtex would load one, the port raises
``checkpoint_not_ported`` instead of silently running on other weights.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

ENCODER_FILES = {"resnet18": "r3d18_KM_200ep.pth",
                 "resnet18_2d": "resnet18-imagenet.pth",
                 "slowfast": "SLOWFAST_8x8_R50.pkl"}


def _first_existing(*cands: Optional[str]) -> Optional[str]:
    for cand in cands:
        if cand and os.path.exists(cand):
            return cand
    return None


def find_vggish_checkpoint(explicit: Optional[str] = None) -> Optional[str]:
    """pytorch_vggish.pth: ``explicit``, $AVTEX_VGGISH_CKPT,
    ``pretrained/pytorch_vggish.pth``, ``pytorch_vggish.pth``."""
    return _first_existing(explicit, os.environ.get("AVTEX_VGGISH_CKPT"),
                           "pretrained/pytorch_vggish.pth",
                           "pytorch_vggish.pth")


def find_slomo_checkpoint(explicit: Optional[str] = None) -> Optional[str]:
    """SuperSloMo.ckpt: ``explicit``, $AVTEX_SLOMO_CKPT,
    ``pretrained/SuperSloMo.ckpt``, ``SuperSloMo.ckpt``."""
    return _first_existing(explicit, os.environ.get("AVTEX_SLOMO_CKPT"),
                           "pretrained/SuperSloMo.ckpt", "SuperSloMo.ckpt")


def find_encoder_checkpoint(arch: str,
                            explicit: Optional[str] = None) -> Optional[str]:
    """A pretrained encoder for ``arch``: ``explicit``,
    $AVTEX_ENCODER_CKPT, ``pretrained/<file>``, ``<file>`` (``<file>``
    from ``ENCODER_FILES``; an arch without one tries only the first
    two)."""
    fname = ENCODER_FILES.get(arch)
    return _first_existing(explicit, os.environ.get("AVTEX_ENCODER_CKPT"),
                           fname and f"pretrained/{fname}", fname)


def checkpoint_not_ported(path: str, what: str,
                          item: str) -> NotImplementedError:
    """The error for a found checkpoint that avtex would load here."""
    return NotImplementedError(
        f"found {path}, which avtex loads as {what}; loading it is not "
        f"ported to avtex_torch yet: ROADMAP.md Queue 1 '{item}'. Move the "
        f"file away to run on the port's own weights.")


def load_torch_state(path: str) -> Dict[str, np.ndarray]:
    """A ``.pth`` / ``.ckpt`` as ``{name: numpy array}`` (avtex's
    ``load_torch_state``): unwraps ``state_dict`` / ``model_state`` and
    flattens SuperSloMo's two nets, ``flowComp.*`` first, then
    ``arbTimeFlowIntrp.*``. Non-tensor entries are dropped. Only tensors
    and plain data are unpickled (and ``datetime``, which the reference's
    SuperSloMo file stores as its timestamp)."""
    with torch.serialization.safe_globals([datetime.datetime]):
        obj = torch.load(path, map_location="cpu", weights_only=True)
    for wrap in ("state_dict", "model_state"):
        if isinstance(obj, dict) and wrap in obj:
            obj = obj[wrap]
    if isinstance(obj, dict) and "state_dictFC" in obj \
            and "state_dictAT" in obj:
        obj = {f"{prefix}.{k}": v
               for prefix, sub in (("flowComp", obj["state_dictFC"]),
                                   ("arbTimeFlowIntrp", obj["state_dictAT"]))
               for k, v in sub.items()}
    return {k: v.numpy() for k, v in obj.items()
            if isinstance(v, torch.Tensor)}


def convert_slomo_state(state: Mapping[str, np.ndarray],
                        model: nn.Module) -> Dict[str, torch.Tensor]:
    """A reference SuperSloMo state (``load_torch_state``) -> the port's
    ``state_dict`` for ``model``: the checkpoint's 4-D conv weights, in
    its order, pair with ``model``'s ``Conv2d`` modules in call order
    (their registration order); counts and every shape are checked and
    each weight's ``.bias`` goes with it."""
    convs = [(name, m) for name, m in model.named_modules()
             if isinstance(m, nn.Conv2d)]
    pairs = [(k[:-len(".weight")], np.asarray(v)) for k, v in state.items()
             if k.endswith(".weight") and np.ndim(v) == 4]
    if len(convs) != len(pairs):
        raise ValueError(f"conv count mismatch: the port has {len(convs)}, "
                         f"the checkpoint {len(pairs)}")
    out: Dict[str, torch.Tensor] = {}
    for (name, conv), (base, w) in zip(convs, pairs):
        if tuple(conv.weight.shape) != w.shape:
            raise ValueError(f"shape mismatch at {name} <- {base}: "
                             f"{tuple(conv.weight.shape)} vs {w.shape}")
        if base + ".bias" not in state:
            raise ValueError(f"checkpoint conv {base} has no bias")
        out[f"{name}.weight"] = torch.from_numpy(np.array(w, np.float32))
        out[f"{name}.bias"] = torch.from_numpy(
            np.array(state[base + ".bias"], np.float32))
    return out


def convert_slomo_params(tree: Mapping) -> Dict[str, torch.Tensor]:
    """avtex's flax SuperSloMo parameters (a numpy tree, with or without
    the ``"params"`` collection) -> the port's ``state_dict``: module
    paths join with ".", ``kernel`` HWIO -> ``weight`` OIHW."""
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}.")
            elif k == "kernel":
                out[prefix + "weight"] = torch.from_numpy(np.array(
                    np.asarray(v).transpose(3, 2, 0, 1), np.float32))
            elif k == "bias":
                out[prefix + "bias"] = torch.from_numpy(
                    np.array(v, np.float32))
            else:
                raise KeyError(f"unexpected SuperSloMo leaf {prefix}{k}")
    walk(tree, "")
    return out


_REFERENCE_UNET = {"Conv_0": "conv1", "Conv_1": "conv2", "Conv_2": "conv3",
                   **{f"_Down_{i}": f"down{i + 1}" for i in range(5)},
                   **{f"_Up_{i}": f"up{i + 1}" for i in range(5)}}


def save_slomo_checkpoint(model: nn.Module, path: str) -> str:
    """Write ``model``'s (a ``SuperSloMo``) weights as the reference's
    ``SuperSloMo.ckpt``: ``{"state_dictFC": ..., "state_dictAT": ...}``
    of float32 tensors under the reference's names (``conv1``,
    ``down1.conv1``, ..., ``conv3``), in call order."""
    nets = {}
    for key, value in model.state_dict().items():
        net, *mods, leaf = key.split(".")
        mods = [_REFERENCE_UNET[mods[0]]] + [
            {"Conv_0": "conv1", "Conv_1": "conv2"}[m] for m in mods[1:]]
        nets.setdefault(net, {})[".".join(mods + [leaf])] = \
            value.detach().float().cpu().clone()
    torch.save({"state_dictFC": nets["flow_comp"],
                "state_dictAT": nets["arb_time"]}, path)
    return path


def maybe_make_slomo_interp_fn(path: Optional[str] = None, device=None,
                               dtype: torch.dtype = torch.bfloat16):
    """The stitcher's ``interp_fn`` from a SuperSloMo checkpoint found by
    ``find_slomo_checkpoint(path)``, on ``device`` (``cuda`` unless
    ``device="cpu"``); None when no file is found, so the caller
    crossfades (random SuperSloMo weights would look worse)."""
    from avtex_torch.device import resolve_device
    from avtex_torch.nn.slomo import SuperSloMo
    from avtex_torch.synth.interp import make_interp_fn

    found = find_slomo_checkpoint(path)
    if found is None:
        return None
    dev = resolve_device(device)
    model = SuperSloMo(dtype)
    model.load_state_dict(convert_slomo_state(load_torch_state(found),
                                              model))
    print(f"[avtex_torch] loaded SuperSloMo weights from {found}")
    return make_interp_fn(model.to(dev).eval())
