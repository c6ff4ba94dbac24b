"""Pretrained checkpoints: where they are looked for and how SuperSloMo's
is loaded (the port's copies of the lookups and loaders in
avtex/utils/convert.py).

Each ``find_*_checkpoint`` tries, in order, an explicit path, its
environment variable and the reference's conventional file names, and
returns the first that exists (None if none does).

``SuperSloMo.ckpt`` (a torch file holding ``state_dictFC`` and
``state_dictAT``) loads through ``maybe_make_slomo_interp_fn``: its 4-D
conv weights pair with the port's convs in call order, every shape
checked, as avtex's ``convert_slomo`` does. ``pytorch_vggish.pth`` loads
through ``maybe_load_vggish`` / ``maybe_load_vggish_into_model``: its
first six 4-D tensors, in order, are VGGish's ``Conv_0..5`` (fc and
embedding tensors are dropped), as avtex's ``convert_vggish``; without a
file they warn loudly and leave the weights as they are. The encoder
files are not loadable yet; where avtex would load one, the port raises
``checkpoint_not_ported`` instead of silently running on other weights.
"""

from __future__ import annotations

import datetime
import os
import sys
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


def convert_vggish_state(state: Mapping[str, np.ndarray],
                         vggish_state: Mapping[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """A reference ``pytorch_vggish.pth`` state (``load_torch_state``) ->
    ``vggish_state`` (a ``VGGish`` state_dict) with ``Conv_0..5`` replaced:
    the checkpoint's first six 4-D ``.weight`` tensors, in its order,
    each with its ``.bias`` when it has one; shapes checked."""
    pairs = [(k[:-len(".weight")], np.asarray(v)) for k, v in state.items()
             if k.endswith(".weight") and np.ndim(v) == 4][:6]
    slots = sorted({k.split(".")[0] for k in vggish_state
                    if k.startswith("Conv_")}, key=lambda m: int(m[5:]))
    if len(slots) != len(pairs):
        raise ValueError(f"conv count mismatch: VGGish has {len(slots)}, "
                         f"the checkpoint {len(pairs)}")
    out = dict(vggish_state)
    for slot, (base, w) in zip(slots, pairs):
        have = tuple(vggish_state[f"{slot}.weight"].shape)
        if have != w.shape:
            raise ValueError(f"shape mismatch at {slot} <- {base}: {have} "
                             f"vs {w.shape}")
        out[f"{slot}.weight"] = torch.from_numpy(np.array(w, np.float32))
        if base + ".bias" in state:
            out[f"{slot}.bias"] = torch.from_numpy(
                np.array(state[base + ".bias"], np.float32))
    return out


def maybe_load_vggish(vggish_state: Mapping[str, torch.Tensor],
                      path: Optional[str] = None, *, context: str = ""):
    """Load the checkpoint that ``find_vggish_checkpoint(path)`` finds into
    a copy of ``vggish_state``; without one, warn loudly (random VGGish
    features score audio meaninglessly) and return it unchanged.
    Returns (state, loaded)."""
    found = find_vggish_checkpoint(path)
    if found is None:
        print(f"[avtex_torch] WARNING: no pytorch_vggish.pth found "
              f"({context}); VGGish runs with RANDOM weights — audio "
              "features are meaningless. Set $AVTEX_VGGISH_CKPT or place "
              "the file at pretrained/pytorch_vggish.pth.", file=sys.stderr)
        return dict(vggish_state), False
    out = convert_vggish_state(load_torch_state(found), vggish_state)
    print(f"[avtex_torch] loaded pretrained VGGish weights from {found}")
    return out, True


def maybe_load_vggish_into_model(model_state: Mapping[str, torch.Tensor],
                                 path: Optional[str] = None, *,
                                 context: str = ""):
    """Graft a found VGGish checkpoint into the shared ``audio_encoder.*``
    entries of a ContrastiveTextures state_dict (model_type=2). Returns
    (state, loaded); unchanged, after the warning, without a file or
    without an audio encoder."""
    prefix = "audio_encoder."
    sub = {k[len(prefix):]: v for k, v in model_state.items()
           if k.startswith(prefix)}
    if not sub:
        return dict(model_state), False
    sub, loaded = maybe_load_vggish(sub, path, context=context)
    out = dict(model_state)
    out.update({prefix + k: v for k, v in sub.items()})
    return out, loaded


def vggish_reference_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A ``VGGish``'s convs under the reference's ``pytorch_vggish.pth``
    names (``features.{0,3,6,8,11,13}.weight`` / ``.bias``, float32), the
    part of that file the loader reads; add the ``embeddings.*`` head and
    ``torch.save`` it to make a test file."""
    idx = (0, 3, 6, 8, 11, 13)
    return {f"features.{idx[int(k[5])]}.{k.split('.')[1]}":
            v.detach().float().cpu().clone()
            for k, v in model.state_dict().items()}


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
