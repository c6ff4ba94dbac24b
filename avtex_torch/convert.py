"""Carry avtex's model parameters over to the port.

``convert_params(tree, model)`` takes the flax parameter tree of one of
avtex's models (``ContrastiveTextures``, ``VideoForAudio``,
``AudioVisualFeatures``, ``ClassicTemporal``) as a nested dict of numpy
arrays (with or without the top-level ``"params"`` collection) and returns
a ``state_dict`` for the port's module of the same name. It needs neither
jax nor flax. The port names its modules after the flax tree, so the
mapping is a renaming plus layout changes:

- ``Conv_k/kernel`` and ``fast_stem_kernel``: DHWIO -> OIDHW (a grouped
  kernel, ``[kt, kh, kw, in/groups, out]``, the same transpose to
  ``[out, in/groups, kt, kh, kw]``);
- 4-D ``Conv_k/kernel`` (VGGish, ``audio_encoder`` of model_type=2, and
  the 2D ResNets): HWIO -> OIHW;
- 3-D ``Conv_k/kernel`` (a 1-D conv, ``[k, in, out]``) -> ``Conv1d``'s
  ``[out, in, k]``;
- 2-D ``kernel`` (a flax ``Dense``, ``[in, out]``: ``Dense_k`` of
  ``AudioMLP``, ``video_head``) -> ``Linear.weight`` ``[out, in]``;
- every ``bias`` unchanged;
- ``Affine_k/{scale,bias}``: unchanged;
- ``GroupNorm_k/{scale,bias}`` -> ``GroupNorm_k.{weight,bias}``.

``export_params(state_dict)`` is the inverse: the port's parameters as
avtex's tree (``{"params": ...}``, float32 numpy), e.g. for
``avtex_torch.train.save_checkpoint``.

``convert_opt_state(tree, model)`` and ``export_opt_state(momentum,
count)`` carry the optimizer across both ways. avtex's optimizer is
``optax.chain(add_decayed_weights(wd), sgd(schedule, momentum))``, whose
state tree is ``{"0": {}, "1": {"0": {"trace": <params tree>}, "1":
{"count": <int32>}}}``: the momentum trace has the parameter tree's own
structure, so it maps onto the ``momentum_buffer`` of each parameter of
``torch.optim.SGD`` by the same renaming, and ``count`` is the number of
steps taken.

Pinned names (avtex/nn/slowfast.py): ``SFBottleneck_{0..}`` interleaved
slow/fast, top-level ``Conv_0`` (slow stem) and ``Conv_1..4`` (laterals),
``Affine_0..5`` / ``GroupNorm_0..5``; the other encoders' blocks are
``BasicBlock3D_i``, ``Bottleneck3D_i``, ``ResNeXtBottleneck3D_i``,
``DenseLayer3D_i`` and ``ResNet2D_0/BasicBlock2D_i``, as flax names them. Unknown and missing keys raise,
listing them; so do shape mismatches.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_OIDHW = (4, 3, 0, 1, 2)
_OIHW = (3, 2, 0, 1)
_OIK = (2, 1, 0)  # [k, in, out] <-> [out, in, k], its own inverse


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _torch_key(path: Tuple[str, ...], value: np.ndarray
               ) -> Tuple[str, np.ndarray]:
    *mods, leaf = path
    conv = bool(mods) and mods[-1].startswith("Conv_")
    if leaf == "kernel" and value.ndim == 2:  # Dense
        return ".".join(mods + ["weight"]), value.T
    if leaf == "kernel" and conv and value.ndim == 3:  # 1-D conv
        return ".".join(mods + ["weight"]), value.transpose(_OIK)
    if leaf == "kernel" and conv and value.ndim == 4:  # VGGish
        return ".".join(mods + ["weight"]), value.transpose(_OIHW)
    if leaf == "bias" and mods:
        return ".".join(mods + [leaf]), value
    if leaf == "fast_stem_kernel" or (leaf == "kernel" and conv):
        if value.ndim != 5:
            raise ValueError(f"{'/'.join(path)}: expected a 5-D DHWIO conv "
                             f"kernel, got shape {value.shape}")
        name = leaf if leaf == "fast_stem_kernel" else "weight"
        return ".".join(mods + [name]), value.transpose(_OIDHW)
    if mods and mods[-1].startswith("Affine_") and leaf == "scale":
        return ".".join(mods + [leaf]), value
    if mods and mods[-1].startswith("GroupNorm_") and leaf == "scale":
        return ".".join(mods + ["weight"]), value
    raise KeyError("/".join(path))


def convert_params(tree: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """avtex params (numpy tree) -> the port's state_dict for ``model``
    (float32 tensors; ``load_state_dict`` casts them)."""
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    expected = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    out: Dict[str, torch.Tensor] = {}
    unknown = []
    for path, value in _flatten(tree):
        try:
            key, arr = _torch_key(path, value)
        except KeyError:
            unknown.append("/".join(path))
            continue
        if key not in expected:
            unknown.append("/".join(path))
            continue
        if tuple(arr.shape) != expected[key]:
            raise ValueError(f"{'/'.join(path)} -> {key}: shape "
                             f"{tuple(arr.shape)} != {expected[key]}")
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
    missing = sorted(set(expected) - set(out))
    if unknown or missing:
        raise KeyError(f"parameter trees do not match: unknown avtex keys "
                       f"{sorted(unknown)}; missing port keys {missing}")
    return out


_DHWIO = (2, 3, 4, 1, 0)
_HWIO = (2, 3, 1, 0)


def export_params(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The port's ``state_dict`` -> avtex's parameter tree
    ``{"params": {...}}`` of float32 numpy arrays (conv kernels OIDHW ->
    DHWIO, OIHW -> HWIO and ``[out, in, k]`` -> ``[k, in, out]``,
    ``Linear`` weights transposed to ``[in, out]``, ``GroupNorm_k.weight``
    -> ``GroupNorm_k/scale``); the inverse of ``convert_params``."""
    tree: Dict = {}
    for key, value in state_dict.items():
        *mods, leaf = key.split(".")
        arr = value.detach().float().cpu().numpy()
        if leaf == "fast_stem_kernel" or (leaf == "weight" and arr.ndim == 5):
            arr = arr.transpose(_DHWIO)
            leaf = leaf if leaf == "fast_stem_kernel" else "kernel"
        elif leaf == "weight" and arr.ndim == 4:
            arr, leaf = arr.transpose(_HWIO), "kernel"
        elif leaf == "weight" and arr.ndim == 3:
            arr, leaf = arr.transpose(_OIK), "kernel"
        elif leaf == "weight" and arr.ndim == 2:
            arr, leaf = arr.T, "kernel"
        elif mods and mods[-1].startswith("GroupNorm_") and leaf == "weight":
            leaf = "scale"
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)
    return {"params": tree}


def convert_opt_state(tree: Mapping, model: nn.Module
                      ) -> Tuple[Dict[str, torch.Tensor], int]:
    """avtex's optimizer state tree -> (momentum buffers by the port's
    parameter name, float32; the step count)."""
    try:
        trace = tree["1"]["0"]["trace"]
        count = tree["1"]["1"]["count"]
    except (KeyError, TypeError) as e:
        raise ValueError(f"not avtex's SGD optimizer state (no {e}): "
                         f"keys {sorted(tree)}") from None
    return convert_params(trace, model), int(np.asarray(count))


def export_opt_state(momentum: Mapping[str, torch.Tensor], count: int
                     ) -> Dict:
    """Momentum buffers by the port's parameter name and the step count ->
    avtex's optimizer state tree; the inverse of ``convert_opt_state``."""
    return {"0": {}, "1": {"0": {"trace": export_params(momentum)},
                           "1": {"count": np.array(count, np.int32)}}}
