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
file they warn loudly and leave the weights as they are.

Pretrained encoders (the frozen-BatchNorm nets the reference runs in eval
mode) load into the ``norm="affine"`` encoders, each BatchNorm folded into
the per-channel ``Affine`` that follows its conv, in float32:
- ``convert_bn_folded``: a torch state (``r3d18_KM_200ep.pth``,
  ``resnet18-imagenet.pth``, any BN net) tokenised in declaration order
  (conv weights; BN modules as ``scale = gamma / sqrt(var + eps)``,
  ``shift = beta - mean * scale``; a conv bias just before a BN folded into
  its shift) and paired with the port's ``Conv*d`` / ``Affine`` modules in
  the order a forward calls them (forward pre-hooks on a tiny input),
  counts, kinds and shapes checked;
- ``convert_slowfast``: pyslowfast's ``SLOWFAST_8x8_R50`` by name
  (``slowfast_name_map``), coverage checked both ways; ``head.*`` dropped;
- ``load_slowfast_state``: a torch save (``model_state`` / ``state_dict``
  unwrapped, ``model.`` stripped) or the model zoo's caffe2 ``.pkl``
  (``{"blobs": {name: ndarray}}``, read by an unpickler that admits only
  numpy's array reconstruction), blob names mapped by ``_c2_name_to_pt``;
- ``maybe_load_encoder`` / ``maybe_load_encoder_into_model`` find a file
  (``find_encoder_checkpoint``) and load it into one encoder or into both
  towers of a ContrastiveTextures state; a ``ValueError`` of the import
  warns loudly and keeps the current weights, as avtex does.
Torch weights keep their ``[out, in, *k]`` layout; ``load_state_dict``
casts conv weights to the model's dtype. ``slowfast_reference_state``,
``slowfast_c2_blobs`` and ``resnet_reference_state`` write seeded
random states under the reference's names, for tests and smoke runs.
"""

from __future__ import annotations

import datetime
import os
import pickle
import re
import sys
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Tuple

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


# ---- pretrained encoders ------------------------------------------------- #

def _bn_affine(mod: Mapping[str, np.ndarray], eps: float = 1e-5
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Frozen-BN tensors -> the equivalent per-channel (scale, shift), in
    the tensors' own precision."""
    gamma, beta = mod.get("weight"), mod.get("bias")
    mean, var = mod["running_mean"], mod["running_var"]
    scale = (1.0 if gamma is None else gamma) / np.sqrt(var + eps)
    return scale, (0.0 if beta is None else beta) - mean * scale


def _fold_bn(mod: Mapping[str, np.ndarray], eps: float = 1e-5
             ) -> Tuple[np.ndarray, np.ndarray]:
    """``_bn_affine`` as float32."""
    scale, shift = _bn_affine(mod, eps)
    return scale.astype(np.float32), shift.astype(np.float32)


def _torch_tokens(state: Mapping[str, np.ndarray], eps: float = 1e-5
                  ) -> List[tuple]:
    """A torch state in declaration order as ("conv", weight, bias) and
    ("norm", scale, shift) tokens; a conv bias just before a BN is folded
    into that BN's shift (the port's convs have no bias)."""
    by_base: Dict[str, Dict[str, np.ndarray]] = {}
    for key in state:
        base, _, leaf = key.rpartition(".")
        by_base.setdefault(base, {})[leaf] = np.asarray(state[key])
    tokens: List[tuple] = []
    for mod in by_base.values():
        w = mod.get("weight")
        if "running_mean" in mod:
            scale, shift = _bn_affine(mod, eps)
            if tokens and tokens[-1][0] == "conv" and tokens[-1][2] is not None:
                _, k, b = tokens[-1]
                tokens[-1] = ("conv", k, None)
                shift = shift + scale * b
            tokens.append(("norm", scale.astype(np.float32),
                           shift.astype(np.float32)))
        elif w is not None and w.ndim >= 3:
            tokens.append(("conv", w, mod.get("bias")))
    return tokens


def module_call_order(module: nn.Module, *example_args) -> List[str]:
    """Names of ``module``'s ``Conv1d/2d/3d`` and ``Affine`` submodules in
    the order one ``torch.no_grad()`` forward of ``example_args`` first
    calls them (forward pre-hooks; registration order need not be call
    order). A module whose weights a forward reads without calling it
    (the fused 1x1 path, the s2d stems) is not listed."""
    from avtex_torch.nn.resnet3d import Affine
    seen: Dict[str, None] = {}
    handles = [m.register_forward_pre_hook(
        lambda _m, _a, name=name: seen.setdefault(name))
        for name, m in module.named_modules()
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d, Affine))]
    try:
        with torch.no_grad():
            module(*example_args)
    finally:
        for h in handles:
            h.remove()
    return list(seen)


def _f32(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32))


def convert_bn_folded(torch_state: Mapping[str, np.ndarray],
                      module: nn.Module, params: Mapping[str, torch.Tensor],
                      *example_args, eps: float = 1e-5
                      ) -> Dict[str, torch.Tensor]:
    """A frozen-BatchNorm torch net's state -> ``params`` (``module``'s
    state_dict, ``norm="affine"``) with every conv weight copied and every
    BN folded into the matching ``Affine``'s ``scale`` / ``bias`` (float32).
    Tokens pair with the modules in the call order of one forward of
    ``example_args`` (tiny: only the shapes' divisibility matters). Counts,
    kinds and shapes are checked; a mismatch raises ``ValueError`` naming
    the slot."""
    tokens = _torch_tokens(torch_state, eps)
    slots = []
    for name in module_call_order(module, *example_args):
        if f"{name}.scale" in params:
            slots.append(("norm", name))
        elif f"{name}.weight" in params and \
                params[f"{name}.weight"].ndim >= 3:
            slots.append(("conv", name))
    if len(slots) != len(tokens):
        raise ValueError(f"slot count mismatch: port {len(slots)} vs "
                         f"torch {len(tokens)}")
    out = dict(params)
    for (kind, name), tok in zip(slots, tokens):
        if kind != tok[0]:
            raise ValueError(f"slot kind mismatch at {name}: port {kind} vs "
                             f"torch {tok[0]}")
        if kind == "conv":
            _, w, b = tok
            have = tuple(params[f"{name}.weight"].shape)
            if have != tuple(w.shape):
                raise ValueError(f"shape mismatch at {name}: port {have} vs "
                                 f"torch {w.shape}")
            out[f"{name}.weight"] = _f32(w)
            if b is not None and f"{name}.bias" in params:
                out[f"{name}.bias"] = _f32(b)
        else:
            _, scale, shift = tok
            have = tuple(params[f"{name}.scale"].shape)
            if have != tuple(scale.shape):
                raise ValueError(f"norm shape mismatch at {name}: port "
                                 f"{have} vs torch {scale.shape}")
            out[f"{name}.scale"] = _f32(scale)
            out[f"{name}.bias"] = _f32(shift)
    return out


def slowfast_name_map(layers: Tuple[int, ...] = (3, 4, 6, 3),
                      has_branch1: Callable[[str], bool] = lambda t: True
                      ) -> Iterator[Tuple[str, str, str]]:
    """pyslowfast's SlowFast module names -> the port's ``SlowFastR50``
    names, as ("conv", torch module, port weight key) and ("bn", torch
    module, port ``Affine`` prefix):

      s1.pathway0_stem.{conv,bn}   -> Conv_0 / Affine_0
      s1.pathway1_stem.{conv,bn}   -> fast_stem_kernel / Affine_1
      s1_fuse.{conv_f2s,bn}        -> Conv_1 / Affine_2
      s{2+i}.pathway0_res{j}.*     -> SFBottleneck_{2g}   (slow)
      s{2+i}.pathway1_res{j}.*     -> SFBottleneck_{2g+1} (fast)
        with g = sum(layers[:i]) + j; in a block branch2.a/a_bn ->
        Conv_0/Affine_0, b -> 1, c -> 2, branch1/branch1_bn -> Conv_3 /
        Affine_3 (where ``has_branch1(block)``)
      s{2+i}_fuse.{conv_f2s,bn}    -> Conv_{2+i} / Affine_{3+i}
    """
    yield "conv", "s1.pathway0_stem.conv", "Conv_0.weight"
    yield "bn", "s1.pathway0_stem.bn", "Affine_0"
    yield "conv", "s1.pathway1_stem.conv", "fast_stem_kernel"
    yield "bn", "s1.pathway1_stem.bn", "Affine_1"
    yield "conv", "s1_fuse.conv_f2s", "Conv_1.weight"
    yield "bn", "s1_fuse.bn", "Affine_2"
    g = 0
    for i, n_blocks in enumerate(layers):
        s = f"s{2 + i}"
        for j in range(n_blocks):
            for pathway, blk in ((0, f"SFBottleneck_{2 * g}"),
                                 (1, f"SFBottleneck_{2 * g + 1}")):
                t = f"{s}.pathway{pathway}_res{j}"
                for k, letter in enumerate("abc"):
                    yield "conv", f"{t}.branch2.{letter}", \
                        f"{blk}.Conv_{k}.weight"
                    yield "bn", f"{t}.branch2.{letter}_bn", f"{blk}.Affine_{k}"
                if has_branch1(t):
                    yield "conv", f"{t}.branch1", f"{blk}.Conv_3.weight"
                    yield "bn", f"{t}.branch1_bn", f"{blk}.Affine_3"
            g += 1
        if i != len(layers) - 1:
            yield "conv", f"{s}_fuse.conv_f2s", f"Conv_{2 + i}.weight"
            yield "bn", f"{s}_fuse.bn", f"Affine_{3 + i}"


def convert_slowfast(torch_state: Mapping[str, np.ndarray],
                     params: Mapping[str, torch.Tensor],
                     layers: Tuple[int, ...] = (3, 4, 6, 3),
                     eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """A pyslowfast SlowFast-R50 state (``load_slowfast_state``) ->
    ``params`` (a ``SlowFastR50(norm="affine")`` state_dict) by
    ``slowfast_name_map``, each BN folded. ``head.*`` and
    ``num_batches_tracked`` are dropped. Every tensor is shape-checked; a
    torch module left unmapped, a mapped tensor with no slot in the port
    and a missing module each raise ``ValueError`` with the names."""
    by_base: Dict[str, Dict[str, np.ndarray]] = {}
    for key, v in torch_state.items():
        if key.startswith("head.") or key.endswith("num_batches_tracked"):
            continue
        base, _, leaf = key.rpartition(".")
        by_base.setdefault(base, {})[leaf] = np.asarray(v)

    repl: Dict[str, np.ndarray] = {}
    used = set()
    for kind, torch_mod, port in slowfast_name_map(
            tuple(layers), lambda t: f"{t}.branch1" in by_base):
        mod = by_base.get(torch_mod)
        used.add(torch_mod)
        if kind == "conv":
            if mod is None or "weight" not in mod:
                raise ValueError(f"slowfast ckpt missing conv {torch_mod!r} "
                                 f"(have e.g. {sorted(by_base)[:8]})")
            repl[port] = mod["weight"]
        else:
            if mod is None or "running_mean" not in mod:
                raise ValueError(f"slowfast ckpt missing bn {torch_mod!r}")
            repl[f"{port}.scale"], repl[f"{port}.bias"] = _fold_bn(mod, eps)
    leftover = [b for b in by_base if b not in used]
    if leftover:
        raise ValueError(f"slowfast ckpt has unmapped modules: {leftover}")

    out = dict(params)
    for key, w in repl.items():
        if key in params:
            have = tuple(params[key].shape)
            if have != tuple(w.shape):
                raise ValueError(f"shape mismatch at {key}: port {have} vs "
                                 f"torch {w.shape}")
            out[key] = _f32(w)
    missed = sorted(set(repl) - set(params))
    if missed:
        raise ValueError(f"slowfast import: no port slot for {missed[:10]} "
                         f"({len(missed)} total) — wrong layers/norm?")
    return out


# pyslowfast's c2 -> pytorch name conversion for the SlowFast blob families
# of SLOWFAST_8x8_R50.pkl (avtex's rules, from pyslowfast's
# c2_model_loading.get_name_convert_func); a blob no rule matches keeps its
# name and surfaces in convert_slowfast's coverage check.
def _c2_branch(num: str, letter: str) -> str:
    return f"branch2.{letter}" if num == "2" else "branch1"


_C2_RULES = (
    (r"^t_pool1_subsample_bn_(.*)$", r"s1_fuse.bn.\1"),
    (r"^t_pool1_subsample_(.*)$", r"s1_fuse.conv_f2s.\1"),
    (r"^t_res(\d+)_(\d+)_branch2c_bn_subsample_bn_(.*)$",
     lambda m: f"s{int(m.group(1)) + 1}_fuse.bn.{m.group(3)}"),
    (r"^t_res(\d+)_(\d+)_branch2c_bn_subsample_(.*)$",
     lambda m: f"s{int(m.group(1)) + 1}_fuse.conv_f2s.{m.group(3)}"),
    (r"^conv1_fast_(.*)$", r"s1.pathway1_stem.conv.\1"),
    (r"^res_conv1_fast_bn_(.*)$", r"s1.pathway1_stem.bn.\1"),
    (r"^conv1_(.*)$", r"s1.pathway0_stem.conv.\1"),
    (r"^res_conv1_bn_(.*)$", r"s1.pathway0_stem.bn.\1"),
    (r"^res(\d)_(\d+)_branch(\d)([a-c]?)_bn_fast_(.*)$",
     lambda m: f"s{m.group(1)}.pathway1_res{m.group(2)}."
               f"{_c2_branch(m.group(3), m.group(4))}_bn.{m.group(5)}"),
    (r"^res(\d)_(\d+)_branch(\d)([a-c]?)_fast_(.*)$",
     lambda m: f"s{m.group(1)}.pathway1_res{m.group(2)}."
               f"{_c2_branch(m.group(3), m.group(4))}.{m.group(5)}"),
    (r"^res(\d)_(\d+)_branch(\d)([a-c]?)_bn_(.*)$",
     lambda m: f"s{m.group(1)}.pathway0_res{m.group(2)}."
               f"{_c2_branch(m.group(3), m.group(4))}_bn.{m.group(5)}"),
    (r"^res(\d)_(\d+)_branch(\d)([a-c]?)_(.*)$",
     lambda m: f"s{m.group(1)}.pathway0_res{m.group(2)}."
               f"{_c2_branch(m.group(3), m.group(4))}.{m.group(5)}"),
    (r"^pred_(.*)$", r"head.projection.\1"),
)

_C2_LEAF = {"w": "weight", "b": "bias", "s": "weight", "rm": "running_mean",
            "riv": "running_var"}


def _c2_name_to_pt(name: str) -> str:
    for pat, rep in _C2_RULES:
        m = re.match(pat, name)
        if m:
            return rep(m) if callable(rep) else re.sub(pat, rep, name)
    return name


def _numpy_globals() -> Dict[Tuple[str, str], object]:
    """What a caffe2 blob pickle may name: numpy's array, dtype and scalar
    reconstruction (under ``numpy.core`` as py2 and numpy 1 pickles name
    it, and ``numpy._core`` as numpy 2 does) and ``_codecs.encode``
    (protocol-2 bytes)."""
    import codecs
    import importlib
    import importlib.util
    core = "numpy._core" if importlib.util.find_spec("numpy._core") \
        else "numpy.core"
    multiarray = importlib.import_module(f"{core}.multiarray")
    numeric = importlib.import_module(f"{core}.numeric")
    out: Dict[Tuple[str, str], object] = {
        ("numpy", "ndarray"): np.ndarray, ("numpy", "dtype"): np.dtype,
        ("_codecs", "encode"): codecs.encode}
    for mod in ("numpy.core", "numpy._core"):
        out[(f"{mod}.multiarray", "_reconstruct")] = multiarray._reconstruct
        out[(f"{mod}.multiarray", "scalar")] = multiarray.scalar
        out[(f"{mod}.numeric", "_frombuffer")] = numeric._frombuffer
    return out


class _BlobUnpickler(pickle.Unpickler):
    """Unpickles numpy arrays and plain data, nothing else."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._allowed = _numpy_globals()

    def find_class(self, module: str, name: str):
        obj = self._allowed.get((module, name))
        if obj is None:
            raise pickle.UnpicklingError(
                f"{module}.{name} is not allowed in a caffe2 blob pickle")
        return obj


def _read_c2_pickle(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        obj = _BlobUnpickler(f, encoding="latin1").load()
    blobs = obj.get("blobs", obj) if isinstance(obj, dict) else obj
    out = {}
    for name, v in blobs.items():
        if not isinstance(v, np.ndarray) or "momentum" in name:
            continue
        base, _, leaf = name.rpartition("_")
        if name.endswith("_riv"):
            base, leaf = name[: -len("_riv")], "riv"
        elif name.endswith("_rm"):
            base, leaf = name[: -len("_rm")], "rm"
        if leaf not in _C2_LEAF:
            continue
        pt_base, _, pt_leaf = _c2_name_to_pt(f"{base}_{leaf}").rpartition(".")
        out[f"{pt_base}.{_C2_LEAF.get(pt_leaf, pt_leaf)}"] = v
    return out


def load_slowfast_state(path: str) -> Dict[str, np.ndarray]:
    """A SlowFast checkpoint as ``{pytorch-format name: numpy array}``: a
    torch save (``load_torch_state``; ``model.`` stripped) when it reads as
    one and holds tensors, else the caffe2 pickle of the pyslowfast model
    zoo (BN leaves ``_s`` -> weight, ``_b`` -> bias, ``_rm`` / ``_riv`` ->
    the running statistics; ``*momentum*`` blobs and non-arrays skipped).
    Raises ``RuntimeError`` with both readers' errors when neither reads
    the file."""
    try:
        state = load_torch_state(path)
    except Exception as e:  # not a torch save: try the caffe2 pickle
        torch_error = _first_line(e)
    else:
        if state:
            return {k[len("model."):] if k.startswith("model.") else k: v
                    for k, v in state.items()}
        torch_error = "no tensors"
    try:
        return _read_c2_pickle(path)
    except Exception as e:
        raise RuntimeError(
            f"cannot read {path} as a torch save ({torch_error}) or as a "
            f"caffe2 pickle ({_first_line(e)})") from e


def _first_line(e: Exception) -> str:
    lines = str(e).strip().splitlines()
    return f"{type(e).__name__}: {lines[0] if lines else ''}"


def maybe_load_encoder(arch: str, module: nn.Module,
                       params: Mapping[str, torch.Tensor], *example_args,
                       path: Optional[str] = None, context: str = ""):
    """Load the pretrained file that ``find_encoder_checkpoint(arch, path)``
    finds into ``params`` (``module``'s state_dict, ``norm="affine"``):
    ``convert_slowfast`` for ``slowfast``, else ``convert_bn_folded`` with
    ``fc.*`` dropped. Returns (state, loaded); without a file, the
    parameters unchanged and no message (the files are external)."""
    found = find_encoder_checkpoint(arch, path)
    if found is None:
        return dict(params), False
    if arch == "slowfast":
        out = convert_slowfast(load_slowfast_state(found), params)
    else:
        out = convert_bn_folded(_without_fc(load_torch_state(found)), module,
                                params, *example_args)
    print(f"[avtex_torch] loaded pretrained {arch} weights from {found} "
          f"({context})")
    return out, True


def _without_fc(state: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    # the classifier: the feature forward never uses it
    return {k: v for k, v in state.items() if not k.startswith("fc.")}


def maybe_load_encoder_into_model(arch: str,
                                  model_state: Mapping[str, torch.Tensor], *,
                                  window: int = 8, path: Optional[str] = None,
                                  context: str = "",
                                  encoder: Optional[nn.Module] = None):
    """Graft the pretrained encoder file that ``find_encoder_checkpoint``
    finds into both ``q_embedder.video_encoder.*`` and
    ``t_embedder.video_encoder.*`` of a ContrastiveTextures state_dict
    (``norm="affine"``), as the reference starts both towers from it.
    ``encoder`` gives the call order of a BN-folded import (None: a
    float32 ``build_encoder(arch, norm="affine")``), run on a zero clip of
    ``max(window, 4)`` frames of 32^2. A ``ValueError`` of the import warns
    loudly and keeps the current weights. Returns (state, loaded)."""
    found = find_encoder_checkpoint(arch, path)
    if found is None:
        return dict(model_state), False
    towers = [f"{t}.video_encoder." for t in ("q_embedder", "t_embedder")
              if any(k.startswith(f"{t}.video_encoder.") for k in model_state)]
    if not towers:
        return dict(model_state), False
    if arch == "slowfast":
        file_state = load_slowfast_state(found)

        def convert(sub):
            return convert_slowfast(file_state, sub)
    else:
        from avtex_torch.device import module_device
        from avtex_torch.nn.encoders import build_encoder
        file_state = _without_fc(load_torch_state(found))
        if encoder is None:
            encoder = build_encoder(arch, torch.float32, norm="affine")[0]
        example = torch.zeros((1, max(window, 4), 32, 32, 3),
                              device=module_device(encoder))

        def convert(sub):
            return convert_bn_folded(file_state, encoder, sub, example)
    out = dict(model_state)
    for prefix in towers:
        sub = {k[len(prefix):]: v for k, v in model_state.items()
               if k.startswith(prefix)}
        try:
            out.update({prefix + k: v for k, v in convert(sub).items()})
        except ValueError as e:
            print(f"[avtex_torch] WARNING: pretrained {arch} import from "
                  f"{found} failed ({e}); continuing with current weights",
                  file=sys.stderr)
            return dict(model_state), False
    print(f"[avtex_torch] loaded pretrained {arch} encoder weights from "
          f"{found} into both towers ({context})")
    return out, True


# ---- seeded files under the reference's names ---------------------------- #

def _draw_conv(g: np.random.Generator, shape) -> np.ndarray:
    fan_in = int(np.prod(shape[1:]))
    return (g.standard_normal(shape) * np.sqrt(2.0 / fan_in)).astype(
        np.float32)


def _draw_bn(g: np.random.Generator, ch: int, prefix: str,
             out: Dict[str, np.ndarray]) -> None:
    out[f"{prefix}.weight"] = (1 + 0.1 * g.standard_normal(ch)).astype(
        np.float32)
    out[f"{prefix}.bias"] = (0.1 * g.standard_normal(ch)).astype(np.float32)
    out[f"{prefix}.running_mean"] = (0.1 * g.standard_normal(ch)).astype(
        np.float32)
    out[f"{prefix}.running_var"] = (0.5 + g.random(ch)).astype(np.float32)
    out[f"{prefix}.num_batches_tracked"] = np.array(0, np.int64)


def slowfast_reference_state(layers: Tuple[int, ...] = (3, 4, 6, 3),
                             width: int = 64, seed: int = 0,
                             num_classes: int = 400
                             ) -> Dict[str, np.ndarray]:
    """A seeded random SlowFast-R50 state under pyslowfast's names (what
    ``load_slowfast_state`` returns for ``SLOWFAST_8x8_R50``): conv weights
    ~ N(0, 2 / fan_in), BN weights near 1, biases and means near 0,
    ``running_var`` in [0.5, 1.5), ``num_batches_tracked`` and a
    ``head.projection``; shapes those of ``SlowFastR50(layers, width)``."""
    from avtex_torch.nn.slowfast import SlowFastR50
    with torch.device("meta"):
        meta = SlowFastR50(layers, width, norm="affine")
    shapes = {k: tuple(v.shape) for k, v in meta.state_dict().items()}
    g = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for kind, torch_mod, port in slowfast_name_map(
            tuple(layers), lambda t: f"{_port_block(t, layers)}.Conv_3.weight"
            in shapes):
        if kind == "conv":
            out[f"{torch_mod}.weight"] = _draw_conv(g, shapes[port])
        else:
            _draw_bn(g, shapes[f"{port}.scale"][0], torch_mod, out)
    out["head.projection.weight"] = (0.01 * g.standard_normal(
        (num_classes, meta.feat_dim))).astype(np.float32)
    out["head.projection.bias"] = np.zeros(num_classes, np.float32)
    return out


def _port_block(torch_block: str, layers: Tuple[int, ...]) -> str:
    """``s{2+i}.pathway{p}_res{j}`` -> ``SFBottleneck_{2g+p}``."""
    m = re.fullmatch(r"s(\d+)\.pathway(\d)_res(\d+)", torch_block)
    i, p, j = int(m.group(1)) - 2, int(m.group(2)), int(m.group(3))
    return f"SFBottleneck_{2 * (sum(layers[:i]) + j) + p}"


_PT_LEAF_C2 = {"running_mean": "rm", "running_var": "riv", "bias": "b"}


def slowfast_c2_blobs(state: Mapping[str, np.ndarray],
                      layers: Tuple[int, ...] = (3, 4, 6, 3)
                      ) -> Dict[str, np.ndarray]:
    """A pyslowfast-named state -> the caffe2 blobs of the model zoo's
    ``.pkl`` (``conv1_w``, ``res_conv1_bn_s``, ``res2_0_branch2a_fast_w``,
    ``res2_0_branch2a_bn_fast_riv``, ``t_res2_2_branch2c_bn_subsample_w``,
    ``pred_w`` ...), with a ``*_momentum`` blob beside each conv weight as
    the zoo's files carry; ``num_batches_tracked`` has no blob. Pickle
    ``{"blobs": ...}`` to write the file."""
    out: Dict[str, np.ndarray] = {}
    for key, v in state.items():
        base, _, leaf = key.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        is_bn = base.endswith("bn") or base.endswith("_bn")
        c2_leaf = _PT_LEAF_C2.get(leaf, "s" if is_bn else "w")
        m = re.fullmatch(r"s(\d+)\.pathway(\d)_res(\d+)\.(branch2\.([abc])"
                         r"|branch1)(_bn)?", base)
        if base == "head.projection":
            name = f"pred_{c2_leaf}"
        elif base.startswith("s1.pathway"):
            fast = "_fast" if base.startswith("s1.pathway1") else ""
            name = (f"res_conv1{fast}_bn_{c2_leaf}" if is_bn
                    else f"conv1{fast}_{c2_leaf}")
        elif base.startswith("s1_fuse."):
            name = f"t_pool1_subsample{'_bn' if is_bn else ''}_{c2_leaf}"
        elif re.fullmatch(r"s\d+_fuse\.(conv_f2s|bn)", base):
            k = int(base[1:base.index("_")])
            name = (f"t_res{k - 1}_{layers[k - 2] - 1}_branch2c_bn_subsample"
                    f"{'_bn' if is_bn else ''}_{c2_leaf}")
        elif m:
            stage, path, j = m.group(1), m.group(2), m.group(3)
            branch = f"branch2{m.group(5)}" if m.group(5) else "branch1"
            fast = "_fast" if path == "1" else ""
            name = (f"res{stage}_{j}_{branch}_bn{fast}_{c2_leaf}" if is_bn
                    else f"res{stage}_{j}_{branch}{fast}_{c2_leaf}")
        else:
            raise KeyError(f"no caffe2 blob name for {key}")
        out[name] = np.asarray(v)
        if not is_bn and leaf == "weight" and np.ndim(v) >= 3:
            out[f"{name}_momentum"] = np.zeros_like(np.asarray(v))
    return out


def resnet_reference_state(model: nn.Module, layers: Tuple[int, ...],
                           seed: int = 0, num_classes: int = 1000
                           ) -> Dict[str, np.ndarray]:
    """A seeded random BN state of ``model`` (a ``ResNet3D`` or
    ``ResNet2D``, any norm) under torchvision's / 3D-ResNets-PyTorch's
    names (``r3d18_KM_200ep.pth``, ``resnet18-imagenet.pth``): ``conv1``,
    ``bn1``, ``layer{i}.{j}.conv{k}`` / ``bn{k}`` / ``downsample.{0,1}``,
    ``fc``; draws as ``slowfast_reference_state``'s, in declaration
    order."""
    g = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}

    def conv_bn(conv: nn.Module, conv_name: str, bn_name: str) -> None:
        out[f"{conv_name}.weight"] = _draw_conv(g, tuple(conv.weight.shape))
        _draw_bn(g, conv.weight.shape[0], bn_name, out)

    conv_bn(model.Conv_0, "conv1", "bn1")
    blocks = [m for name, m in model.named_children()
              if re.fullmatch(r"(BasicBlock[23]D|Bottleneck3D)_\d+", name)]
    idx = 0
    for i, n_blocks in enumerate(layers):
        for j in range(n_blocks):
            blk, p = blocks[idx], f"layer{i + 1}.{j}"
            for k in range(blk.n_main):
                conv_bn(getattr(blk, f"Conv_{k}"), f"{p}.conv{k + 1}",
                        f"{p}.bn{k + 1}")
            if blk.need_proj:
                conv_bn(getattr(blk, f"Conv_{blk.n_main}"),
                        f"{p}.downsample.0", f"{p}.downsample.1")
            idx += 1
    out["fc.weight"] = (0.01 * g.standard_normal(
        (num_classes, model.feat_dim))).astype(np.float32)
    out["fc.bias"] = np.zeros(num_classes, np.float32)
    return out
