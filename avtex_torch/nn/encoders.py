"""Encoder registry (the port of avtex/nn/encoders.py:47-81).

``build_encoder(arch)`` returns ``(module, feat_dim, input_kind)``;
input_kind "clip" means ``[B, T, H, W, 3]`` windows, "slowfast" a
``(slow, fast)`` pathway tuple from ``slowfast_pathways``. Ported:
SlowFast-R50 and the 3D ResNets (``resnet10/18/34/50``); every other
avtex arch raises ``NotImplementedError`` naming the ROADMAP item that
ports it.
"""

from __future__ import annotations

import inspect
import sys
from typing import Any

import torch

from . import resnet3d, slowfast

_PORTED = {"slowfast": (slowfast.SlowFastR50, "slowfast"),
           "resnet10": (resnet3d.resnet3d10, "clip"),
           "resnet18": (resnet3d.resnet3d18, "clip"),
           "resnet34": (resnet3d.resnet3d34, "clip"),
           "resnet50": (resnet3d.resnet3d50, "clip")}

_LATER = {
    "resnext50": "ROADMAP.md Queue 1 'Remaining encoders'",
    "resnext101": "ROADMAP.md Queue 1 'Remaining encoders'",
    "resnext152": "ROADMAP.md Queue 1 'Remaining encoders'",
    "densenet121": "ROADMAP.md Queue 1 'Remaining encoders'",
    "densenet169": "ROADMAP.md Queue 1 'Remaining encoders'",
    "resnet18_2d": "ROADMAP.md Queue 1 'Remaining encoders'",
    "resnet34_2d": "ROADMAP.md Queue 1 'Remaining encoders'",
}


def build_encoder(arch: str, dtype: torch.dtype = torch.bfloat16,
                  norm: str = "group", remat: bool = False, **kwargs: Any):
    """Instantiate a video encoder: (module, feat_dim, input_kind).

    ``remat`` checkpoints the encoder's residual blocks (training memory;
    an encoder without the field warns and trains without it, as avtex
    does). ``kwargs`` reach the encoder's constructor (SlowFast:
    ``layers``, ``width``, ``fuse``, ``s2d_stem``; ResNet3D: ``layers``,
    ``width``).
    """
    if arch in _LATER:
        raise NotImplementedError(
            f"encoder {arch!r} is not ported to avtex_torch yet: "
            f"{_LATER[arch]}")
    if arch not in _PORTED:
        raise ValueError(f"unknown encoder arch {arch!r}; have "
                         f"{sorted(set(_PORTED) | set(_LATER))}")
    factory, kind = _PORTED[arch]
    if "remat" in inspect.signature(factory).parameters:
        kwargs["remat"] = remat
    elif remat:
        print(f"[avtex_torch] WARNING: encoder {arch!r} does not support "
              "remat; training without activation checkpointing",
              file=sys.stderr)
    module = factory(dtype=dtype, norm=norm, **kwargs)
    return module, module.feat_dim, kind
