"""Encoder registry (the port of avtex/nn/encoders.py:47-81).

``build_encoder(arch)`` returns ``(module, feat_dim, input_kind)``;
input_kind "slowfast" means a ``(slow, fast)`` pathway tuple from
``slowfast_pathways``. Only SlowFast-R50 is ported so far; every other
avtex arch raises ``NotImplementedError`` naming the ROADMAP item that
ports it.
"""

from __future__ import annotations

from typing import Any

import torch

from . import slowfast

_PORTED = {"slowfast": (slowfast.SlowFastR50, "slowfast")}

_LATER = {
    "resnet10": "ROADMAP.md Queue 1 'CLI default encoder' (ResNet3D)",
    "resnet18": "ROADMAP.md Queue 1 'CLI default encoder' (ResNet3D)",
    "resnet34": "ROADMAP.md Queue 1 'CLI default encoder' (ResNet3D)",
    "resnet50": "ROADMAP.md Queue 1 'CLI default encoder' (ResNet3D)",
    "resnext50": "ROADMAP.md Queue 1 'Remaining encoders'",
    "resnext101": "ROADMAP.md Queue 1 'Remaining encoders'",
    "resnext152": "ROADMAP.md Queue 1 'Remaining encoders'",
    "densenet121": "ROADMAP.md Queue 1 'Remaining encoders'",
    "densenet169": "ROADMAP.md Queue 1 'Remaining encoders'",
    "resnet18_2d": "ROADMAP.md Queue 1 'Remaining encoders'",
    "resnet34_2d": "ROADMAP.md Queue 1 'Remaining encoders'",
}


def build_encoder(arch: str, dtype: torch.dtype = torch.bfloat16,
                  norm: str = "group", **kwargs: Any):
    """Instantiate a video encoder: (module, feat_dim, input_kind).

    ``kwargs`` reach the encoder's constructor (SlowFast: ``layers``,
    ``width``, ``fuse``).
    """
    if arch in _LATER:
        raise NotImplementedError(
            f"encoder {arch!r} is not ported to avtex_torch yet: "
            f"{_LATER[arch]}")
    if arch not in _PORTED:
        raise ValueError(f"unknown encoder arch {arch!r}; have "
                         f"{sorted(set(_PORTED) | set(_LATER))}")
    factory, kind = _PORTED[arch]
    module = factory(dtype=dtype, norm=norm, **kwargs)
    return module, module.feat_dim, kind
