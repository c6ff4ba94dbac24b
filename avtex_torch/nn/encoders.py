"""Encoder registry (the port of avtex/nn/encoders.py).

``build_encoder(arch)`` returns ``(module, feat_dim, input_kind)``;
input_kind "clip" means ``[B, T, H, W, 3]`` windows, "slowfast" a
``(slow, fast)`` pathway tuple from ``slowfast_pathways``. avtex's twelve
archs: SlowFast-R50, the 3D ResNets (``resnet10/18/34/50``), the 3D
ResNeXts (``resnext50/101/152``), the 3D DenseNets (``densenet121/169``)
and the per-frame 2D ResNets (``resnet18_2d/34_2d``). ``feat_dim`` is the
encoder's real feature width.
"""

from __future__ import annotations

import functools
import inspect
import sys
from typing import Any

import torch

from . import densenet3d, resnet2d, resnet3d, resnext3d, slowfast

ENCODER_REGISTRY = {
    "resnet10": (resnet3d.resnet3d10, "clip"),
    "resnet18": (resnet3d.resnet3d18, "clip"),
    "resnet34": (resnet3d.resnet3d34, "clip"),
    "resnet50": (resnet3d.resnet3d50, "clip"),
    "resnext50": (resnext3d.resnext3d50, "clip"),
    "resnext101": (resnext3d.resnext3d101, "clip"),
    "resnext152": (resnext3d.resnext3d152, "clip"),
    "densenet121": (densenet3d.densenet3d121, "clip"),
    "resnet18_2d": (functools.partial(resnet2d.FrameMean2D,
                                      layers=(2, 2, 2, 2)), "clip"),
    "resnet34_2d": (functools.partial(resnet2d.FrameMean2D,
                                      layers=(3, 4, 6, 3)), "clip"),
    "densenet169": (densenet3d.densenet3d169, "clip"),
    "slowfast": (slowfast.SlowFastR50, "slowfast"),
}


def build_encoder(arch: str, dtype: torch.dtype = torch.bfloat16,
                  norm: str = "group", remat: bool = False, **kwargs: Any):
    """Instantiate a video encoder: (module, feat_dim, input_kind).

    ``remat`` checkpoints the encoder's residual blocks (training memory);
    an encoder without the field (DenseNet, the 2D wrappers) warns and
    trains without it, as avtex does. ``kwargs`` reach the encoder's
    constructor (SlowFast: ``layers``, ``width``, ``fuse``, ``s2d_stem``;
    ResNet3D / ResNeXt3D: ``layers``, ``width``, ``groups``; DenseNet3D:
    ``block_config``, ``growth_rate``, ``init_features``).
    """
    if arch not in ENCODER_REGISTRY:
        raise ValueError(f"unknown encoder arch {arch!r}; have "
                         f"{sorted(ENCODER_REGISTRY)}")
    factory, kind = ENCODER_REGISTRY[arch]
    if "remat" in inspect.signature(factory).parameters:
        kwargs["remat"] = remat
    elif remat:
        print(f"[avtex_torch] WARNING: encoder {arch!r} does not support "
              "remat; training without activation checkpointing",
              file=sys.stderr)
    module = factory(dtype=dtype, norm=norm, **kwargs)
    return module, module.feat_dim, kind
