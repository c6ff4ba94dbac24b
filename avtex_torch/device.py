"""Device selection shared by every entry point of the port."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    There is no silent CPU fallback: asking for CUDA (explicitly or by
    default) on a machine without a usable GPU raises.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "avtex_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU explicitly")
    return dev


def module_device(module: torch.nn.Module) -> torch.device:
    """Device of a module's parameters."""
    return next(module.parameters()).device
