"""Per-frame features for the classic baseline's distance matrix (the
port of avtex/classic/features.py).

Ported: "RGB", raw flattened frames with *no* per-row normalization.
Not yet: "ResNet" and "ResNet_VGGish" (they need the 2D ResNet-18, VGGish
and the log-mel frontend).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def rgb_features(frames: np.ndarray, device
                 ) -> Tuple[torch.Tensor, bool]:
    """(features [N, H*W*C] float32 on ``device``, normalize_rows=False).

    The uint8 frames cross to the device once and are converted there.
    """
    u8 = torch.as_tensor(np.ascontiguousarray(frames)).to(device)
    return u8.reshape(len(frames), -1).to(torch.float32), False


def frame_features(feats: str, frames: np.ndarray, device
                   ) -> Tuple[torch.Tensor, bool]:
    """Features for the ``-f`` mode ``feats``; only "RGB" is ported."""
    if feats == "RGB":
        return rgb_features(frames, device)
    if feats in ("ResNet", "ResNet_VGGish"):
        raise NotImplementedError(
            f"classic features {feats!r} are not ported to avtex_torch "
            f"yet: ROADMAP.md Queue 1 'Classic baseline' (ResNet features)")
    raise ValueError(f"unknown classic features {feats!r}")
