"""Farneback optical-flow features (the port of avtex/utils/flow.py, the
reference's standalone flow dump as a function). OpenCV is imported at
use, as ``avtex_torch.media`` does: without it these raise."""

from __future__ import annotations

from typing import Optional

import numpy as np

from avtex_torch.media.video import _cv2


def farneback_flow(frames: np.ndarray, pyr_scale: float = 0.5,
                   levels: int = 3, winsize: int = 15,
                   iterations: int = 3) -> np.ndarray:
    """Dense optical flow between consecutive uint8 RGB frames [T, H, W, 3]
    -> float32 [T-1, H, W, 2] (dx, dy)."""
    cv2 = _cv2()
    frames = np.asarray(frames)
    grays = [cv2.cvtColor(f[:, :, ::-1], cv2.COLOR_BGR2GRAY) for f in frames]
    out = [cv2.calcOpticalFlowFarneback(a, b, None, pyr_scale, levels,
                                        winsize, iterations, 5, 1.2, 0)
           for a, b in zip(grays[:-1], grays[1:])]
    return np.stack(out).astype(np.float32)


def flow_magnitude_features(frames: np.ndarray,
                            window: Optional[int] = None) -> np.ndarray:
    """Per-frame mean flow magnitude [T] (the first frame repeats the
    second's); ``window`` is unused, as in avtex."""
    flow = farneback_flow(frames)
    mag = np.linalg.norm(flow, axis=-1).mean(axis=(1, 2))
    return np.concatenate([[mag[0]], mag])
