"""Video decode/encode on the host (OpenCV), the port's copy of
avtex/media/video.py.

OpenCV is imported inside the functions that need it: a machine without
it (for example a GPU host that only serves from decoded frames) can
import the port and gets a clear error only when it decodes or encodes a
video. ``write_frames_png`` needs no OpenCV (``avtex_torch/media/png.py``).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "OpenCV (cv2) is required for video decode/encode but is not "
            "installed; pass decoded frames instead "
            "(TextureServer.from_frames / synthesize_frames)") from e
    return cv2


def video_fps(path: str) -> float:
    """Container frame rate."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            raise FileNotFoundError(path)
        return float(cap.get(cv2.CAP_PROP_FPS))
    finally:
        cap.release()


def read_video(path: str, subsample_rate: int = 1,
               max_frames: Optional[int] = None) -> Tuple[np.ndarray, float]:
    """Decode a video file to (uint8 RGB [T, H, W, 3], container fps).

    ``subsample_rate`` keeps every k-th frame; ``max_frames`` caps the
    decoded (pre-subsample) frames. fps is the original stream's rate.
    """
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(path)
    fps = float(cap.get(cv2.CAP_PROP_FPS))
    frames = []
    i = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if max_frames is not None and i >= max_frames:
                break
            if i % subsample_rate == 0:
                frames.append(frame[:, :, ::-1])  # BGR -> RGB
            i += 1
    finally:
        cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.ascontiguousarray(np.stack(frames)), fps


def write_video(frames: np.ndarray, path: str, fps: float,
                fourcc: str = "mp4v") -> str:
    """Encode uint8 RGB [T, H, W, 3] frames to a video file."""
    cv2 = _cv2()
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = np.clip(frames, 0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps,
                             (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"VideoWriter failed to open {path}")
    try:
        for f in frames:
            writer.write(np.ascontiguousarray(f[:, :, ::-1]))  # RGB -> BGR
    finally:
        writer.release()
    return path


def write_frames_png(frames: np.ndarray, folder: str, start: int = 0) -> str:
    """Write uint8 RGB [T, H, W, 3] frames as ``<start + i:06d>.png`` in
    ``folder`` (made if missing), as avtex does; returns ``folder``. The
    files are OpenCV's bytes (``avtex_torch.media.png``), without
    OpenCV."""
    from .png import encode_png
    os.makedirs(folder, exist_ok=True)
    for i, f in enumerate(np.asarray(frames)):
        with open(os.path.join(folder, f"{start + i:06d}.png"), "wb") as fh:
            fh.write(encode_png(f))
    return folder
