"""TensorBoard logger (tf.summary backend, a no-op without TensorFlow);
the port's own copy of avtex/obs/logger.py.

log_scalar / log_image / log_figure / log_video / log_histogram, keyed by
(tag, step).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


class Logger:
    def __init__(self, logdir: str, name: str = "run") -> None:
        self.logdir = os.path.join(logdir, name)
        self._writer = None
        try:  # tf is heavyweight; import lazily and tolerate absence
            import tensorflow as tf
            os.makedirs(self.logdir, exist_ok=True)
            self._writer = tf.summary.create_file_writer(self.logdir)
            self._tf = tf
        except Exception:  # noqa: BLE001
            self._tf = None

    def log_scalar(self, value: float, tag: str, step: int) -> None:
        if self._writer is None:
            return
        with self._writer.as_default():
            self._tf.summary.scalar(tag, float(value), step=step)

    def log_image(self, image: np.ndarray, tag: str, step: int) -> None:
        """image: uint8 [H, W, 3] or a batch [N, H, W, 3]."""
        if self._writer is None:
            return
        img = np.asarray(image)
        if img.ndim == 3:
            img = img[None]
        with self._writer.as_default():
            self._tf.summary.image(tag, img, step=step,
                                   max_outputs=img.shape[0])

    def log_figure(self, fig, tag: str, step: int) -> None:
        """Render a matplotlib figure to an image summary."""
        if self._writer is None:
            return
        import io
        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=100)
        buf.seek(0)
        img = self._tf.image.decode_png(buf.getvalue(), channels=3)
        with self._writer.as_default():
            self._tf.summary.image(tag, img[None], step=step)

    def log_video(self, frames: np.ndarray, tag: str, step: int,
                  max_frames: int = 8) -> None:
        """Log a clip as a horizontal frame strip (tf.summary has no
        native video)."""
        if self._writer is None:
            return
        f = np.asarray(frames)
        if f.ndim != 4 or len(f) == 0:
            return
        idx = np.linspace(0, len(f) - 1, min(max_frames, len(f))).astype(int)
        strip = np.concatenate([f[i] for i in idx], axis=1)
        self.log_image(strip, tag, step)

    def log_histogram(self, values: np.ndarray, tag: str, step: int,
                      bins: Optional[int] = None) -> None:
        if self._writer is None:
            return
        with self._writer.as_default():
            self._tf.summary.histogram(tag, np.asarray(values), step=step,
                                       buckets=bins)

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()
