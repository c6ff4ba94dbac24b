"""Random audio-shift baseline (the port of avtex/baselines/shift.py)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def shift_audio(audio: np.ndarray, sample_rate: int,
                shift_seconds: Optional[float] = None, seed: int = 0
                ) -> Tuple[np.ndarray, float]:
    """Circularly shift a waveform EARLIER by ``shift_seconds`` (a random
    integer 4..11 s from ``default_rng(seed)`` when None, the reference's
    ``np.random.randint(4, 12)``): the reference's left roll
    ``new[:-n] = audio[n:]; new[-n:] = audio[:n]``. Returns (shifted,
    seconds)."""
    if shift_seconds is None:
        rng = np.random.default_rng(seed)
        shift_seconds = float(rng.integers(4, 12))
    n = int(round(shift_seconds * sample_rate))
    return np.roll(audio, -n, axis=0), shift_seconds
