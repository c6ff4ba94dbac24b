"""WAV read/write on the host (scipy), the port's copy of
avtex/media/audio_io.py."""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

_INT_SCALES = {np.dtype(np.int16): 2 ** 15, np.dtype(np.int32): 2 ** 31,
               np.dtype(np.uint8): 2 ** 7}


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Load a wav as float32 in [-1, 1]: (waveform [T] or [T, C], rate)."""
    from scipy.io import wavfile
    sr, data = wavfile.read(path)
    if data.dtype in _INT_SCALES:
        scale = _INT_SCALES[data.dtype]
        if data.dtype == np.uint8:
            data = data.astype(np.float32) - 128.0
        data = data.astype(np.float32) / scale
    else:
        data = data.astype(np.float32)
    return data, int(sr)


def write_wav(path: str, data: np.ndarray, sample_rate: int) -> str:
    """Write a float waveform in [-1, 1] as 16-bit PCM."""
    from scipy.io import wavfile
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    pcm = np.clip(np.asarray(data, dtype=np.float32), -1.0, 1.0)
    wavfile.write(path, int(sample_rate),
                  (pcm * (2 ** 15 - 1)).astype(np.int16))
    return path
