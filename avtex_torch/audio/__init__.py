"""The log-mel audio frontend (the port of avtex/audio/)."""

from . import params
from .mel import (frame_signal, log_mel_spectrogram, mel_weight_matrix,
                  num_examples, num_mel_frames, periodic_hann,
                  resample_to_16k, waveform_to_examples)

__all__ = ["params", "frame_signal", "log_mel_spectrogram",
           "mel_weight_matrix", "num_examples", "num_mel_frames",
           "periodic_hann", "resample_to_16k", "waveform_to_examples"]
