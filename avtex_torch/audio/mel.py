"""Log-mel frontend with VGGish feature semantics (the port of
avtex/audio/mel.py).

The window, the mel filterbank and the example counts are numpy, as in
avtex, and identical to its values. Framing is ``Tensor.unfold``; the
spectrogram runs on the waveform's device in fp32: periodic Hann, the
512-point ``torch.fft.rfft`` magnitude (cuFFT on the card), one
``[frames, 257] @ [257, 64]`` product with the mel filterbank (avtex
computes it outside Pallas too), then ``log(x + 0.01)``. The product
runs in full fp32 as long as ``torch.backends.cuda.matmul.allow_tf32``
keeps its default, False: the log magnifies relative error in quiet
frames.

Resampling to 16 kHz happens on the host (scipy ``resample_poly``), as in
avtex.
"""

from __future__ import annotations

from math import gcd

import numpy as np
import torch

from avtex_torch.device import resolve_device

from . import params


def periodic_hann(window_length: int) -> np.ndarray:
    """Hann window of period N (not the symmetric period-(N-1) variant)."""
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(window_length)
                               / window_length))


def _hertz_to_mel(f):
    return params.MEL_HIGH_FREQUENCY_Q * np.log1p(
        np.asarray(f, dtype=np.float64) / params.MEL_BREAK_FREQUENCY_HERTZ)


def mel_weight_matrix(num_mel_bins: int = params.NUM_MEL_BINS,
                      num_spectrogram_bins: int = params.FFT_LENGTH // 2 + 1,
                      sample_rate: float = params.SAMPLE_RATE,
                      lower_edge_hertz: float = params.MEL_MIN_HZ,
                      upper_edge_hertz: float = params.MEL_MAX_HZ
                      ) -> np.ndarray:
    """[num_spectrogram_bins, num_mel_bins] triangular HTK-style mel
    filterbank, linear in mel space, with the DC bin zeroed."""
    nyquist = sample_rate / 2.0
    if not (0.0 <= lower_edge_hertz < upper_edge_hertz <= nyquist):
        raise ValueError("bad mel band edges")
    spec_mel = _hertz_to_mel(np.linspace(0.0, nyquist, num_spectrogram_bins))
    edges = np.linspace(_hertz_to_mel(lower_edge_hertz),
                        _hertz_to_mel(upper_edge_hertz), num_mel_bins + 2)
    lower, center, upper = edges[:-2], edges[1:-1], edges[2:]
    up = (spec_mel[:, None] - lower[None, :]) / (center - lower)[None, :]
    down = (upper[None, :] - spec_mel[:, None]) / (upper - center)[None, :]
    w = np.maximum(0.0, np.minimum(up, down))
    w[0, :] = 0.0  # exclude the DC bin
    return w


def num_mel_frames(num_samples: int) -> int:
    """Complete STFT frames for a waveform of ``num_samples`` (no padding)."""
    if num_samples < params.WINDOW_SAMPLES:
        return 0
    return 1 + (num_samples - params.WINDOW_SAMPLES) // params.HOP_SAMPLES


def num_examples(num_samples: int) -> int:
    """Number of [100, 64] examples for a waveform of ``num_samples``."""
    frames = num_mel_frames(num_samples)
    if frames < params.EXAMPLE_WINDOW_FRAMES:
        return 0
    return 1 + (frames - params.EXAMPLE_WINDOW_FRAMES) \
        // params.EXAMPLE_HOP_FRAMES


def frame_signal(x: torch.Tensor, window_length: int, hop_length: int
                 ) -> torch.Tensor:
    """[num_frames, window_length, ...] overlapping frames along dim 0;
    an incomplete tail frame is dropped, a signal shorter than one window
    gives no frames."""
    if x.shape[0] < window_length:
        return x.new_zeros((0, window_length) + tuple(x.shape[1:]))
    return x.unfold(0, window_length, hop_length).movedim(-1, 1)


def log_mel_spectrogram(data: torch.Tensor) -> torch.Tensor:
    """[num_frames, 64] log mel spectrogram of a 16 kHz waveform, on the
    waveform's device, in fp32."""
    frames = frame_signal(data.float(), params.WINDOW_SAMPLES,
                          params.HOP_SAMPLES)
    if not len(frames):  # (an FFT of no frames is an error in some backends)
        return frames.new_zeros((0, params.NUM_MEL_BINS))
    window = torch.from_numpy(periodic_hann(params.WINDOW_SAMPLES)).to(
        frames.device, torch.float32)
    spec = torch.fft.rfft(frames * window, n=params.FFT_LENGTH).abs()
    mel = torch.from_numpy(mel_weight_matrix()).to(frames.device,
                                                   torch.float32)
    return torch.log(spec @ mel + params.LOG_OFFSET)


def resample_to_16k(data: np.ndarray, sample_rate: int) -> np.ndarray:
    """Host-side polyphase resample to the frontend rate (16 kHz)."""
    if sample_rate == params.SAMPLE_RATE:
        return np.asarray(data, dtype=np.float32)
    from scipy.signal import resample_poly
    g = gcd(int(params.SAMPLE_RATE), int(sample_rate))
    out = resample_poly(np.asarray(data, dtype=np.float64),
                        params.SAMPLE_RATE // g, sample_rate // g)
    return out.astype(np.float32)


def waveform_to_examples(data: np.ndarray, sample_rate: int,
                         device=None) -> torch.Tensor:
    """Waveform ([T] or [T, channels]) -> [num_examples, 100, 64] log-mel
    example patches on ``device`` (``cuda`` unless ``device="cpu"``):
    mono mix and 16 kHz resampling on the host, then the spectrogram and
    the 1.0 s / 0.1 s-hop example framing on the device."""
    dev = resolve_device(device)
    data = np.asarray(data)
    if data.ndim > 1:
        data = data.mean(axis=1)
    wave = torch.from_numpy(resample_to_16k(data, sample_rate)).to(dev)
    return frame_signal(log_mel_spectrogram(wave),
                        params.EXAMPLE_WINDOW_FRAMES,
                        params.EXAMPLE_HOP_FRAMES)
