"""The port's log-mel frontend (avtex_torch/audio/) against avtex's
(avtex/audio/), on the same seeded numpy waveforms.

- the mel filterbank, the periodic Hann window and the example counts are
  numpy in both and must be bit-identical;
- the log-mel spectrogram (torch.fft.rfft and one fp32 product in the
  port, jnp in avtex) within atol 1e-4: both are fp32 sums of ~257 terms
  followed by log(x + 0.01), which magnifies a relative error by at most
  x / (x + 0.01) < 1;
- ``waveform_to_examples`` on mono and stereo input at 16, 22.05 and
  44.1 kHz (the host resampler is the same scipy call) within atol 1e-4,
  and on a wave shorter than one example (no examples in both).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avtex.audio import mel as jax_mel
from avtex.audio import params as jax_params
from avtex_torch.audio import mel, params

torch.set_num_threads(1)


def _wave(seconds, sr, channels=1, seed=0):
    g = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1571 * t)
         + 0.05 * g.standard_normal(len(t)))
    x[: len(x) // 5] *= 1e-3  # a quiet stretch: log(x + 0.01) near its floor
    if channels > 1:
        x = np.stack([x * (1 - 0.3 * c) for c in range(channels)], -1)
    return x.astype(np.float32)


def test_constants_are_avtex_s():
    names = [n for n in dir(jax_params) if n.isupper()]
    assert names and all(getattr(params, n) == getattr(jax_params, n)
                         for n in names)


def test_mel_matrix_and_window_bit_identical():
    np.testing.assert_array_equal(mel.mel_weight_matrix(),
                                  jax_mel.mel_weight_matrix())
    np.testing.assert_array_equal(
        mel.mel_weight_matrix(32, 129, 8000.0, 100.0, 3000.0),
        jax_mel.mel_weight_matrix(32, 129, 8000.0, 100.0, 3000.0))
    for n in (400, 512, 7):
        np.testing.assert_array_equal(mel.periodic_hann(n),
                                      jax_mel.periodic_hann(n))
    with pytest.raises(ValueError, match="mel band edges"):
        mel.mel_weight_matrix(upper_edge_hertz=9000.0)


@pytest.mark.parametrize("n", [0, 399, 400, 559, 560, 16000, 16159, 17599,
                               17600, 16000 * 7 + 3])
def test_example_counts_identical(n):
    assert mel.num_mel_frames(n) == jax_mel.num_mel_frames(n)
    assert mel.num_examples(n) == jax_mel.num_examples(n)


def test_frame_signal_matches():
    x = np.arange(57, dtype=np.float32)
    for w, h in ((10, 3), (57, 5), (58, 5)):
        np.testing.assert_array_equal(
            mel.frame_signal(torch.from_numpy(x), w, h).numpy(),
            np.asarray(jax_mel.frame_signal(jnp.asarray(x), w, h)))
    x2 = np.arange(300, dtype=np.float32).reshape(150, 2)
    np.testing.assert_array_equal(
        mel.frame_signal(torch.from_numpy(x2), 100, 10).numpy(),
        np.asarray(jax_mel.frame_signal(jnp.asarray(x2), 100, 10)))


def test_log_mel_matches():
    x = _wave(1.7, 16000)
    got = mel.log_mel_spectrogram(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_mel.log_mel_spectrogram(jnp.asarray(x)))
    assert got.shape == want.shape == (mel.num_mel_frames(len(x)), 64)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("sr", [16000, 22050, 44100])
@pytest.mark.parametrize("channels", [1, 2])
def test_waveform_to_examples_matches(sr, channels):
    x = _wave(2.3, sr, channels, seed=sr + channels)
    got = mel.waveform_to_examples(x, sr, device="cpu")
    want = np.asarray(jax_mel.waveform_to_examples(x, sr))
    assert got.device.type == "cpu"
    assert tuple(got.shape) == want.shape and want.shape[1:] == (100, 64)
    assert len(want) == mel.num_examples(int(2.3 * 16000)) == 13
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("seconds", [0.01, 0.5])
def test_wave_shorter_than_one_example(seconds):
    x = _wave(seconds, 22050)
    got = mel.waveform_to_examples(x, 22050, device="cpu")
    want = np.asarray(jax_mel.waveform_to_examples(x, 22050))
    assert tuple(got.shape) == want.shape == (0, 100, 64)


def test_resample_identical():
    x = _wave(0.3, 44100)
    np.testing.assert_array_equal(mel.resample_to_16k(x, 44100),
                                  jax_mel.resample_to_16k(x, 44100))
    np.testing.assert_array_equal(mel.resample_to_16k(x, 16000), x)


def test_frontend_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mel.waveform_to_examples(_wave(1.2, 16000), 16000)
