"""The audio baselines in the port (avtex_torch/baselines/,
avtex_torch/cli/baselines_main.py) against avtex's.

- ``audio_nearest_neighbour``: the same matched segments and frame ids
  (the cosines are fp32 on both sides; the inputs keep the best match
  clear of rounding), including the strict ``> 0`` fallback and the
  driving sequence's wrap-around;
- the random walks and ``shift_audio``: bit-exact for the same seed;
- the CLI in all four modes on a clip written with OpenCV: the same
  files with the same bytes.
"""

import os

import numpy as np
import pytest
import torch

from avtex import baselines as jb
from avtex.cli.baselines_main import main as jax_main
from avtex.media import write_video, write_wav
from avtex_torch import baselines as tb
from avtex_torch.baselines.audio_nn import cosine_matches
from avtex_torch.cli.baselines_main import build_parser
from avtex_torch.cli.baselines_main import main as port_main

torch.set_num_threads(1)


@pytest.mark.parametrize("n_drv,max_length", [(2, 8), (2, 7), (5, 40),
                                              (3, 100)])
def test_audio_nn_matches_avtex(n_drv, max_length):
    g = np.random.default_rng(n_drv)
    src = g.standard_normal((10, 100, 64)).astype(np.float32)
    pick = g.integers(0, 10, n_drv)
    driving = src[pick] + 0.3 * g.standard_normal(
        (n_drv, 100, 64)).astype(np.float32)
    got = tb.audio_nearest_neighbour(torch.from_numpy(driving),
                                     torch.from_numpy(src), window=6,
                                     stride=2, max_length=max_length)
    want = jb.audio_nearest_neighbour(driving, src, window=6, stride=2,
                                      max_length=max_length)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1][:n_drv], pick[:len(got[1])])


def test_audio_nn_falls_back_to_segment_zero():
    src = np.eye(4, dtype=np.float32).reshape(4, 2, 2)
    driving = np.stack([-np.ones((2, 2), np.float32),
                        src[2]])  # no positive cosine; then segment 2
    got = cosine_matches(torch.from_numpy(driving), torch.from_numpy(src))
    assert got.tolist() == [0, 2]
    for fn in (tb.audio_nearest_neighbour, jb.audio_nearest_neighbour):
        _, segs = fn(driving, src, window=6, stride=2, max_length=12)
        assert segs.tolist()[:2] == [0, 2]


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("num_segments,window,stride,max_length", [
    (5, 6, 2, 40), (297, 15, 6, 900), (1, 4, 2, 9)])
def test_random_walks_bit_exact(seed, num_segments, window, stride,
                                max_length):
    args = (num_segments, window, stride, max_length, seed)
    np.testing.assert_array_equal(tb.random_sequential_walk(*args),
                                  jb.random_sequential_walk(*args))
    for a, b in zip(tb.random_segment_walk(*args),
                    jb.random_segment_walk(*args)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shift", [None, 2.0, 0.25])
@pytest.mark.parametrize("seed", [0, 3])
def test_shift_audio_bit_exact(shift, seed):
    audio = np.random.default_rng(seed).standard_normal((16000 * 13, 2))
    got = tb.shift_audio(audio, 16000, shift, seed=seed)
    want = jb.shift_audio(audio, 16000, shift, seed=seed)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


# --------------------------------------------------------------------- #
# The CLI, avtex's and the port's on the same files
# --------------------------------------------------------------------- #

SR = 16000


def _tones(seconds, seed):
    """A tone whose frequency changes every 0.25 s: examples at other
    times differ, so each driving example has one clear best match."""
    g = np.random.default_rng(seed)
    freqs = np.repeat(g.uniform(200, 3000, int(seconds * 4)), SR // 4)
    t = np.arange(len(freqs)) / SR
    return 0.3 * np.sin(2 * np.pi * np.cumsum(freqs) / SR + t)


@pytest.fixture(scope="module")
def media_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("baselines")
    vdir, adir, dadir = root / "v", root / "a", root / "da"
    for d in (vdir, adir, dadir):
        d.mkdir()
    rng = np.random.default_rng(0)
    frames = (rng.random((150, 32, 32, 3)) * 255).astype(np.uint8)
    write_video(frames, str(vdir / "clip.mp4"), fps=30)
    src = _tones(5, 1)
    write_wav(str(adir / "clip.wav"), src, SR)
    # the driving clip is the source 0.5 s later (then wraps): its
    # example k is the source's example k + 5
    write_wav(str(dadir / "song.wav"), np.roll(src, -SR // 2), SR)
    write_wav(str(vdir / "clip.wav"), _tones(5, 2), SR)
    return vdir, adir, dadir


def _both(tmp_path, argv):
    jax_main(argv + ["-results_folder", str(tmp_path / "avtex")])
    port_main(argv + ["-results_folder", str(tmp_path / "port"),
                      "-device", "cpu"])
    names = {k: sorted(os.listdir(tmp_path / k)) for k in ("avtex", "port")}
    assert names["port"] == names["avtex"] and names["port"]
    for n in names["port"]:
        with open(tmp_path / "port" / n, "rb") as f, \
                open(tmp_path / "avtex" / n, "rb") as g:
            assert f.read() == g.read(), n
    return names["port"]


@pytest.mark.parametrize("mode", ["random", "random_segment"])
def test_cli_random_modes_match_avtex(media_dirs, tmp_path, mode):
    vdir, adir, _ = media_dirs
    names = _both(tmp_path, [mode, "-vdata", str(vdir), "-vl", "clip",
                             "-adata", str(adir), "-nvl", "2", "-seed", "3"])
    assert any(n.startswith(f"clip_{mode}") for n in names)


def test_cli_random_target_overlay_matches_avtex(media_dirs, tmp_path):
    vdir, _, dadir = media_dirs
    names = _both(tmp_path, ["random", "-vdata", str(vdir), "-vl", "clip",
                             "-adata", str(dadir), "-tl", "song", "-nvl",
                             "2"])
    assert any("clip_song_random" in n for n in names)


def test_cli_nn_matches_avtex(media_dirs, tmp_path, capsys):
    vdir, adir, dadir = media_dirs
    names = _both(tmp_path, ["nn", "-vdata", str(vdir), "-vl", "clip",
                             "-adata", str(adir), "-da", "song", "-dadata",
                             str(dadir), "-nvl", "2"])
    assert any("clip_song_nn" in n for n in names)


def test_cli_shift_matches_avtex(media_dirs, tmp_path):
    vdir, _, _ = media_dirs
    names = _both(tmp_path, ["shift", "-i", str(vdir / "clip.mp4"),
                             "-seed", "5"])
    assert any("clip_shift" in n for n in names)


def test_cli_refusals_and_flags(media_dirs, tmp_path):
    from avtex.cli.baselines_main import build_parser as jax_parser
    vdir, _, dadir = media_dirs
    with pytest.raises(SystemExit):
        port_main(["nn", "-vdata", str(vdir), "-vl", "clip", "-da", "song",
                   "-dadata", str(dadir), "-device", "cpu",
                   "-results_folder", str(tmp_path / "res")])
    with pytest.raises(SystemExit):
        port_main(["shift", "-results_folder", str(tmp_path / "res")])
    got = vars(build_parser().parse_args(["nn"]))
    assert got.pop("device") is None
    assert got == vars(jax_parser().parse_args(["nn"]))
