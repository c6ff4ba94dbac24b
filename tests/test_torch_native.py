"""The port's C++ host runtime (avtex_torch/native/) against its numpy
plain versions and avtex's own native library, and the helpers ported
with it (avtex_torch/utils/{batching,flow}.py) against avtex's.

- the native ``stitch_frames`` (bar on and off), ``crossfade`` (every
  pair of byte values, several ``n_mid``) and ``write_avi`` give
  byte-identical output to the numpy / pure-Python versions and to
  avtex's library;
- the AVI writers round samples per frame differently where
  ``sample_rate / fps`` ends in .5 (Python's ``round`` to even, the C++
  ``+ 0.5``), in avtex as in the port: pinned below;
- the stitcher, the classic driver and the baselines CLI run the native
  path; a missing ``g++`` or a failed build raises; processes building at
  once all load one library.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from avtex.native import muxer as j_muxer
from avtex.native import stitch as j_stitch
from avtex_torch.media import avimux
from avtex_torch.native import muxer, stitch
from avtex_torch.ops import _build
from avtex_torch.synth import stitcher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _video(t=12, h=40, w=36, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (t, h, w, 3),
                                                dtype=np.uint8)


def test_avtex_library_is_loaded():
    """The comparisons below hold the port against avtex's C++, not its
    numpy fallback."""
    import avtex.native
    assert avtex.native.available() and j_muxer.available()


@pytest.mark.parametrize("bar", [False, True])
@pytest.mark.parametrize("total", [None, 40])
def test_stitch_frames_byte_identical(bar, total):
    vid = _video()
    ids = np.array([3, 1, 11, 11, 0, 7, 2], np.int64)
    got = stitch.stitch_frames(vid, ids, bar, total)
    assert got.dtype == np.uint8 and got.shape == (7, 40, 36, 3)
    np.testing.assert_array_equal(got, stitcher.stitch_frames(
        vid, ids, bar, total))
    np.testing.assert_array_equal(got, j_stitch.stitch_frames(
        vid, ids, bar, total))


def test_stitch_frames_refuses_ids_outside_the_video():
    with pytest.raises(IndexError):
        stitch.stitch_frames(_video(t=4), np.array([0, 4]))


@pytest.mark.parametrize("n_mid", [1, 2, 3, 4, 7])
def test_crossfade_byte_identical_on_every_value_pair(n_mid):
    a, b = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    f0 = a.astype(np.uint8).reshape(256, 256, 1).repeat(3, -1)
    f1 = b.astype(np.uint8).reshape(256, 256, 1).repeat(3, -1)
    got = stitch.crossfade(f0, f1, n_mid)
    assert got.shape == (n_mid, 256, 256, 3)
    np.testing.assert_array_equal(got, stitcher.crossfade(f0, f1, n_mid))
    np.testing.assert_array_equal(got, j_stitch.crossfade(f0, f1, n_mid))


def _jpegs(n, seed=0):
    """Byte strings standing in for JPEGs (the muxer frames any bytes),
    odd and even lengths."""
    g = np.random.default_rng(seed)
    return [g.bytes(int(k)) for k in g.integers(200, 900, n)]


def _pcm(n, channels, seed=1):
    g = np.random.default_rng(seed)
    shape = (n,) if channels == 1 else (n, channels)
    return (g.standard_normal(shape) * 3000).astype(np.int16)


@pytest.mark.parametrize("fps, sr, channels", [
    (30.0, 22050, 1), (12.0, 8000, 2), (25.0, 44100, 1), (30.0, 0, 0)])
def test_write_avi_byte_identical(fps, sr, channels, tmp_path):
    jpegs = _jpegs(17)
    pcm = _pcm(int(sr * 17 / fps) + 123, channels) if channels else None
    paths = {}
    for name, write in (("native", muxer.write_avi),
                        ("python", avimux.mux_avi),
                        ("avtex", j_muxer.write_avi)):
        paths[name] = write(str(tmp_path / f"{name}.avi"), jpegs, 64, 48,
                            fps, pcm, sr)
    data = {k: open(p, "rb").read() for k, p in paths.items()}
    assert data["native"][:4] == b"RIFF" and data["native"][8:12] == b"AVI "
    assert data["native"] == data["python"] == data["avtex"]


def test_avi_half_sample_rounding_pinned(tmp_path):
    """22050 / 20 = 1102.5 samples a frame: Python's ``round`` gives 1102
    (to even), the C++ ``+ 0.5`` 1103. avtex's two writers part the same
    way, so the port's native file equals avtex's native one and the
    port's Python file avtex's Python one."""
    from avtex.media import avimux as j_avimux
    import cv2
    frames = _video(t=6, h=16, w=16)
    audio = (np.sin(np.arange(22050 // 2) / 7) * 0.3).astype(np.float32)
    got_nat = avimux.write_avi(str(tmp_path / "n.avi"), frames, 20.0,
                               audio, 22050)
    got_py = avimux.write_avi_python(str(tmp_path / "p.avi"), frames, 20.0,
                                     audio, 22050)
    want_nat = j_avimux.write_avi(str(tmp_path / "jn.avi"), frames, 20.0,
                                  audio, 22050)
    want_py = j_avimux.write_avi_python(str(tmp_path / "jp.avi"), frames,
                                        20.0, audio, 22050)
    data = [open(p, "rb").read() for p in (got_nat, want_nat, got_py,
                                           want_py)]
    assert data[0] == data[1] and data[2] == data[3]
    assert data[0] != data[2]
    assert cv2.VideoCapture(got_nat).isOpened()


def test_write_avi_encodes_then_muxes_natively(tmp_path, monkeypatch):
    """``write_avi`` (JPEG-encode, then the C++ muxer) equals the Python
    writer and avtex's, and calls the native muxer."""
    from avtex.media import avimux as j_avimux
    frames = _video(t=9, h=24, w=32)
    audio = (np.sin(np.arange(8000) / 5) * 0.3).astype(np.float32)
    calls = []
    orig = muxer.write_avi
    monkeypatch.setattr(muxer, "write_avi",
                        lambda *a: calls.append(1) or orig(*a))
    got = avimux.write_avi(str(tmp_path / "a.avi"), frames, 12.0, audio,
                           8000)
    assert calls == [1]
    py = avimux.write_avi_python(str(tmp_path / "b.avi"), frames, 12.0,
                                 audio, 8000)
    want = j_avimux.write_avi(str(tmp_path / "c.avi"), frames, 12.0, audio,
                              8000)
    data = [open(p, "rb").read() for p in (got, py, want)]
    assert data[0] == data[1] == data[2]


def test_synthesis_paths_run_the_native_runtime(monkeypatch):
    """The stitcher gathers and crossfades natively (its numpy versions are
    the plain ones); the classic driver and the baselines CLI take the
    native functions, as avtex's do."""
    import inspect
    from avtex.synth import stitcher as j_stitcher
    from avtex_torch.classic import driver
    from avtex_torch.cli import baselines_main
    assert driver.crossfade is stitch.crossfade
    assert "from avtex_torch.native.stitch import stitch_frames" in \
        inspect.getsource(baselines_main.main)
    seen = []
    for name in ("stitch_frames", "crossfade"):
        orig = getattr(stitch, name)
        monkeypatch.setattr(stitch, name, lambda *a, _o=orig, _n=name, **k:
                            seen.append(_n) or _o(*a, **k))
    vid = _video(t=40, h=30, w=30)
    kw = dict(sf=5, frames_bar=True, fps=10.0)
    got = stitcher.stitch_texture(vid, [0, 1, 5, 6, 2, 3], 6, 3, **kw)
    assert "stitch_frames" in seen and "crossfade" in seen
    want = j_stitcher.stitch_texture(vid, [0, 1, 5, 6, 2, 3], 6, 3, **kw)
    for key in ("frames", "frames_intp", "frame_ids"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# --------------------------------------------------------------------- #
# The build
# --------------------------------------------------------------------- #

@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """An empty build directory and no library loaded yet."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(_build, "_loaded", {})
    return tmp_path


def test_build_without_gxx_on_path_raises(fresh_build, monkeypatch):
    monkeypatch.setenv("PATH", str(fresh_build))  # no g++ there
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        stitch.crossfade(_video(t=1)[0], _video(t=1)[0], 2)
    assert not os.path.exists(_build.BUILD_DIR) or not os.listdir(
        _build.BUILD_DIR)


def test_failed_build_raises(fresh_build, monkeypatch):
    src = fresh_build / "src"
    src.mkdir()
    for name in _build.NATIVE_SOURCES:
        (src / name).write_text("this is not C++\n")
    monkeypatch.setattr(_build, "NATIVE_DIR", str(src))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _build.load_native()
    assert not [f for f in os.listdir(_build.BUILD_DIR)
                if f.endswith(".so")]


def test_concurrent_builds_share_one_library(fresh_build):
    """Processes building into one empty directory at once (as xdist
    workers do) each load a whole library; one file remains."""
    code = ("import sys; from avtex_torch.ops import _build; "
            "_build.BUILD_DIR = sys.argv[1]; "
            "from avtex_torch.native import stitch; import numpy as np; "
            "f = np.full((4, 4, 3), 9, np.uint8); "
            "assert (stitch.crossfade(f, f, 3) == 9).all()")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               _build.BUILD_DIR], cwd=REPO, env=env)
             for _ in range(4)]
    assert [p.wait(timeout=120) for p in procs] == [0] * 4
    libs = os.listdir(_build.BUILD_DIR)
    assert libs == [os.path.basename(_build.native_lib_path())]


def test_library_name_follows_sources_and_flags(monkeypatch):
    path = _build.native_lib_path()
    assert os.path.basename(path).startswith("libavtex_torch_native-")
    monkeypatch.setattr(_build, "GXX_FLAGS", _build.GXX_FLAGS + ("-g",))
    assert _build.native_lib_path() != path


# --------------------------------------------------------------------- #
# The helpers ported with the runtime
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("n, m", [(10, 4), (12, 4), (1, 3)])
def test_batches_split_and_combine_like_avtex(n, m):
    from avtex.utils import batching as j_batching
    from avtex_torch.utils import combine_batches, split_into_batches
    x = np.arange(n * 6, dtype=np.float32).reshape(1, n, 2, 3)
    got, got_n = split_into_batches(x, m)
    want, want_n = j_batching.split_into_batches(x, m)
    assert got_n == want_n == n and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(combine_batches(got, n),
                                  j_batching.combine_batches(want, n))
    np.testing.assert_array_equal(combine_batches(got, n), x)


@pytest.mark.parametrize("n, m, window, stride", [
    (100, 5, 15, 6), (64, 3, 8, 4), (40, 10, 5, 2)])
def test_overlapping_segments_like_avtex(n, m, window, stride):
    from avtex.utils import batching as j_batching
    from avtex_torch.utils import split_into_overlapping_segments
    x = np.random.default_rng(0).integers(0, 255, (n, 4, 4, 3),
                                          dtype=np.uint8)
    got, got_n = split_into_overlapping_segments(x, m, window, stride)
    want, want_n = j_batching.split_into_overlapping_segments(
        x, m, window, stride)
    assert got_n == want_n
    np.testing.assert_array_equal(got, want)


def test_flow_features_like_avtex():
    from avtex.utils import flow as j_flow
    from avtex_torch.utils import flow
    t, h, w = 6, 32, 40
    yy, xx = np.mgrid[0:h, 0:w]
    vid = np.clip(127 + 60 * np.stack(
        [np.sin((xx - 2 * i) / 4) + np.cos((yy + i) / 5) for i in range(t)]
    )[..., None].repeat(3, -1), 0, 255).astype(np.uint8)
    got = flow.farneback_flow(vid)
    assert got.shape == (t - 1, h, w, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got, j_flow.farneback_flow(vid))
    feats = flow.flow_magnitude_features(vid)
    assert feats.shape == (t,) and float(feats.max()) > 0
    np.testing.assert_array_equal(feats, j_flow.flow_magnitude_features(vid))
