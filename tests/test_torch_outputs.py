"""What synthesis leaves behind in the port against avtex: the checkpoint
lookups and the places that would load a found file, the files of
``synthesize(out_dir=...)`` and what a logger receives.

- ``avtex_torch.checkpoints.find_*_checkpoint`` find the same file as
  avtex's ``avtex/utils/convert.py`` lookups; where avtex loads a
  pretrained encoder the port loads it too (an unreadable file raises,
  naming it); a SuperSloMo file is loaded where avtex loads it; with no
  file it runs as before;
- on a tiny clip, with the same carried-over weights (the same-walk setup
  of tests/test_torch_synth.py), both pipelines write the same file names
  and report the same stats, and a recording logger receives the same
  calls: tags and steps equal, integer scalars and frame strips exact,
  the entropies within rtol 1e-5 (torch and XLA sum the logits in other
  orders).
"""

import os
import re

import numpy as np
import pytest
import torch

from avtex.config import Config as JaxConfig
from avtex.nn import encoders as jax_encoders
from avtex.utils import convert as jax_convert
from avtex_torch import checkpoints
from avtex_torch.config import ClassicConfig, Config
from test_torch_synth import SMALL, _jax_params, _small_jax_slowfast

torch.set_num_threads(1)

LOOKUPS = {
    # name: (env var, port lookup, avtex lookup, extra positional args)
    "encoder": ("AVTEX_ENCODER_CKPT", checkpoints.find_encoder_checkpoint,
                jax_convert.find_encoder_checkpoint, ("slowfast",)),
    "slomo": ("AVTEX_SLOMO_CKPT", checkpoints.find_slomo_checkpoint,
              jax_convert.find_slomo_checkpoint, ()),
    "vggish": ("AVTEX_VGGISH_CKPT", checkpoints.find_vggish_checkpoint,
               jax_convert.find_vggish_checkpoint, ()),
}


@pytest.fixture
def no_checkpoints(monkeypatch, tmp_path):
    """A working directory without pretrained/ and no lookup variables."""
    for env, *_ in LOOKUPS.values():
        monkeypatch.delenv(env, raising=False)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _plant(monkeypatch, where, env, name):
    path = where / name
    path.write_bytes(b"not a real checkpoint")
    monkeypatch.setenv(env, str(path))
    return str(path)


@pytest.mark.parametrize("kind", sorted(LOOKUPS))
def test_lookup_finds_what_avtex_finds(kind, monkeypatch, no_checkpoints):
    env, port, avtex, args = LOOKUPS[kind]
    assert port(*args) is None and avtex(*args) is None
    path = _plant(monkeypatch, no_checkpoints, env, f"{kind}.bin")
    assert port(*args) == avtex(*args) == path
    explicit = no_checkpoints / "explicit.bin"
    explicit.write_bytes(b"")
    assert port(*args, str(explicit)) == avtex(*args, str(explicit))
    monkeypatch.delenv(env)
    conventional = {"encoder": "SLOWFAST_8x8_R50.pkl",
                    "slomo": "SuperSloMo.ckpt",
                    "vggish": "pytorch_vggish.pth"}[kind]
    (no_checkpoints / "pretrained").mkdir()
    (no_checkpoints / "pretrained" / conventional).write_bytes(b"")
    assert port(*args) == avtex(*args) == f"pretrained/{conventional}"


def test_encoder_checkpoint_raises_for_affine_init(monkeypatch,
                                                    no_checkpoints, capsys):
    """Under norm="affine" a found encoder file is loaded into both towers;
    an unreadable one raises, naming the file; given params and
    norm="group" load nothing."""
    from avtex_torch.synth.pipeline import (build_model,
                                            init_params_for_synthesis)
    cfg = Config(enc_arch="slowfast", norm="affine", compute_dtype="float32")
    model = build_model(cfg, None, "cpu", **SMALL)  # no file: random init
    params = init_params_for_synthesis(cfg, model)
    path = _plant(monkeypatch, no_checkpoints, "AVTEX_ENCODER_CKPT",
                  "sf.pkl")
    for call in (lambda: init_params_for_synthesis(cfg, model),
                 lambda: build_model(cfg, None, "cpu", **SMALL)):
        with pytest.raises(RuntimeError, match="cannot read") as e:
            call()
        assert path in str(e.value)
    build_model(cfg, params, "cpu", **SMALL)  # given params load nothing
    init_params_for_synthesis(Config(enc_arch="slowfast", norm="group"),
                              model)  # avtex loads only for affine

    # a real file at SlowFast-R50's depth (width 8): both towers get it
    full = dict(width=8)
    state = checkpoints.slowfast_reference_state(width=8, seed=3)
    torch.save({"model_state": {k: torch.from_numpy(np.asarray(v))
                                for k, v in state.items()}}, path)
    model = build_model(cfg, None, "cpu", **full)
    loaded = model.state_dict()
    enc = model.q_embedder.video_encoder
    want = checkpoints.convert_slowfast(state, enc.state_dict())
    assert "into both towers" in capsys.readouterr().out
    for tower in ("q_embedder", "t_embedder"):
        for k, v in want.items():
            assert torch.equal(loaded[f"{tower}.video_encoder.{k}"],
                               v.to(loaded[f"{tower}.video_encoder.{k}"]
                                    .dtype)), (tower, k)
    # at another depth avtex's default name map does not fit: a loud
    # warning, and the random weights stay
    small = init_params_for_synthesis(cfg, build_model(cfg, params, "cpu",
                                                       **SMALL))
    assert "failed" in capsys.readouterr().err
    assert all(torch.equal(small[k], params[k]) for k in params)


@pytest.fixture(scope="module")
def small_server():
    from avtex_torch.synth import TextureServer
    t, h, w = 48, 32, 32
    yy, xx = np.mgrid[0:h, 0:w]
    frames = np.clip(127 + 60 * np.stack(
        [np.sin(xx / 3 + i / 2) + np.cos(yy / 5 - i / 7) for i in range(t)]
    )[..., None].repeat(3, -1), 0, 255).astype(np.uint8)
    cfg = Config(enc_arch="slowfast", norm="affine", img_size=32,
                 mini_batchsize=8, compute_dtype="float32")
    return TextureServer.from_frames(cfg, frames, 8.0, device="cpu",
                                     **SMALL)


@pytest.fixture(scope="module")
def slomo_file(tmp_path_factory):
    """A SuperSloMo.ckpt in the reference's layout from seeded weights,
    and the interp_fn of those weights as the loader makes them (bf16)."""
    from avtex_torch.synth.interp import init_slomo, make_interp_fn
    model = init_slomo(seed=2, dtype=torch.float32, device="cpu")
    path = str(tmp_path_factory.mktemp("slomo") / "SuperSloMo.ckpt")
    checkpoints.save_slomo_checkpoint(model, path)
    return path, make_interp_fn(model.to(torch.bfloat16))


def test_slomo_checkpoint_raises_where_the_server_interpolates(
        monkeypatch, no_checkpoints, small_server, slomo_file):
    """A found SuperSloMo file is loaded where the server interpolates, as
    avtex does: an unreadable one raises, a real one makes the frames at
    jumps (once per server), and without interpolation nothing loads."""
    import pickle
    before = small_server.synthesize(seconds=2, seed=1)
    assert before["frames_intp"] is not None
    assert before["jump_count"] > 0
    _plant(monkeypatch, no_checkpoints, "AVTEX_SLOMO_CKPT",
           "SuperSloMo.ckpt")
    try:
        with pytest.raises(pickle.UnpicklingError):
            small_server.synthesize(seconds=2, seed=1)
        # no interpolation, no stitching: nothing avtex would load
        plain = small_server.synthesize(seconds=2, seed=1,
                                        interpolate=False)
        np.testing.assert_array_equal(plain["frames"], before["frames"])
        small_server.synthesize(seconds=2, seed=1, stitch=False)

        path, interp = slomo_file
        monkeypatch.setenv("AVTEX_SLOMO_CKPT", path)
        out = small_server.synthesize(seconds=2, seed=1)
        assert "interp_load_s" in out["timings"]
        np.testing.assert_array_equal(out["result"].indices,
                                      before["result"].indices)
        np.testing.assert_array_equal(out["frames"], before["frames"])
        assert out["frames_intp"].shape == before["frames_intp"].shape
        assert not np.array_equal(out["frames_intp"], before["frames_intp"])
        from avtex_torch.synth import stitch_texture
        want = stitch_texture(
            small_server.video_full, out["result"].indices, small_server.W,
            small_server.S, sf=small_server.cfg.SF, interp_fn=interp)
        np.testing.assert_array_equal(out["frames_intp"],
                                      want["frames_intp"])
        again = small_server.synthesize(seconds=2, seed=1)
        assert "interp_load_s" not in again["timings"]  # loaded once
    finally:
        small_server._interp_fn = None


def test_slomo_checkpoint_raises_for_the_classic_interp_track(
        monkeypatch, no_checkpoints, slomo_file):
    """Classic mode 1 loads a found SuperSloMo file once per run for its
    interpolated track: an unreadable one raises, a real one is used; a
    given interp_fn, or a mode without that track, loads nothing."""
    import dataclasses
    import pickle
    from avtex_torch.classic import run_classic_frames
    from avtex_torch.synth.stitcher import crossfade
    frames = (np.random.default_rng(0).random((24, 32, 32, 3)) * 255
              ).astype(np.uint8)
    cfg = ClassicConfig(model_type=1, sigmas=(4.5,), filter_size=4,
                        new_video_length=1)
    before = run_classic_frames(cfg, frames, 10.0, device="cpu")
    _plant(monkeypatch, no_checkpoints, "AVTEX_SLOMO_CKPT",
           "SuperSloMo.ckpt")
    with pytest.raises(pickle.UnpicklingError):
        run_classic_frames(cfg, frames, 10.0, device="cpu")
    again = run_classic_frames(cfg, frames, 10.0, interp_fn=crossfade,
                               device="cpu")
    (b,), (a,) = (before["sigma_results"].values(),
                  again["sigma_results"].values())
    np.testing.assert_array_equal(a["frames_intp"], b["frames_intp"])
    run_classic_frames(dataclasses.replace(cfg, model_type=3, stride=2),
                       frames, 10.0, device="cpu")

    path, interp = slomo_file
    monkeypatch.setenv("AVTEX_SLOMO_CKPT", path)
    [s] = run_classic_frames(cfg, frames, 10.0,
                             device="cpu")["sigma_results"].values()
    [w] = run_classic_frames(cfg, frames, 10.0, interp_fn=interp,
                             device="cpu")["sigma_results"].values()
    assert b["jump_count"] > 0
    np.testing.assert_array_equal(s["walk"], b["walk"])
    np.testing.assert_array_equal(s["frames_intp"], w["frames_intp"])
    assert not np.array_equal(s["frames_intp"], b["frames_intp"])


# --------------------------------------------------------------------- #
# out_dir files and the logger, against avtex on the same walk
# --------------------------------------------------------------------- #

class Recorder:
    """Every logger call, as (kind, tag, step, value)."""

    def __init__(self):
        self.calls = []

    def log_scalar(self, value, tag, step):
        self.calls.append(("scalar", tag, step, value))

    def log_video(self, frames, tag, step):
        self.calls.append(("video", tag, step, np.array(frames)))

    def log_figure(self, fig, tag, step):
        self.calls.append(("figure", tag, step, None))


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    """avtex's and the port's pipeline on one tiny clip with the same
    weights, out_dir, ``-ve`` and a recording logger each."""
    from avtex.contrastive.model import ContrastiveTextures as JaxCT
    from avtex.media import read_video, write_video
    from avtex.synth.pipeline import synthesize as jax_synthesize
    from avtex_torch.convert import convert_params
    from avtex_torch.synth import synthesize
    from avtex_torch.synth.pipeline import build_model

    d = tmp_path_factory.mktemp("outputs")
    t, h, w = 64, 32, 32
    yy, xx = np.mgrid[0:h, 0:w]
    vid = np.clip(127 + 60 * np.stack(
        [np.sin(xx / 3 + i / 2) + np.cos(yy / 5 - i / 7) for i in range(t)]
    )[..., None].repeat(3, -1) + (np.arange(t) % 9)[:, None, None, None],
        0, 255).astype(np.uint8)
    path = str(d / "clip.mp4")
    write_video(vid, path, fps=8.0)
    frames, fps = read_video(path)

    mp = pytest.MonkeyPatch()
    mp.setitem(jax_encoders.ENCODER_REGISTRY, "slowfast",
               (_small_jax_slowfast, "slowfast"))
    for env, *_ in LOOKUPS.values():
        mp.delenv(env, raising=False)
    try:
        common = dict(enc_arch="slowfast", norm="affine", img_size=32,
                      mini_batchsize=8, new_video_length=4, seed=0,
                      threshold=0.05, visualize_evaluate=True)
        jcfg = JaxConfig(**common)
        cfg = Config(**common, compute_dtype="float32")
        W = jcfg.derive_geometry(fps).window
        jparams = _jax_params(JaxCT(arch="slowfast", norm="affine"), frames,
                              W)
        params = convert_params(jparams, build_model(cfg, None, "cpu",
                                                     **SMALL))
        jlog, plog = Recorder(), Recorder()
        want = jax_synthesize(jcfg, path, jparams, out_dir=str(d / "avtex"),
                              logger=jlog)
        got = synthesize(cfg, path, params, out_dir=str(d / "port"),
                         logger=plog, device="cpu", **SMALL)
    finally:
        mp.undo()
    return d, want, got, jlog.calls, plog.calls


def test_out_dir_writes_avtex_files(both_runs):
    d, want, got, _, _ = both_runs
    np.testing.assert_array_equal(got["result"].indices,
                                  want["result"].indices)
    assert sorted(os.listdir(d / "port")) == sorted(os.listdir(d / "avtex"))
    names = sorted(os.listdir(d / "port"))
    assert sum(n.endswith(("_entropy.png", "_nonzero.png", "_report.html"))
               for n in names) == 3
    assert ({k: os.path.basename(v) for k, v in got["paths"].items()}
            == {k: os.path.basename(v) for k, v in want["paths"].items()})
    assert all(os.path.getsize(p) > 0 for p in got["paths"].values())


def _report(path):
    with open(path) as f:
        doc = f.read()
    return (dict(re.findall(r"<tr><td>([^<]*)</td><td>([^<]*)</td></tr>",
                            doc)),
            re.findall(r"<h3>([^<]*)</h3><video controls width='480' "
                       r"src='([^']*)'>", doc))


def test_report_has_avtex_stats_and_links(both_runs):
    _, want, got, _, _ = both_runs
    stats, links = _report(got["paths"]["report"])
    assert (stats, links) == _report(want["paths"]["report"])
    assert list(stats) == ["jumps", "steps", "segments", "seed_segment"]
    assert int(stats["steps"]) == len(got["result"].indices)
    assert int(stats["segments"]) == got["num_segments"]
    assert int(stats["jumps"]) == got["stitched"]["jump_count"] > 0
    assert [k for k, _ in links] == ["texture", "texture_interp"]


def test_logger_gets_avtex_scalars(both_runs):
    _, _, got, jcalls, pcalls = both_runs
    js = [c for c in jcalls if c[0] == "scalar"]
    ps = [c for c in pcalls if c[0] == "scalar"]
    assert [c[1:3] for c in ps] == [c[1:3] for c in js]
    steps = len(got["result"].indices)
    assert len(ps) == 2 * steps + 1 and ps[-1][1] == "synth/jump_count"
    for (_, tag, _, p), (_, _, _, j) in zip(ps, js):
        if tag == "synth/entropy":
            np.testing.assert_allclose(p, j, rtol=1e-5)
        else:
            assert isinstance(p, int) and p == j


def test_logger_gets_avtex_strips_and_figures(both_runs):
    _, _, got, jcalls, pcalls = both_runs
    jv = [c for c in jcalls if c[0] != "scalar"]
    pv = [c for c in pcalls if c[0] != "scalar"]
    assert [c[:3] for c in pv] == [c[:3] for c in jv]
    strips = [c for c in pv if c[0] == "video"]
    assert strips and len(strips) == 2 * int(
        got["result"].jumps[1:].sum())
    for p, j in zip(pv, jv):
        if p[0] == "video":
            np.testing.assert_array_equal(p[3], j[3])
    figures = [c for c in pv if c[0] == "figure"]
    assert len(figures) == len(got["result"].indices)


def test_log_synthesis_without_ve_logs_scalars_only(small_server,
                                                    no_checkpoints):
    """Without -ve only the per-step scalars and the jump count."""
    from avtex_torch.synth.pipeline import _log_synthesis
    out = small_server.synthesize(seconds=2, seed=3)
    rec = Recorder()
    _log_synthesis(rec, small_server, out["result"], out["jump_count"])
    assert [c[1] for c in rec.calls].count("synth/entropy") == len(
        out["result"].indices)
