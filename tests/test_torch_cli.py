"""The port's contrastive CLI (avtex_torch/cli/main.py) against avtex's
(avtex/cli/main.py), and the config helpers it uses.

One tiny synthetic clip (2 s, 64x64, 30 fps), ``-ea resnet10 -size 32
-nvl 2``. With a checkpoint that avtex writes at the flag-derived path,
the two give identical transition indices and the same output file
names. Both models run in fp32 for that comparison (the port's
``Config.compute_dtype``, avtex's model dtype): the default walk (``-th
0``) takes each row's maximum, and at these random weights two entries
of one row lie 5e-5 apart, which bf16 rounding, done differently by the
two frameworks, decides either way; in fp32 the tables agree to 1e-6.
The same holds for ``-m 2 -e -da <wav> -daf VGG|Mel`` from an
avtex-written ``-m 2`` checkpoint, with the clip's wav in ``-adata``, a
driving wav in ``-dadata`` and the scorer's VGGish in fp32 from a
``pytorch_vggish.pth`` that the test writes.
Also: training without ``-e`` (``-bs 2 -negs 2 -epochs 1``), whose
``_best`` file ``-e`` then finds, the random-init opt-out, the
missing-checkpoint error, ``--mesh`` (synthesis and training write the
same files as without it), the pairing of
``-da`` entries with videos and the results-folder rule. ``-e -da song
-daf Contrastive`` with and without ``-m 2`` and ``-daf_resume`` (a file
avtex's ``save_checkpoint`` wrote): from the file the same indices, and
in every case the same seed, length and file names."""

import dataclasses
import os

import cv2
import numpy as np
import pytest
import torch

from avtex import config as jax_config
from avtex.cli import main as jax_cli
from avtex.synth import pipeline as jax_pipeline
from avtex_torch import config
from avtex_torch.cli import main as cli

torch.set_num_threads(1)

FLAGS = ["-m", "1", "-e", "-ea", "resnet10", "-size", "32", "-nvl", "2",
         "-vl", "clip"]


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("videos")
    t, h, w = 60, 64, 64
    yy, xx = np.mgrid[0:h, 0:w]
    writer = cv2.VideoWriter(str(d / "clip.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
    for i in range(t):
        f = np.clip(127 + 60 * (np.sin(xx / 5 + i / 3)
                                + np.cos(yy / 7 - i / 5)), 0, 255)
        f = f.astype(np.uint8)
        writer.write(np.stack([f, np.roll(f, i, 1), 255 - f], -1))
    writer.release()
    return d


def _flags(clip_dir, tmp, *extra):
    return FLAGS + ["-vdata", str(clip_dir), "-ckpt", str(tmp / "ckpt"),
                    "-logdir", str(tmp / "logs")] + list(extra)


@pytest.fixture(scope="module")
def avtex_checkpoint(clip_dir, tmp_path_factory):
    """avtex's random-init params for the CLI's model, saved by avtex's
    save_checkpoint at the path avtex's CLI derives from FLAGS."""
    from avtex.contrastive.model import ContrastiveTextures
    from avtex.media import video_fps
    from avtex.train.checkpoint import save_checkpoint
    tmp = tmp_path_factory.mktemp("run")
    args = jax_cli.build_parser().parse_args(_flags(clip_dir, tmp))
    cfg = jax_cli.args_to_config(args).derive_geometry(
        video_fps(str(clip_dir / "clip.mp4")))
    model = ContrastiveTextures(arch="resnet10", model_type=1, temp=0.1)
    params = jax_pipeline.init_params_for_synthesis(
        cfg, model, np.zeros((60, 64, 64, 3), np.uint8), cfg.window)
    best = cfg.default_ckpt_path("clip")
    name = os.path.basename(best)[:-len("_best")]
    assert save_checkpoint(cfg.ckpt, name, params, 5, "resnet10", 0.3,
                           True) == best
    return tmp


def _fp32(monkeypatch):
    """Both CLIs' models in fp32."""
    import functools

    import jax.numpy as jnp
    monkeypatch.setattr(jax_pipeline, "ContrastiveTextures",
                        functools.partial(jax_pipeline.ContrastiveTextures,
                                          dtype=jnp.float32))
    real = cli.args_to_config
    monkeypatch.setattr(cli, "args_to_config", lambda args: (
        dataclasses.replace(real(args), compute_dtype="float32")))


def _run_avtex(monkeypatch, argv):
    outs = []
    real = jax_pipeline.synthesize

    def recording(*a, **k):
        outs.append(real(*a, **k))
        return outs[-1]
    monkeypatch.setattr(jax_pipeline, "synthesize", recording)
    jax_cli.main(argv)
    return outs


def test_cli_matches_avtex_from_an_avtex_checkpoint(monkeypatch, clip_dir,
                                                    avtex_checkpoint):
    tmp = avtex_checkpoint
    _fp32(monkeypatch)
    want = _run_avtex(monkeypatch, _flags(clip_dir, tmp, "-rf",
                                          str(tmp / "avtex")))
    got = cli.main(_flags(clip_dir, tmp, "-rf", str(tmp / "port"),
                          "-device", "cpu"))
    assert len(want) == len(got) == 1
    np.testing.assert_array_equal(got[0]["result"].indices,
                                  want[0]["result"].indices)
    names = {k: sorted(os.listdir(tmp / k / "results_clip"))
             for k in ("avtex", "port")}
    assert names["port"] == names["avtex"]
    assert any(n.endswith("_interp.mp4") for n in names["port"])
    assert any(n.endswith("_report.html") for n in names["port"])


def test_cli_without_checkpoint(clip_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = _flags(clip_dir, tmp_path, "-device", "cpu", "-nintp")
    with pytest.raises(FileNotFoundError, match="No checkpoint found"):
        cli.main(argv)
    with pytest.raises(FileNotFoundError, match="No checkpoint found"):
        jax_cli.main(_flags(clip_dir, tmp_path, "-nintp"))
    [out] = cli.main(argv + ["-allow_random_init"])
    # no -rf: results_<video> in the working directory
    written = os.listdir(tmp_path / "results_clip")
    assert sorted(os.path.basename(p) for p in out["paths"].values()) == \
        sorted(written)


def _files(folder):
    return {n: (folder / n).read_bytes() for n in sorted(os.listdir(folder))}


def test_cli_mesh_synthesizes_the_same_files(clip_dir, tmp_path,
                                             avtex_checkpoint):
    """``-e --mesh`` on the CPU, a one-process world: the sharded embed
    gives the tables of ``-e``, so the same files, byte for byte; the
    world is gone afterwards."""
    out = {}
    for name, extra in (("plain", []), ("mesh", ["--mesh"])):
        [out[name]] = cli.main(_flags(clip_dir, avtex_checkpoint, "-device",
                                      "cpu", "-rf", str(tmp_path / name),
                                      *extra))
    assert not torch.distributed.is_initialized()
    np.testing.assert_array_equal(out["mesh"]["result"].indices,
                                  out["plain"]["result"].indices)
    files = {k: _files(tmp_path / k / "results_clip") for k in out}
    assert any(n.endswith("_report.html") for n in files["plain"])
    assert files["mesh"] == files["plain"]


def test_cli_mesh_trains_the_same_checkpoint(clip_dir, tmp_path):
    """Training ignores ``--mesh``, as avtex's does: the same files."""
    files = {}
    for name, extra in (("plain", []), ("mesh", ["--mesh"])):
        argv = [a for a in _flags(clip_dir, tmp_path / name) if a != "-e"]
        cli.main(argv + ["-bs", "2", "-negs", "2", "-epochs", "1",
                         "-device", "cpu", *extra])
        files[name] = _files(tmp_path / name / "ckpt")
    assert not torch.distributed.is_initialized()
    assert len(files["plain"]) == 2 and files["mesh"] == files["plain"]


def test_cli_trains_then_synthesizes_from_its_checkpoint(clip_dir, tmp_path,
                                                        capsys):
    """Without -e the CLI trains and writes avtex's _latest and _best under
    the flag-derived name; -e with the same flags finds and loads _best
    without -allow_random_init."""
    train = [a for a in _flags(clip_dir, tmp_path) if a != "-e"] + [
        "-bs", "2", "-negs", "2", "-epochs", "1", "-device", "cpu"]
    [out] = cli.main(train)
    assert len(out["history"]) == 1 and out["state"].step == 3
    names = sorted(os.listdir(tmp_path / "ckpt"))
    assert [n.rsplit("_", 1)[1] for n in names] == ["best", "latest"]
    args = jax_cli.build_parser().parse_args(train[:-2])
    jax_cfg = jax_cli.args_to_config(args).derive_geometry(30.0)
    assert names[0] == os.path.basename(jax_cfg.default_ckpt_path("clip"))
    capsys.readouterr()
    [syn] = cli.main(train + ["-e", "-nintp", "-rf", str(tmp_path / "rf")])
    assert f"restored checkpoint {tmp_path / 'ckpt' / names[0]}" in \
        capsys.readouterr().out
    assert len(syn["result"].indices) > 0


def test_cli_runs_on_the_card_unless_asked(clip_dir, tmp_path, monkeypatch,
                                           avtex_checkpoint):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(_flags(clip_dir, avtex_checkpoint, "-nintp", "-rf",
                        str(tmp_path)))


@pytest.mark.parametrize("rf,want", [
    (None, "results_clip"), ("results", "results/results_clip"),
    ("out", "out/results_clip")])
def test_results_folder_rule(rf, want):
    cfg = config.Config(results_folder=rf)
    assert cli.per_video_config(cfg, "clip").results_folder == want
    if rf != "results":  # avtex drops an explicit "-rf results"
        jcfg = jax_config.Config(results_folder=rf or "results")
        assert jax_cli.per_video_config(jcfg, "clip", 0).results_folder \
            == want


@pytest.mark.parametrize("kw", [
    {}, dict(vdata="data/videos", batch_size=8, n_negs=4, enc_arch="slowfast",
             temp=0.2, threshold=0.3, subsample_rate=2, logname="run",
             ckpt="ck_dir", model_type=2)])
def test_checkpoint_names_match_avtex(kw):
    ours = config.Config(**kw).derive_geometry(24.0)
    theirs = jax_config.Config(**kw).derive_geometry(24.0)
    for video in ("clip", "surf"):
        assert ours.train_logname(video) == theirs.train_logname(video)
        assert ours.default_ckpt_path(video) == \
            theirs.default_ckpt_path(video)
        assert ours.eval_logname(video) == theirs.eval_logname(video)


def test_discover_video_list_matches_avtex(tmp_path):
    for name in ("b.mp4", "a.mp4", "a.wav", ".hidden.mp4", "c.d.mp4"):
        (tmp_path / name).write_bytes(b"")
    (tmp_path / "sub").mkdir()
    assert cli.discover_video_list(str(tmp_path)) == \
        jax_cli.discover_video_list(str(tmp_path)) == ["a", "b", "c"]


def test_parser_has_avtex_flags():
    ours = {a for act in cli.build_parser()._actions
            for a in act.option_strings}
    theirs = {a for act in jax_cli.build_parser()._actions
              for a in act.option_strings}
    assert theirs <= ours and ours - theirs == {"-device"}


# --------------------------------------------------------------------- #
# -m 2 with driving audio
# --------------------------------------------------------------------- #

FLAGS_M2 = ["-m", "2"] + FLAGS[2:]


def _wav(path, seconds, sr, hz, seed):
    from avtex.media import write_wav
    g = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = 0.4 * np.sin(2 * np.pi * hz * t * (1 + 0.3 * np.sin(t * 3))) \
        + 0.05 * g.standard_normal(len(t))
    return write_wav(str(path), x.astype(np.float32), sr)


@pytest.fixture(scope="module")
def m2_run(clip_dir, tmp_path_factory):
    """Wavs, a pytorch_vggish.pth and avtex's -m 2 checkpoint at the path
    avtex's CLI derives from the flags."""
    from avtex.contrastive.model import ContrastiveTextures
    from avtex.media import video_fps
    from avtex.train.checkpoint import save_checkpoint
    from avtex_torch.checkpoints import vggish_reference_state
    from avtex_torch.nn.vggish import VGGish
    tmp = tmp_path_factory.mktemp("m2")
    (tmp / "audio").mkdir()
    (tmp / "target").mkdir()
    _wav(tmp / "audio" / "clip.wav", 2.0, 22050, 440, 0)
    _wav(tmp / "target" / "song.wav", 1.6, 44100, 660, 1)
    vg = VGGish(torch.float32)
    torch.save(vggish_reference_state(vg), tmp / "pytorch_vggish.pth")
    argv = _m2_flags(clip_dir, tmp)
    args = jax_cli.build_parser().parse_args(argv)
    cfg = jax_cli.args_to_config(args).derive_geometry(
        video_fps(str(clip_dir / "clip.mp4")))
    model = ContrastiveTextures(arch="resnet10", model_type=2, temp=0.1)
    params = jax_pipeline.init_params_for_synthesis(
        cfg, model, np.zeros((60, 64, 64, 3), np.uint8), cfg.window)
    best = cfg.default_ckpt_path("clip")
    name = os.path.basename(best)[:-len("_best")]
    assert save_checkpoint(cfg.ckpt, name, params, 5, "resnet10", 0.3,
                           True) == best
    return tmp


def _m2_flags(clip_dir, tmp, *extra):
    return (FLAGS_M2 + ["-vdata", str(clip_dir), "-adata",
                        str(tmp / "audio"), "-dadata", str(tmp / "target"),
                        "-ckpt", str(tmp / "ckpt"), "-logdir",
                        str(tmp / "logs")] + list(extra))


@pytest.mark.parametrize("daf", ["VGG", "Mel"])
def test_cli_m2_driving_audio_matches_avtex(monkeypatch, clip_dir, m2_run,
                                            daf):
    import functools

    import jax.numpy as jnp

    import avtex.nn.vggish as jax_vggish
    from avtex_torch.nn.vggish import VGGish
    from avtex_torch.synth import pipeline
    tmp = m2_run
    _fp32(monkeypatch)
    monkeypatch.setattr(jax_vggish, "VGGish", functools.partial(
        jax_vggish.VGGish, dtype=jnp.float32))
    monkeypatch.setattr(pipeline, "VGGish", functools.partial(
        VGGish, dtype=torch.float32))
    monkeypatch.setenv("AVTEX_VGGISH_CKPT", str(tmp / "pytorch_vggish.pth"))
    extra = ["-da", "song", "-daf", daf, "-alpha", "0.4"]
    want = _run_avtex(monkeypatch, _m2_flags(
        clip_dir, tmp, *extra, "-rf", str(tmp / f"avtex_{daf}")))
    got = cli.main(_m2_flags(clip_dir, tmp, *extra, "-rf",
                             str(tmp / f"port_{daf}"), "-device", "cpu"))
    assert len(want) == len(got) == 1
    np.testing.assert_array_equal(got[0]["result"].indices,
                                  want[0]["result"].indices)
    assert got[0]["result"].seed_id == want[0]["result"].seed_id
    folder = "results_clip_target_clip_song"
    names = {k: sorted(os.listdir(tmp / f"{k}_{daf}" / folder))
             for k in ("avtex", "port")}
    assert names["port"] == names["avtex"]
    assert any(n.endswith("_report.html") for n in names["port"])


@pytest.fixture(scope="module")
def vfa_resume(tmp_path_factory):
    """A -daf_resume file: avtex's VideoForAudio for the CLI's arch
    (resnet10), its parameters drawn with numpy, written by avtex's
    save_checkpoint."""
    import jax
    import jax.numpy as jnp

    import avtex.contrastive.audio_retrieval as jax_ar
    from avtex.train.checkpoint import save_checkpoint
    shapes = jax.eval_shape(
        jax_ar.VideoForAudio(arch="resnet10").init, jax.random.key(0),
        jnp.zeros((1, 100, 64)), jnp.zeros((1, 1, 15, 32, 32, 3)))
    g = np.random.default_rng(12)

    def draw(path, s):
        if path[-1].key == "scale":
            return (1.0 + 0.1 * g.standard_normal(s.shape)).astype(np.float32)
        if path[-1].key == "bias":
            return (0.1 * g.standard_normal(s.shape)).astype(np.float32)
        return (g.standard_normal(s.shape) / np.sqrt(
            np.prod(s.shape[:-1]))).astype(np.float32)
    params = jax.tree_util.tree_map_with_path(draw, shapes)
    return save_checkpoint(str(tmp_path_factory.mktemp("vfa")), "vfa",
                           params, 3, "resnet10", 0.5, True)


@pytest.mark.parametrize("resume", [True, False])
@pytest.mark.parametrize("m", ["1", "2"])
def test_cli_daf_contrastive_matches_avtex(monkeypatch, clip_dir,
                                           avtex_checkpoint, m2_run,
                                           vfa_resume, m, resume):
    """-e -da song -daf Contrastive, fp32 on both sides. From the same
    -daf_resume file the indices and the seed are identical; without one
    each package draws its own random head (jax.random cannot be
    reproduced), so the walks may part, but the seed, the length and the
    files agree. -m 1 has no source wav: the walk starts at
    start_segment (clipped to the last segment)."""
    import functools

    import jax.numpy as jnp

    import avtex.contrastive.audio_retrieval as jax_ar
    from avtex_torch.synth import pipeline
    _fp32(monkeypatch)
    monkeypatch.setattr(jax_ar, "VideoForAudio", functools.partial(
        jax_ar.VideoForAudio, dtype=jnp.float32))
    monkeypatch.setattr(pipeline, "VideoForAudio", functools.partial(
        pipeline.VideoForAudio, dtype=torch.float32))
    extra = ["-da", "song", "-daf", "Contrastive", "-alpha", "0.4"]
    if resume:
        extra += ["-daf_resume", vfa_resume]
    tag = f"m{m}_{'resume' if resume else 'random'}"

    def argv(who):
        rf = ["-rf", str(m2_run / f"{who}_{tag}")]
        if m == "2":
            return _m2_flags(clip_dir, m2_run, *extra, *rf)
        return _flags(clip_dir, avtex_checkpoint, *extra, "-dadata",
                      str(m2_run / "target"), *rf)
    want = _run_avtex(monkeypatch, argv("avtex"))
    got = cli.main(argv("port") + ["-device", "cpu"])
    assert len(want) == len(got) == 1
    r, w = got[0]["result"], want[0]["result"]
    assert r.seed_id == w.seed_id
    assert len(r.indices) == len(w.indices) > 0
    if resume:
        np.testing.assert_array_equal(r.indices, w.indices)
    folder = "results_clip_target_clip_song"
    names = {k: sorted(os.listdir(m2_run / f"{k}_{tag}" / folder))
             for k in ("avtex", "port")}
    assert names["port"] == names["avtex"]
    assert any("daf_Contrastive" in n for n in names["port"])


def test_cli_m2_needs_the_source_wav(clip_dir, tmp_path):
    argv = FLAGS_M2 + ["-vdata", str(clip_dir), "-adata", str(tmp_path),
                       "-ckpt", str(tmp_path / "ckpt"), "-device", "cpu"]
    with pytest.raises(FileNotFoundError, match="model_type=2 requires"):
        cli.main(argv)


def test_driving_audio_pairs_with_videos_by_index():
    cfg = config.Config(driving_audio=["a", "b.wav"], daf_resume=["x", "y"],
                        evaluate=True, results_folder=None)
    jcfg = jax_config.Config(driving_audio=["a", "b.wav"],
                             daf_resume=["x", "y"], evaluate=True)
    for itr, video in enumerate(("v0", "v1")):
        ours = cli.per_video_config(cfg, video, itr)
        theirs = jax_cli.per_video_config(jcfg, video, itr)
        assert ours.driving_audio == theirs.driving_audio
        assert ours.daf_resume == theirs.daf_resume
        assert ours.results_folder == theirs.results_folder
    assert cli.per_video_config(cfg, "v1", 1).results_folder == \
        "results_v1_target_v1_b"
    with pytest.raises(ValueError, match="by index"):
        cli.per_video_config(cfg, "v2", 2)
    with pytest.raises(ValueError, match="by index"):
        jax_cli.per_video_config(jcfg, "v2", 2)
