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
Also: the random-init opt-out, the missing-checkpoint error, the
refusals of what is not ported, and the results-folder rule."""

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


@pytest.mark.parametrize("extra,item", [
    ([], "'Training'"),
    (["-e", "-m", "2"], "-m 2"),
    (["-e", "-da", "song"], "-m 2"),
    (["-e", "--mesh"], "'Multi-GPU'"),
])
def test_cli_refuses_what_is_not_ported(clip_dir, tmp_path, extra, item):
    argv = [a for a in _flags(clip_dir, tmp_path) if a != "-e"] + extra
    with pytest.raises(NotImplementedError, match=item):
        cli.main(argv)


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
