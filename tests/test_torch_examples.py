"""The port's library examples (avtex_torch/examples/) on the CPU, and the
OpenCV-free PNG writer they write their frames with.

Each example's ``main(device="cpu", out_dir=...)`` runs at its own sizes
(avtex's: a procedural 32 px clip, a ResNet10, the same seconds,
thresholds and seeds). The two that train run one epoch here, not six
and four, to keep the file short; nothing else is cut. Outputs exist,
are finite and have the expected shapes and counts, the PNG frames read
back as the returned frames, a repeated request gives the same walk, the
audio-driven texture's track is the driving waveform, and
``sharded_embed`` runs under ``torchrun`` in two gloo processes. The
served requests in fp32 give avtex's ``TextureServer``'s walks on the
same parameters (carried over by ``avtex_torch.convert``) and the same
decoded clip. PNG files are OpenCV's byte for byte (more than 256 bytes
of filtered rows; smaller ones decode to the same pixels).
"""

import dataclasses
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avtex_torch.media import read_wav, write_frames_png
from avtex_torch.media.png import encode_png

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _png_dir(folder):
    names = sorted(os.listdir(folder))
    assert names == [f"{i:06d}.png" for i in range(len(names))]
    return [cv2.imread(os.path.join(folder, n))[..., ::-1] for n in names]


def _check_texture(frames, n, folder=None):
    assert frames.dtype == np.uint8 and frames.shape == (n, 32, 32, 3)
    if folder is not None:
        back = _png_dir(folder)
        assert len(back) == n
        np.testing.assert_array_equal(np.stack(back), frames)


@pytest.mark.parametrize("h, w", [(1, 1), (4, 5), (12, 10), (33, 1),
                                  (32, 32), (64, 100), (224, 224)])
def test_png_is_opencvs(h, w):
    g = np.random.default_rng(h * 1000 + w)
    for frame in ((g.random((h, w, 3)) * 255).astype(np.uint8),
                  np.full((h, w, 3), 7, np.uint8)):
        ok, want = cv2.imencode(".png", np.ascontiguousarray(frame[..., ::-1]))
        got = encode_png(frame)
        if h * (3 * w + 1) > 256:
            assert got == want.tobytes()
        back = cv2.imdecode(np.frombuffer(got, np.uint8), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(back[..., ::-1], frame)


def _one_epoch(monkeypatch, module):
    monkeypatch.setattr(module, "CONFIG",
                        dataclasses.replace(module.CONFIG, epochs=1))


def test_quickstart(monkeypatch, tmp_path):
    from avtex_torch.examples import quickstart
    _one_epoch(monkeypatch, quickstart)
    out = quickstart.main(device="cpu", out_dir=str(tmp_path))
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"]).all()
    assert all(bool(torch.isfinite(p).all()) for p in out["params"].values())
    cfg = quickstart.CONFIG
    steps = len(out["result"].indices)
    assert steps == 15  # 4 s at 8 fps in windows of 4, stride 2
    _check_texture(out["frames"], cfg.window + (steps - 1) * cfg.stride,
                   str(tmp_path / "texture"))
    assert (tmp_path / "loop_latest").exists()
    assert (tmp_path / "loop_best").exists()


def test_serve(tmp_path):
    from avtex_torch.examples import serve
    out = serve.main(device="cpu", out_dir=str(tmp_path))
    server, reqs = out["server"], out["requests"]
    for table in (server.q_table, server.t_table):
        assert table.shape == (server.L, 512)
        assert bool(torch.isfinite(table).all())
    np.testing.assert_array_equal(reqs["a"]["result"].indices,
                                  reqs["a2"]["result"].indices)
    np.testing.assert_array_equal(reqs["a"]["frames"], reqs["a2"]["frames"])
    for name, seconds in (("a", 3), ("b", 5), ("c", 3), ("a2", 3)):
        r = reqs[name]
        _check_texture(r["frames"], int(seconds * serve.FPS),
                       str(tmp_path / f"request_{name}"))
    song, sr = read_wav(str(tmp_path / "song.wav"))
    assert reqs["c"]["sample_rate"] == sr == serve.SR
    np.testing.assert_array_equal(reqs["c"]["audio"], song)


def _avtex_resnet10_fp32(dtype=None, norm="group", remat=False):
    from avtex.nn import resnet3d
    return resnet3d.resnet3d10(dtype=jnp.float32, norm=norm, remat=remat)


def test_serve_matches_avtex_in_fp32(monkeypatch, tmp_path):
    """The example's requests on avtex's server and on the port's, both
    fp32, one set of random parameters, the clip decoded once."""
    from avtex.config import Config as JaxConfig
    from avtex.contrastive.model import ContrastiveTextures as JaxCT
    from avtex.data.preprocess import preprocess_clip
    from avtex.media import read_video, write_video
    from avtex.nn import encoders as jax_encoders
    from avtex.synth.server import TextureServer as JaxServer
    from avtex_torch.convert import convert_params
    from avtex_torch.examples import serve
    from avtex_torch.examples._common import loop_clip
    from avtex_torch.media import write_wav
    from avtex_torch.synth.pipeline import build_model
    from avtex_torch.synth.server import TextureServer

    monkeypatch.setitem(jax_encoders.ENCODER_REGISTRY, "resnet10",
                        (_avtex_resnet10_fp32, "clip"))
    path = str(tmp_path / "loop.mp4")
    write_video(loop_clip(80, 32, 32, period=20), path, fps=serve.FPS)
    frames, fps = read_video(path)
    song_path = write_wav(str(tmp_path / "song.wav"), serve.song(), serve.SR)

    fields = {f.name: getattr(serve.CONFIG, f.name)
              for f in dataclasses.fields(JaxConfig)
              if hasattr(serve.CONFIG, f.name)}
    jcfg = JaxConfig(**dict(fields, compute_dtype="float32"))
    cfg = dataclasses.replace(serve.CONFIG, compute_dtype="float32")
    W = jcfg.derive_geometry(fps).window
    x = preprocess_clip(jnp.asarray(frames[None, :W]), size=32)
    shapes = jax.eval_shape(JaxCT(arch="resnet10").init, jax.random.key(0),
                            x, x[:, None])
    g = np.random.default_rng(0)

    def draw(kp, s):
        if kp[-1].key == "scale":
            return (1.0 + 0.1 * g.standard_normal(s.shape)).astype(np.float32)
        if kp[-1].key == "bias":
            return (0.1 * g.standard_normal(s.shape)).astype(np.float32)
        return (g.standard_normal(s.shape)
                / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
    jparams = jax.tree_util.tree_map_with_path(draw, shapes)
    params = convert_params(jparams, build_model(cfg, None, "cpu"))

    jserver = JaxServer(jcfg, path, params=jparams, audio_path=song_path)
    server = TextureServer.from_frames(cfg, frames, fps, params,
                                       audio_path=song_path, device="cpu")
    np.testing.assert_allclose(server.q_table.numpy(),
                               np.asarray(jserver.q_table),
                               rtol=1e-4, atol=1e-4)
    got = serve.run_requests(server, song_path)
    want = serve.run_requests(jserver, song_path)
    jumps = 0
    for name in ("a", "b", "a2"):
        np.testing.assert_array_equal(got[name]["result"].indices,
                                      want[name]["result"].indices)
        np.testing.assert_array_equal(got[name]["frames"],
                                      want[name]["frames"])
        jumps += int(want[name]["result"].jumps[1:].sum())
    assert jumps > 0
    # Request c seeds its walk at the segment whose audio best matches the
    # driving clip's first example. The driving clip is the source's own
    # steady tone, so segments tie to ~1e-7 in cosine and the two
    # frameworks' rounding may pick different ones of them; the walk after
    # the seed is the same.
    gc, wc = got["c"]["result"], want["c"]["result"]
    np.testing.assert_array_equal(gc.indices[1:], wc.indices[1:])
    if gc.seed_id != wc.seed_id:
        from avtex_torch.audio import waveform_to_examples
        src = server.audio_examples[:server.L].double().reshape(
            server.L, -1)
        drv = waveform_to_examples(*read_wav(song_path), device="cpu")
        d = drv[0].double().reshape(-1)
        sims = (src @ d) / (src.norm(dim=1) * d.norm())
        best = float(sims.max())
        for sid in (gc.seed_id, wc.seed_id):
            assert best - float(sims[sid]) <= 1e-5, (sid, best)


def test_classic(tmp_path):
    from avtex_torch.examples import classic
    out = classic.main(device="cpu", out_dir=str(tmp_path))
    sweep = out["sweep"]
    assert sorted(sweep["sigma_results"]) == [4.5, 4.55]
    for sigma, r in sweep["sigma_results"].items():
        assert sweep["jump_counts"][sigma] == r["jump_count"] > 0
        _check_texture(r["frames"], 21,
                       str(tmp_path / f"loop_classic_m1_sigma{sigma}"))
    probs = out["probs"]
    assert probs.shape == (53, 53) and np.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(1), 1.0, rtol=1e-5)


def test_sharded_embed_in_one_process(tmp_path):
    from avtex_torch.examples import sharded_embed
    from avtex_torch.contrastive.segments import num_segments
    out = sharded_embed.main(device="cpu", out_dir=str(tmp_path))
    L = num_segments(sharded_embed.T, sharded_embed.W, sharded_embed.S)
    assert out["world_size"] == 1 and out["table"].shape == (L, 512)
    assert np.isfinite(out["table"]).all()
    # bf16 tables; the two paths batch the segments differently
    np.testing.assert_allclose(out["table"], out["unsharded"], atol=2e-2,
                               rtol=2e-2)
    np.testing.assert_array_equal(np.load(tmp_path / "table.npy"),
                                  out["table"])
    assert not torch.distributed.is_initialized()  # its world is ended


def test_sharded_embed_under_torchrun(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "avtex_torch.examples.sharded_embed",
         "--device", "cpu", "--out-dir", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "matches the unsharded embed" in proc.stdout
    assert "over 2 processes" in proc.stdout
    from avtex_torch.contrastive.segments import num_segments
    from avtex_torch.examples import sharded_embed
    table = np.load(tmp_path / "table.npy")
    L = num_segments(sharded_embed.T, sharded_embed.W, sharded_embed.S)
    assert table.shape == (L, 512) and np.isfinite(table).all()


def test_audio_driven(monkeypatch, tmp_path):
    from avtex_torch.examples import audio_driven
    monkeypatch.delenv("AVTEX_VGGISH_CKPT", raising=False)
    monkeypatch.chdir(tmp_path)  # no pretrained/ VGGish file is found
    _one_epoch(monkeypatch, audio_driven)
    out = audio_driven.main(device="cpu", out_dir=str(tmp_path))
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"]).all()
    cfg = audio_driven.CONFIG
    steps = len(out["result"].indices)
    assert steps == 15  # the 4 s texture; the driving clip is 6 s
    _check_texture(out["frames"], cfg.window + (steps - 1) * cfg.stride,
                   str(tmp_path / "texture"))
    driving, sr = read_wav(str(tmp_path / "driving.wav"))
    assert out["sample_rate"] == sr == audio_driven.SR
    np.testing.assert_array_equal(out["audio"], driving)
    track, track_sr = read_wav(str(tmp_path / "texture.wav"))
    assert track_sr == sr  # 16-bit PCM written as x * (2^15 - 1): one step
    np.testing.assert_allclose(track, driving, rtol=0, atol=2.0 ** -15)
    for name in ("loop.wav", "loop_av_latest", "loop_av_best"):
        assert (tmp_path / name).exists()


def test_examples_write_nothing_without_out_dir(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    from avtex_torch.examples import classic
    out = classic.main(device="cpu")
    assert out["probs"].shape == (53, 53) and os.listdir(tmp_path) == []
    write_frames_png(np.zeros((2, 3, 4, 3), np.uint8), str(tmp_path / "p"))
    assert sorted(os.listdir(tmp_path / "p")) == ["000000.png", "000001.png"]
