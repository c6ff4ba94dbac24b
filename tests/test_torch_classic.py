"""The classic Schödl pipeline in the port (avtex_torch/classic/) against
avtex's (avtex/classic/), on the same numpy inputs.

- D2, the value iteration, the thresholds and the transition
  probabilities: fp32 on both sides, summed in other orders, so rtol 1e-5;
- the host walk, the frame-id expansion, the interpolated track and the
  position bars: bit-exact;
- ``run_classic`` end to end against avtex's, both walking on the device
  with avtex's noise (the port's walk is fed the draws of avtex's
  ``jax.random.key(cfg.seed + i)``): identical walks, frame ids, jump
  counts and output names, sigmas within rtol 1e-5; with ``-f ResNet``
  and ``ResNet_VGGish`` too, both given the same ResNet-18 and VGGish
  weights;
- the ResNet feature modes with given weights: features within 1e-4;
  ``compute_paudio`` within 1e-6.

Where a threshold decides (``threshold_rows``), the inputs are checked to
hold no entry within 1e-5 relative of the cutoff, so rounding cannot flip
an entry between the two packages.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtex import classic as jc
from avtex.classic import interp_track as j_interp
from avtex.classic import sampler as j_sampler
from avtex_torch import classic as tc
from avtex_torch.config import ClassicConfig
from avtex_torch.synth.stitcher import crossfade
from test_torch_device_walk import _avtex_noise

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def frames():
    """tests/test_classic.py's 60 tiny frames of moving gradients."""
    g = np.random.default_rng(7)
    t = np.linspace(0, 2 * np.pi, 60, endpoint=False)
    y, x = np.mgrid[0:8, 0:8]
    f = (np.sin(x[None] / 2 + t[:, None, None])
         + np.cos(y[None] / 3 - t[:, None, None]))
    f = f + 0.01 * g.standard_normal(f.shape)
    return (127 * (f + 2) / 4).astype(np.float32)


@pytest.fixture(scope="module")
def d1(frames):
    return np.asarray(jc.pairwise_l2(frames))


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _cutoff_margin(p, threshold):
    """Smallest |p - cutoff| / cutoff over the matrix (float64)."""
    p = np.asarray(p, np.float64)
    rowmax = p.max(axis=1, keepdims=True)
    cut = rowmax - threshold * rowmax
    return float((np.abs(p - cut) / cut).min())


def test_binomial_coeffs_equal():
    for fs in (4, 16, 40):
        got = tc.binomial_coeffs(fs)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, jc.binomial_coeffs(fs))


@pytest.mark.parametrize("fs,stride", [(4, 1), (8, 1), (8, 4), (16, 3)])
def test_d2_matches_avtex(d1, fs, stride):
    want = np.asarray(jc.diagonal_filter_smooth(d1, fs, stride))
    got = tc.diagonal_filter_smooth(_t(d1), fs, stride).numpy()
    assert got.shape == want.shape == ((60 - fs) // stride + 1,) * 2
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    d2, p2, s2 = tc.compute_d2(_t(d1), 4.5, fs, stride)
    jd2, jp2, js2 = jc.compute_d2(d1, 4.5, fs, stride)
    np.testing.assert_allclose(p2.numpy(), np.asarray(jp2), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(float(s2), float(js2), rtol=1e-5)


@pytest.mark.parametrize("scaled,eps", [(True, 1e-4), (False, 1e-2)])
def test_future_cost_matches_avtex(d1, scaled, eps):
    d2 = np.asarray(jc.diagonal_filter_smooth(d1, 8, 1))
    if scaled:  # the magnitude regime of tests/test_classic.py
        d2 = (d2 / d2.mean()).astype(np.float32)
    want = np.asarray(jc.anticipated_future_cost(d2, eps=eps))
    got, sweeps = tc.anticipated_future_cost(_t(d2), eps=eps,
                                             return_sweeps=True)
    assert sweeps > 10
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    # row 0 is never updated (reference quirk)
    np.testing.assert_array_equal(got[0].numpy(), (_t(d2) ** 0.7)[0].numpy())
    np.testing.assert_allclose(got[0].numpy(), d2[0] ** 0.7, rtol=1e-6)


@pytest.mark.parametrize("threshold", [0.25, 0.75])
def test_threshold_rows_matches_avtex(threshold):
    p = np.random.default_rng(3).random((40, 40)).astype(np.float32)
    assert _cutoff_margin(p, threshold) > 1e-5
    got = tc.threshold_rows(_t(p), threshold).numpy()
    want = np.asarray(jc.threshold_rows(p, threshold))
    np.testing.assert_array_equal(got, want)


def test_transition_probs_match_avtex(d1):
    p, sigma = tc.distance_to_transition_probs(_t(d1), 4.5)
    jp, jsigma = jc.distance_to_transition_probs(d1, 4.5)
    assert p.shape == (60, 60) and sigma.ndim == 0
    np.testing.assert_allclose(float(sigma), float(jsigma), rtol=1e-5)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(p.sum(1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("stride,threshold", [(1, 0.75), (3, 0.5)])
def test_staged_and_fused_chain_match_avtex(frames, stride, threshold):
    kw = dict(filter_size=8, stride=stride)
    jd1, _, js1 = jc.compute_d1(frames, 4.5)
    jd2, _, js2 = jc.compute_d2(jd1, 4.5, **kw)
    _, jp3, jp3n, js3 = jc.compute_d3(jd2, 4.5, thresholding=threshold)
    assert _cutoff_margin(jp3, threshold) > 1e-5

    d1, _, s1 = tc.compute_d1(_t(frames), 4.5)
    d2, _, s2 = tc.compute_d2(d1, 4.5, **kw)
    _, p3, p3n, s3 = tc.compute_d3(d2, 4.5, thresholding=threshold)
    np.testing.assert_allclose(p3.numpy(), np.asarray(jp3), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(p3n.numpy(), np.asarray(jp3n), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(p3n.numpy() > 0, np.asarray(jp3n) > 0)
    np.testing.assert_allclose([float(s) for s in (s1, s2, s3)],
                               [float(s) for s in (js1, js2, js3)],
                               rtol=1e-5)

    fused = tc.classic_transition_matrix(_t(frames), 4.5, **kw,
                                         thresholding=threshold)
    np.testing.assert_array_equal(fused.numpy(), p3n.numpy())
    jfused = jc.classic_transition_matrix(frames, 4.5, **kw,
                                          thresholding=threshold)
    np.testing.assert_allclose(fused.numpy(), np.asarray(jfused),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("advance", [0, 3])
def test_host_walk_bit_exact(frames, advance):
    """Both host walks on avtex's P3_new with the same numpy seed."""
    d1, _, _ = jc.compute_d1(frames, 4.5)
    d2, _, _ = jc.compute_d2(d1, 4.5, filter_size=8)
    p3n = np.asarray(jc.compute_d3(d2, 4.5, thresholding=0.75)[2])
    got = tc.sample_texture_walk_host(p3n, 5, 200,
                                      np.random.default_rng(11),
                                      advance=advance)
    want = jc.sample_texture_walk_host(p3n, 5, 200,
                                       np.random.default_rng(11),
                                       advance=advance)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert 0 < got[1].sum() < 200  # jumps and plain steps both happen


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_expand_walk_to_frames_equal(mode):
    walk = np.random.default_rng(mode).integers(0, 50, 30)
    for num_frames in (50, 200, 1000):
        got = tc.expand_walk_to_frames(walk, mode, 4, 8, num_frames)
        want = j_sampler.expand_walk_to_frames(walk, mode, 4, 8, num_frames)
        np.testing.assert_array_equal(got, want)


def _video(t=30, h=40, w=32, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (t, h, w, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("sf", [3, 5])
def test_interp_track_bit_exact(sf):
    vid = _video()
    walk = np.array([0, 1, 2, 9, 10, 11, 3, 4, 29, 0, 1])
    got = tc.classic_interp_track(vid, walk, sf, crossfade, len(vid))
    want = j_interp.classic_interp_track(vid, walk, sf, crossfade, len(vid))
    np.testing.assert_array_equal(got, want)


def test_burn_position_bars_bit_exact():
    vid = _video()
    ids = np.array([0, 1, 5, 17, 29, 3])
    np.testing.assert_array_equal(
        tc.burn_position_bars(vid[ids], ids, len(vid)),
        j_interp.burn_position_bars(vid[ids], ids, len(vid)))


def test_cli_defaults_equal_avtex():
    from avtex.cli.classic_main import build_parser as j_parser
    from avtex_torch.cli.classic_main import build_parser
    argv = ["-vl", "clip"]
    got = vars(build_parser().parse_args(argv))
    want = vars(j_parser().parse_args(argv))
    assert got.pop("device") is None
    assert got == want


def test_classic_config_defaults_equal_avtex():
    import dataclasses
    from avtex.config import ClassicConfig as JaxClassicConfig
    assert (dataclasses.asdict(ClassicConfig())
            == dataclasses.asdict(JaxClassicConfig()))


def _resnet18_pair(seed=0):
    """avtex's resnet2d18 (module, fp32 params with norms moved off
    ones/zeros) and the port's with the same weights."""
    from avtex.nn.resnet2d import resnet2d18 as j_resnet2d18
    from avtex_torch.convert import convert_params
    from avtex_torch.nn.resnet2d import resnet2d18
    from test_torch_slowfast import _perturbed_norms
    m = j_resnet2d18(dtype=jnp.float32)
    params = _perturbed_norms(jax.jit(m.init)(
        jax.random.key(seed), jnp.zeros((1, 112, 112, 3))))
    enc = resnet2d18(dtype=torch.float32)
    holder = torch.nn.Module()
    holder.add_module("enc", enc)
    holder.load_state_dict(convert_params({"enc": params["params"]}, holder))
    return m, params, enc.eval()


def test_resnet_features_match_avtex():
    """Per-frame ResNet-18 features at 112 px with given weights, a tail
    batch padded and trimmed (70 frames in batches of 32)."""
    from avtex.classic.features import resnet_features as j_resnet_features
    vid = _video(t=70, h=40, w=52, seed=3)
    m, params, enc = _resnet18_pair()
    want, j_norm = j_resnet_features(vid, module=m, params=params,
                                     batch_size=32)
    got, norm = tc.resnet_features(vid, "cpu", module=enc, batch_size=32)
    assert norm and j_norm and got.shape == (70, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def _vggish_file(tmp_path):
    """A seeded pytorch_vggish.pth under the reference's names."""
    from avtex_torch.checkpoints import vggish_reference_state
    from avtex_torch.nn.vggish import VGGish
    from avtex_torch.synth.pipeline import flax_style_init
    vg = VGGish(dtype=torch.float32)
    vg.load_state_dict(flax_style_init(vg, 5))
    path = str(tmp_path / "pytorch_vggish.pth")
    torch.save(vggish_reference_state(vg), path)
    return path


def test_resnet_vggish_features_match_avtex(monkeypatch, tmp_path):
    """ResNet features + the VGGish row min(i // stride, len - 1) per
    frame, VGGish loaded from the same pytorch_vggish.pth on both sides
    (bf16, as avtex runs it: rows within 2e-2 of their scale)."""
    import avtex.classic.features as j_features
    from avtex.audio.mel import waveform_to_examples as j_examples
    from avtex_torch.audio import waveform_to_examples
    monkeypatch.setenv("AVTEX_VGGISH_CKPT", _vggish_file(tmp_path))
    vid = _video(t=30, h=40, w=40, seed=4)
    m, params, enc = _resnet18_pair()
    orig = j_features.resnet_features
    monkeypatch.setattr(j_features, "resnet_features",
                        lambda frames, img_size=112: orig(
                            frames, module=m, params=params))
    wav = np.random.default_rng(2).standard_normal(22050 * 3) * 0.1
    want, _ = j_features.resnet_vggish_features(
        vid, np.asarray(j_examples(wav, 22050)), window=8, stride=4)
    got, norm = tc.resnet_vggish_features(
        vid, waveform_to_examples(wav, 22050, device="cpu"), 8, 4, "cpu",
        module=enc)
    want = np.asarray(want)
    assert norm and got.shape == want.shape == (30, 512 + 12288)
    np.testing.assert_allclose(got[:, :512].numpy(), want[:, :512],
                               rtol=1e-4, atol=1e-4)
    scale = np.abs(want[:, 512:]).max()
    assert float(np.abs(got[:, 512:].numpy() - want[:, 512:]).max()) \
        <= 2e-2 * scale
    # frame i carries example min(i // 4, len - 1)
    rows = got[:, 512:].numpy()
    np.testing.assert_array_equal(rows[0], rows[3])
    assert not np.array_equal(rows[3], rows[4])


def test_resnet_features_refuse_a_found_checkpoint_and_warn_without(
        monkeypatch, tmp_path, capsys):
    """No encoder file: avtex's loud warning and seeded random weights
    (the same features twice); an unreadable file raises; a
    ``resnet18-imagenet.pth`` is loaded, BatchNorm folded, and gives
    avtex's features."""
    from avtex.classic import features as j_features
    from avtex.nn.resnet2d import resnet2d18 as j_resnet2d18
    from avtex.utils import convert as j_convert
    from avtex_torch.checkpoints import (maybe_load_encoder,
                                         resnet_reference_state)
    from avtex_torch.nn.resnet2d import resnet2d18
    vid = _video(t=5, h=24, w=24)
    monkeypatch.delenv("AVTEX_ENCODER_CKPT", raising=False)
    monkeypatch.chdir(tmp_path)
    a, _ = tc.frame_features("ResNet", vid, "cpu")
    assert "no pretrained resnet18" in capsys.readouterr().err
    b, _ = tc.frame_features("ResNet", vid, "cpu")
    assert a.shape == (5, 512) and torch.equal(a, b)
    ckpt = tmp_path / "resnet18-imagenet.pth"
    ckpt.write_bytes(b"")
    with pytest.raises(Exception):  # an empty file is no checkpoint
        tc.frame_features("ResNet_VGGish", vid, "cpu")

    state = resnet_reference_state(resnet2d18(), (2, 2, 2, 2), seed=4)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in
                state.items()}, ckpt)
    c, _ = tc.frame_features("ResNet", vid, "cpu")  # bf16, as shipped
    assert "loaded pretrained resnet18_2d" in capsys.readouterr().out
    # the same file in fp32 through both imports
    port = resnet2d18(dtype=torch.float32, norm="affine")
    params, loaded = maybe_load_encoder("resnet18_2d", port,
                                        port.state_dict(),
                                        torch.zeros((1, 32, 32, 3)))
    port.load_state_dict(params)
    jm = j_resnet2d18(dtype=jnp.float32, norm="affine")
    x0 = jnp.zeros((1, 112, 112, 3))
    jparams, j_loaded = j_convert.maybe_load_encoder(
        "resnet18_2d", jm, jax.jit(jm.init)(jax.random.key(0), x0), x0)
    assert loaded and j_loaded
    got = tc.resnet_features(vid, "cpu", module=port.eval())[0]
    want = np.asarray(j_features.resnet_features(vid, module=jm,
                                                 params=jparams)[0])
    assert got.shape == want.shape == (5, 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    cos = torch.nn.functional.cosine_similarity(c, got, dim=-1)
    assert float(cos.min()) >= 0.99


def test_compute_paudio_matches_avtex():
    from avtex.classic.paudio import compute_paudio as j_paudio
    g = np.random.default_rng(0)
    seg = g.standard_normal((40, 128)).astype(np.float32)
    for drv in (g.standard_normal(128).astype(np.float32),
                g.standard_normal((1, 128)).astype(np.float32)):
        got = tc.compute_paudio(torch.from_numpy(drv), torch.from_numpy(seg))
        want = np.asarray(j_paudio(jnp.asarray(drv), jnp.asarray(seg)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert (got.numpy() < 0).any()  # no shift: negative weights stay


def test_entry_point_without_device_raises_on_cpu_only_machine(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.run_classic_frames(ClassicConfig(), _video(), 10.0)


# --------------------------------------------------------------------- #
# End to end: run_classic against avtex's
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """40 random 48^2 frames written as tests/test_classic_interp.py does."""
    from avtex.media import mux_audio_video, read_video
    d = tmp_path_factory.mktemp("classic_clip")
    vid = (np.random.default_rng(0).random((40, 48, 48, 3)) * 255).astype(
        np.uint8)
    src = str(d / "clip.mp4")
    mux_audio_video(vid, None, 22050, src, fps=10.0)
    frames, fps = read_video(src)
    return src, frames, fps


def _walk_on_avtex_noise(p, start, num_steps, generator=None, advance=0):
    """The port's device walk fed the draws avtex's run_classic makes from
    ``jax.random.key(seed)``, the seed the port's driver gave its
    generator."""
    noise = _avtex_noise(generator.initial_seed(), num_steps, p.shape[1])
    return tc.sample_texture_walk(p, start, num_steps, noise=noise,
                                  advance=advance)


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_run_classic_matches_avtex(monkeypatch, tmp_path, clip, mode):
    import avtex.classic.driver as j_driver
    import avtex_torch.classic.driver as t_driver
    from avtex.config import ClassicConfig as JaxClassicConfig

    src, frames, fps = clip
    monkeypatch.setenv("AVTEX_WALK_AOT", "0")
    monkeypatch.setattr(t_driver, "sample_texture_walk", _walk_on_avtex_noise)
    common = dict(model_type=mode, feats="RGB", sigmas=(4.5,),
                  new_video_length=2, SF=3, filter_size=8, seed=3)
    # no entry of P3 within rounding of the threshold's cutoff
    jd1, _, _ = jc.compute_d1(frames, 4.5)
    jd2, _, _ = jc.compute_d2(jd1, 4.5, 8, 4 if mode == 3 else 1)
    jp3 = jc.compute_d3(jd2, 4.5, thresholding=0.08)[1]
    assert _cutoff_margin(jp3, 0.08) > 1e-5

    want = j_driver.run_classic(JaxClassicConfig(**common), src,
                                out_dir=str(tmp_path / "avtex"),
                                interp_fn=crossfade)
    got = tc.run_classic(ClassicConfig(**common), src,
                         out_dir=str(tmp_path / "port"), interp_fn=crossfade,
                         device="cpu")
    (w,), (g,) = want["sigma_results"].values(), got["sigma_results"].values()
    np.testing.assert_array_equal(g["walk"], np.asarray(w["walk"]))
    n = g["p3_new"].shape[0]
    want_ids = np.clip(j_sampler.expand_walk_to_frames(
        np.asarray(w["walk"]), mode, 4, 8, n if mode == 2 else len(frames)),
        0, len(frames) - 1)
    np.testing.assert_array_equal(g["frame_ids"], want_ids)
    assert g["jump_count"] == w["jump_count"] > 0
    assert got["jump_counts"] == want["jump_counts"]
    np.testing.assert_allclose(g["sigmas"], w["sigmas"], rtol=1e-5)
    assert ({k: os.path.basename(v) for k, v in g["paths"].items()}
            == {k: os.path.basename(v) for k, v in w["paths"].items()})
    assert all(os.path.exists(v) for v in g["paths"].values())
    assert ("texture_interp" in g["paths"]) == (mode == 1)


@pytest.mark.parametrize("feats", ["ResNet", "ResNet_VGGish"])
def test_run_classic_resnet_features_match_avtex(monkeypatch, tmp_path, clip,
                                                 feats):
    """``-f ResNet`` / ``ResNet_VGGish`` end to end, both packages given the
    same ResNet-18 and (from one pytorch_vggish.pth, in fp32) VGGish
    weights, the port walking on avtex's noise."""
    import functools
    import avtex.classic.driver as j_driver
    import avtex.classic.features as j_features
    import avtex.nn.vggish as j_vggish
    import avtex_torch.classic.driver as t_driver
    import avtex_torch.classic.features as t_features
    import avtex_torch.nn.vggish as t_vggish
    from avtex.config import ClassicConfig as JaxClassicConfig
    from avtex.media import write_wav

    src, frames, fps = clip
    wav = str(tmp_path / "clip.wav")
    g = np.random.default_rng(1)
    tones = np.repeat(g.uniform(200, 3000, 16), 22050 // 4)
    write_wav(wav, 0.3 * np.sin(2 * np.pi * np.cumsum(tones) / 22050),
              22050)
    monkeypatch.setenv("AVTEX_WALK_AOT", "0")
    monkeypatch.setenv("AVTEX_VGGISH_CKPT", _vggish_file(tmp_path))
    m, params, enc = _resnet18_pair()
    orig = j_features.resnet_features

    def given(frames, img_size=112):
        return orig(frames, module=m, params=params, img_size=img_size)
    monkeypatch.setattr(j_features, "resnet_features", given)
    monkeypatch.setattr(j_driver, "resnet_features", given)
    monkeypatch.setattr(j_vggish, "VGGish",
                        functools.partial(j_vggish.VGGish,
                                          dtype=jnp.float32))
    monkeypatch.setattr(t_features, "_random_resnet18", lambda device: enc)
    monkeypatch.setattr(t_vggish, "VGGish",
                        functools.partial(t_vggish.VGGish,
                                          dtype=torch.float32))
    monkeypatch.setattr(t_driver, "sample_texture_walk", _walk_on_avtex_noise)
    common = dict(model_type=1, feats=feats, sigmas=(4.5,),
                  new_video_length=2, SF=3, filter_size=8, seed=3)
    want = j_driver.run_classic(JaxClassicConfig(**common), src,
                                audio_path=wav,
                                out_dir=str(tmp_path / "avtex"),
                                interp_fn=crossfade)
    got = tc.run_classic(ClassicConfig(**common), src, audio_path=wav,
                         out_dir=str(tmp_path / "port"), interp_fn=crossfade,
                         device="cpu")
    (w,), (g,) = want["sigma_results"].values(), got["sigma_results"].values()
    np.testing.assert_array_equal(g["walk"], np.asarray(w["walk"]))
    assert g["jump_count"] == w["jump_count"] > 0
    np.testing.assert_allclose(g["sigmas"], w["sigmas"], rtol=1e-4)


def test_run_classic_frames_returns_frames_without_out_dir(clip):
    _, frames, fps = clip
    cfg = ClassicConfig(model_type=1, sigmas=(4.5, 4.58), filter_size=8,
                        new_video_length=3)
    out = tc.run_classic_frames(cfg, frames, fps, device="cpu")
    again = tc.run_classic_frames(cfg, frames, fps, device="cpu")
    assert list(out["sigma_results"]) == [4.5, 4.58]
    for sigma, e in out["sigma_results"].items():
        assert e["paths"] == {}
        assert len(e["walk"]) == int(3 * fps) + 1
        ids = e["frame_ids"]
        np.testing.assert_array_equal(
            e["frames"], tc.burn_position_bars(frames[ids], ids, len(frames)))
        assert e["frames_intp"].shape[1:] == frames.shape[1:]
        # every transition lands on a surviving entry of its row
        assert all(e["p3_new"][a, b] > 0
                   for a, b in zip(e["walk"][:-1], e["walk"][1:]))
        assert e["sweeps"] > 0 and set(e["timings"]) >= {
            "d1_s", "d2_s", "d3_s", "fetch_s", "walk_s", "bars_s",
            "interp_s"}
        np.testing.assert_array_equal(
            e["walk"], again["sigma_results"][sigma]["walk"])


def test_cli_writes_the_textures(tmp_path, clip):
    from avtex_torch.cli.classic_main import main
    src, _, _ = clip
    out = tmp_path / "out"
    main(["-vdata", os.path.dirname(src), "-vl", "clip", "-m", "3",
          "-fs", "8", "-sigma", "4.5", "-nvl", "2", "-device", "cpu",
          "-results_folder", str(out), "-logdir", str(tmp_path / "logs")])
    assert sorted(os.listdir(out)) == ["clip_classic_m3_sigma4.5.mp4"]


def test_run_classic_frames_logs_avtex_figures(clip):
    """With a logger, run_classic_frames draws avtex's seven matrices per
    sigma and the jump-count chart, under avtex's tags."""
    _, frames, fps = clip

    class Recorder:
        def __init__(self):
            self.tags = []

        def log_figure(self, fig, tag, step):
            self.tags.append((tag, step))

    logger = Recorder()
    cfg = ClassicConfig(model_type=2, sigmas=(4.5, 4.52), filter_size=8,
                        new_video_length=1)
    tc.run_classic_frames(cfg, frames, fps, logger=logger, device="cpu")
    mats = ["D1", "P1", "D2", "P2", "D3", "P3", "P3_new"]
    assert logger.tags == ([(f"classic/{m}", 0) for m in mats]
                           + [(f"classic/{m}", 1) for m in mats]
                           + [("classic/jump_counts", 0)])
