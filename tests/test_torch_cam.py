"""CAM videos (``-vcam``) in the port against avtex, on the same seeded
numpy inputs and parameters (drawn with numpy for avtex's tree, carried
over by ``avtex_torch.convert``), fp32 on both sides.

- ``overlay_cam``: the port's own jet table equals matplotlib's, and its
  overlays equal avtex's (OpenCV resize + matplotlib) bit for bit at
  integer scales, and at any scale within 1 level on under 0.1% of the
  pixels (OpenCV's scalar loop tails round the resize one float32 ulp
  apart); tensors and batches give what numpy gives per frame;
- the activation: avtex's ``_last_spatial_intermediate`` lands on the last
  residual block's own output (``BasicBlock3D_3`` of ResNet10, the last
  slow ``SFBottleneck`` of SlowFast), and so do the port's hooks;
- ``segment_cams`` for ResNet10 (width 8, 96 px: 3x3 maps), SlowFast
  (width 8, 64 px, ``norm="affine"``, the 1x1 convs through
  ``fused_conv1x1``'s plain version) and ``model_type=2``: within 1e-4 of
  the largest ``|cam|``; ``model_type=2`` without audio raises in both;
- ``cam_step_frames``: identical frames;
- ``-vcam`` through ``synthesize``: avtex's file names, the CAM frames
  the same, and a 2D frame-mean encoder warns and writes no CAM video.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import avtex.contrastive.model as jax_model
from avtex.config import Config as JaxConfig
from avtex.nn import encoders as jax_encoders
from avtex.nn import resnet3d as jax_resnet3d
from avtex.nn.slowfast import SlowFastR50 as JaxSF
from avtex.obs.visualizations import overlay_cam as jax_overlay_cam
from avtex.synth import cam as jax_cam
from avtex_torch.config import Config
from avtex_torch.contrastive.model import ContrastiveTextures
from avtex_torch.convert import convert_params
from avtex_torch.nn import encoders
from avtex_torch.nn import resnet3d
from avtex_torch.obs.visualizations import jet_lut, overlay_cam
from avtex_torch.synth import cam

torch.set_num_threads(1)

WIDTH = 8
SMALL_SF = dict(width=8, layers=(2, 1, 1, 1))


@pytest.fixture(scope="module", autouse=True)
def small_encoders():
    """ResNet10 and SlowFast at width 8 in both packages' registries
    (avtex's in fp32)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_encoders.ENCODER_REGISTRY, "resnet10", (
            functools.partial(jax_resnet3d.resnet3d10, width=WIDTH), "clip"))
        mp.setitem(encoders.ENCODER_REGISTRY, "resnet10", (
            functools.partial(resnet3d.resnet3d10, width=WIDTH), "clip"))
        mp.setitem(jax_encoders.ENCODER_REGISTRY, "slowfast", (
            lambda dtype=None, norm="group", remat=False: JaxSF(
                **SMALL_SF, dtype=jnp.float32, norm=norm, remat=remat),
            "slowfast"))
        yield


def _video(t, size, seed=0):
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    base = np.stack([np.sin(xx / 5 + i / 2) + np.cos(yy / 7 - i / 7)
                     for i in range(t)])[..., None]
    return np.clip(127 + 60 * base + 8 * g.standard_normal(
        (t, size, size, 3)), 0, 255).astype(np.uint8)


def _draw(shapes, seed=0):
    g = np.random.default_rng(seed)

    def draw(path, s):
        if path[-1].key == "scale":
            return (1.0 + 0.1 * g.standard_normal(s.shape)).astype(np.float32)
        if path[-1].key == "bias":
            return (0.1 * g.standard_normal(s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (g.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
            np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _models(arch, model_type, size, window, norm="group"):
    """avtex's fp32 ContrastiveTextures with drawn parameters, and the
    port's with the same parameters."""
    from avtex.data.preprocess import preprocess_clip
    from avtex.nn.slowfast import slowfast_pathways
    jmodel = jax_model.ContrastiveTextures(arch=arch, model_type=model_type,
                                           dtype=jnp.float32, norm=norm)
    x = preprocess_clip(jnp.zeros((1, window, size, size, 3), jnp.uint8),
                        size=size, slowfast=arch == "slowfast")
    if arch == "slowfast":
        x = slowfast_pathways(x)
        t_in = tuple(p[:, None] for p in x)
    else:
        t_in = x[:, None]
    audio = ((jnp.zeros((1, 100, 64)), jnp.zeros((1, 1, 100, 64)))
             if model_type == 2 else ())
    jparams = _draw(jax.eval_shape(jmodel.init, jax.random.key(0), x, t_in,
                                   *audio))
    model = ContrastiveTextures(arch=arch, model_type=model_type,
                                dtype=torch.float32, norm=norm,
                                **(SMALL_SF if arch == "slowfast" else {}))
    model.load_state_dict(convert_params(jparams, model))
    return jmodel, jparams, model.eval()


# --------------------------------------------------------------------- #
# overlay_cam
# --------------------------------------------------------------------- #

def test_jet_lut_is_matplotlibs():
    from matplotlib import cm
    np.testing.assert_array_equal(jet_lut(), cm.jet(np.arange(256))[:, :3])


@pytest.mark.parametrize("h,w,H,W", [(7, 7, 224, 224), (4, 4, 112, 112),
                                     (3, 3, 96, 96), (2, 5, 64, 160)])
def test_overlay_cam_bit_exact_at_integer_scales(h, w, H, W):
    g = np.random.default_rng(h * w)
    for alpha in (0.5, 0.3):
        cam_ = (g.standard_normal((h, w)) * 30).astype(np.float32)
        image = g.integers(0, 256, (H, W, 3)).astype(np.uint8)
        got = overlay_cam(image, cam_, alpha)
        assert got.dtype == np.uint8 and got.shape == (H, W, 3)
        np.testing.assert_array_equal(got, jax_overlay_cam(image, cam_,
                                                           alpha))


def test_overlay_cam_at_any_scale():
    g = np.random.default_rng(1)
    off = total = 0
    for _ in range(60):
        h, w = g.integers(2, 12, 2)
        H, W = g.integers(8, 300, 2)
        cam_ = (g.standard_normal((h, w)) * g.uniform(0.01, 100)).astype(
            np.float32)
        image = g.integers(0, 256, (H, W, 3)).astype(np.uint8)
        d = np.abs(overlay_cam(image, cam_).astype(int)
                   - jax_overlay_cam(image, cam_).astype(int))
        assert d.max() <= 1
        off, total = off + int((d > 0).sum()), total + d.size
    assert off < 1e-3 * total


def test_overlay_cam_tensors_and_batches():
    g = np.random.default_rng(2)
    cams = (g.standard_normal((3, 5, 6)) * 4).astype(np.float32)
    cams[1] = 2.0  # a flat map: all of it the bottom of the table
    images = g.integers(0, 256, (3, 40, 48, 3)).astype(np.uint8)
    batch = overlay_cam(torch.from_numpy(images), torch.from_numpy(cams))
    assert isinstance(batch, torch.Tensor) and batch.dtype == torch.uint8
    for i in range(3):
        np.testing.assert_array_equal(batch[i].numpy(),
                                      overlay_cam(images[i], cams[i]))
        np.testing.assert_array_equal(batch[i].numpy(),
                                      jax_overlay_cam(images[i], cams[i]))


# --------------------------------------------------------------------- #
# The activation and segment_cams
# --------------------------------------------------------------------- #

def _avtex_pick(jmodel, jparams, x, block):
    """What avtex's ``_last_spatial_intermediate`` picks from the query
    tower's captured tree, beside block ``block``'s own output. The pick
    runs inside the jit, as in avtex's ``segment_cams``: it reads the
    tree's call order, which a jit's output (keys sorted) loses."""
    def run(params, x):
        _, state = jmodel.apply(
            params, x, tower="query", method=jmodel.embed,
            capture_intermediates=lambda mod, name: name == "__call__")
        tree = state["intermediates"]["q_embedder"]["video_encoder"]
        return (jax_cam._last_spatial_intermediate(tree),
                tree[block]["__call__"][0])
    return jax.jit(run)(jparams, x)


def _port_pick(model, x, name):
    """The port's hook winner and the output of module ``name``."""
    enc = model.q_embedder.video_encoder
    outs = {}
    handle = getattr(enc, name).register_forward_hook(
        lambda m, a, out: outs.setdefault("named", out))
    try:
        with torch.no_grad(), cam.last_spatial_activation(enc) as box:
            model.embed(x, tower="query")
    finally:
        handle.remove()
    return box[0], outs["named"]


@pytest.mark.parametrize("arch,size,window,norm,block", [
    ("resnet10", 96, 8, "group", "BasicBlock3D_3"),
    ("slowfast", 64, 8, "affine", "SFBottleneck_8"),
])
def test_the_activation_is_the_last_blocks_output(arch, size, window, norm,
                                                  block):
    from avtex.data.preprocess import preprocess_clip as jpre
    from avtex.nn.slowfast import slowfast_pathways as jpath
    from avtex_torch.data.preprocess import preprocess_clip
    from avtex_torch.nn.slowfast import slowfast_pathways
    jmodel, jparams, model = _models(arch, 1, size, window, norm)
    frames = _video(window, size)[None]
    sf = arch == "slowfast"
    jx = jpre(jnp.asarray(frames), size=size, slowfast=sf)
    x = preprocess_clip(torch.from_numpy(frames), size, sf)
    if sf:
        jx, x = jpath(jx), slowfast_pathways(x)
    picked, block_out = _avtex_pick(jmodel, jparams, jx, block)
    np.testing.assert_array_equal(np.asarray(picked), np.asarray(block_out))
    mine, named = _port_pick(model, x, block)
    assert mine is named
    np.testing.assert_allclose(
        mine.permute(0, 2, 3, 4, 1).numpy(), np.asarray(picked), rtol=1e-4,
        atol=1e-4 * float(np.abs(np.asarray(picked)).max()))


def _check_cams(got, want):
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("arch,size,norm", [("resnet10", 96, "group"),
                                            ("slowfast", 64, "affine")])
def test_segment_cams_match(arch, size, norm):
    window, stride = 8, 3
    frames = _video(40, size)
    L = (len(frames) - window) // stride
    jmodel, jparams, model = _models(arch, 1, size, window, norm)
    want = jax_cam.segment_cams(jmodel, jparams, frames, window, stride, L,
                                img_size=size, batch_size=4)
    got = cam.segment_cams(model, frames, window, stride, L, img_size=size,
                           batch_size=4)
    assert got.shape[0] == L and got.shape[1] == got.shape[2] > 1
    _check_cams(got, want)


def test_segment_cams_model_type_2():
    window, stride, size = 8, 3, 96
    frames = _video(32, size)
    L = (len(frames) - window) // stride
    examples = np.random.default_rng(5).standard_normal(
        (L - 2, 100, 64)).astype(np.float32)   # fewer than L: ids clip
    jmodel, jparams, model = _models("resnet10", 2, size, window)
    for tower in ("query", "target"):
        want = jax_cam.segment_cams(jmodel, jparams, frames, window, stride,
                                    L, audio_examples=examples, tower=tower,
                                    img_size=size, batch_size=4)
        got = cam.segment_cams(model, frames, window, stride, L,
                               audio_examples=examples, tower=tower,
                               img_size=size, batch_size=4)
        _check_cams(got, want)
    with pytest.raises(ValueError, match="require audio_examples"):
        cam.segment_cams(model, frames, window, stride, L, img_size=size)
    with pytest.raises(ValueError, match="require audio_examples"):
        jax_cam.segment_cams(jmodel, jparams, frames, window, stride, L,
                             img_size=size)


def test_cam_step_frames_identical():
    g = np.random.default_rng(6)
    video = g.integers(0, 256, (50, 64, 80, 3)).astype(np.uint8)
    cams = (g.standard_normal((14, 3, 3)) * 5).astype(np.float32)
    ids = np.array([0, 3, 13, 13, 7, 12])
    want = jax_cam.cam_step_frames(video, cams, ids, 8, 3)
    got = cam.cam_step_frames(video, cams, ids, 8, 3)
    got_t = cam.cam_step_frames(torch.from_numpy(video),
                                torch.from_numpy(cams), ids, 8, 3)
    for mine, mine_t, theirs in zip(got, got_t, want):
        assert mine.dtype == np.uint8 and mine.shape == (6, 64, 80, 3)
        np.testing.assert_array_equal(mine, theirs)
        np.testing.assert_array_equal(mine_t, theirs)


# --------------------------------------------------------------------- #
# -vcam through synthesize
# --------------------------------------------------------------------- #

@pytest.fixture
def clip(tmp_path):
    from avtex.media import read_video, write_video
    path = write_video(_video(48, 64, seed=3), str(tmp_path / "clip.mp4"),
                       fps=8.0)
    frames, fps = read_video(path)
    return path, frames, fps


def _record_writes(monkeypatch, module):
    frames = {}
    real = module.write_video

    def recording(f, path, fps, *a, **k):
        frames[os.path.basename(path)] = np.asarray(f)
        return real(f, path, fps, *a, **k)
    monkeypatch.setattr(module, "write_video", recording)
    return frames


def test_vcam_writes_avtexs_files(monkeypatch, clip, tmp_path):
    import avtex.media.video as jax_video
    import avtex_torch.media as port_media
    from avtex.synth.pipeline import synthesize as jax_synthesize
    from avtex_torch.synth import synthesize
    path, frames, fps = clip
    common = dict(enc_arch="resnet10", img_size=64, mini_batchsize=8,
                  new_video_length=3, seed=0, vcam=True)
    jcfg, cfg = JaxConfig(**common), Config(**common,
                                            compute_dtype="float32")
    jmodel, jparams, model = _models("resnet10", 1, 64,
                                     jcfg.derive_geometry(fps).window)
    params = model.state_dict()
    monkeypatch.setattr(jax_model, "ContrastiveTextures", functools.partial(
        jax_model.ContrastiveTextures, dtype=jnp.float32))
    import avtex.synth.pipeline as jax_pipeline
    monkeypatch.setattr(jax_pipeline, "ContrastiveTextures",
                        jax_model.ContrastiveTextures)
    jw = _record_writes(monkeypatch, jax_video)
    pw = _record_writes(monkeypatch, port_media)
    want = jax_synthesize(jcfg, path, jparams, out_dir=str(tmp_path / "a"))
    got = synthesize(cfg, path, params, out_dir=str(tmp_path / "p"),
                     device="cpu")
    np.testing.assert_array_equal(got["result"].indices,
                                  want["result"].indices)
    names = {k: sorted(os.listdir(tmp_path / k)) for k in ("a", "p")}
    assert names["p"] == names["a"]
    assert set(got["paths"]) == set(want["paths"])
    assert {"cam_q_video", "cam_p_video"} <= set(got["paths"])
    assert "cam_s" in got["timings"]
    for key in ("cam_q_video", "cam_p_video"):
        name = os.path.basename(got["paths"][key])
        assert pw[name].shape == jw[name].shape
        assert len(pw[name]) == len(got["result"].indices)
        # maps within 1e-4: a pixel may sit at a jet bin's edge
        assert np.mean(pw[name] != jw[name]) < 1e-3


def test_vcam_with_a_2d_encoder_warns_and_skips(clip, tmp_path, capsys):
    from avtex_torch.synth import synthesize_frames
    _, frames, fps = clip
    cfg = Config(enc_arch="resnet18_2d", img_size=32, mini_batchsize=8,
                 new_video_length=2, vcam=True, compute_dtype="float32")
    out = synthesize_frames(cfg, frames, fps, out_dir=str(tmp_path),
                            device="cpu")
    assert "skipping CAM videos" in capsys.readouterr().err
    assert not any("cam" in k for k in out["paths"])
    assert os.path.exists(out["paths"]["report"])
    assert not any("_cam_" in n for n in os.listdir(tmp_path))
