"""Pretrained encoder import in the port (avtex_torch/checkpoints.py)
against avtex's (avtex/utils/convert.py), on files the tests write in the
reference's formats with seeded random weights (no checkpoint ships with
the repo):

- ``convert_bn_folded``: a BN ``.pth`` under torchvision's /
  3D-ResNets-PyTorch's names into ``resnet18``, ``resnet50`` (3D) and
  ``resnet2d18`` at width 8: the port's features against avtex's, fp32,
  within rtol/atol 1e-4;
- ``load_slowfast_state`` + ``convert_slowfast`` at layers (2, 1, 1, 1),
  width 8, from a ``.pyth`` and from a caffe2 ``.pkl`` (py2, numpy 1 and
  numpy 2 pickles): the state equals avtex's tensor for tensor, the
  embeddings within 1e-4;
- coverage, kind and shape errors raise ``ValueError`` in both, one case
  each; an unreadable file raises with both readers' errors;
- ``init_params_for_synthesis`` with ``$AVTEX_ENCODER_CKPT`` grafts both
  towers and gives avtex's synthesis tables;
- ``python -m avtex_torch.cli.import_slowfast``.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avtex.nn import resnet2d as j_resnet2d
from avtex.nn import resnet3d as j_resnet3d
from avtex.nn.slowfast import SlowFastR50 as JaxSF
from avtex.nn.slowfast import slowfast_pathways as j_pathways
from avtex.utils import convert as j_convert
from avtex_torch import checkpoints as ck
from avtex_torch.nn import resnet2d, resnet3d
from avtex_torch.nn.slowfast import SlowFastR50, slowfast_pathways

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SF_LAYERS = (2, 1, 1, 1)
WIDTH = 8

# name -> (port factory, avtex factory, layers, input shape)
BN_NETS = {
    "resnet18": (resnet3d.resnet3d18, j_resnet3d.resnet3d18, (2, 2, 2, 2),
                 (2, 8, 32, 32, 3)),
    "resnet50": (resnet3d.resnet3d50, j_resnet3d.resnet3d50, (3, 4, 6, 3),
                 (2, 8, 32, 32, 3)),
    "resnet2d18": (resnet2d.resnet2d18, j_resnet2d.resnet2d18, (2, 2, 2, 2),
                   (2, 32, 32, 3)),
}


def _save_torch(state, path, wrap=None, prefix=""):
    tensors = {prefix + k: torch.from_numpy(np.asarray(v))
               for k, v in state.items()}
    torch.save(tensors if wrap is None else {wrap: tensors, "epoch": 3},
               path)
    return str(path)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("arch", sorted(BN_NETS))
def test_bn_folded_matches_avtex(arch, tmp_path):
    factory, j_factory, layers, shape = BN_NETS[arch]
    port = factory(width=WIDTH, dtype=torch.float32, norm="affine")
    path = _save_torch(ck.resnet_reference_state(port, layers, seed=1),
                       tmp_path / "bn.pth")
    ex = torch.zeros((1,) + shape[1:])
    state = {k: v for k, v in ck.load_torch_state(path).items()
             if not k.startswith("fc.")}
    params = ck.convert_bn_folded(state, port, port.state_dict(), ex)
    for k, v in params.items():  # the fold lands in fp32
        if k.endswith(".scale"):
            assert v.dtype == torch.float32
    port.load_state_dict(params)

    jm = j_factory(width=WIDTH, dtype=jnp.float32, norm="affine")
    jex = jnp.zeros((1,) + shape[1:])
    jstate = {k: v for k, v in j_convert.load_torch_state(path).items()
              if not k.startswith("fc.")}
    jparams = j_convert.convert_bn_folded(
        jstate, jm, jax.jit(jm.init)(jax.random.key(0), jex), jex)
    x = _x(shape)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jm.apply)(jparams, x))
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_conv_bias_folds_into_the_next_bn():
    """A conv bias just before a BN moves into that BN's shift, as in
    avtex's tokens (which carry flax's transposed kernels)."""
    g = np.random.default_rng(2)
    state = {"conv.weight": g.standard_normal((4, 3, 3, 3)),
             "conv.bias": g.standard_normal(4),
             "bn.weight": g.standard_normal(4), "bn.bias": g.standard_normal(4),
             "bn.running_mean": g.standard_normal(4),
             "bn.running_var": 0.5 + g.random(4),
             "head.weight": g.standard_normal((4, 3, 3, 3)),
             "head.bias": g.standard_normal(4)}
    got = ck._torch_tokens(state)
    want = j_convert._torch_tokens(state)
    assert [t[0] for t in got] == [t[0] for t in want] == ["conv", "norm",
                                                           "conv"]
    assert got[0][2] is None and want[0][2] is None
    np.testing.assert_array_equal(got[0][1], state["conv.weight"])
    for a, b in zip(got[1][1:], want[1][1:]):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[2][2], state["head.bias"])


def test_call_order_is_the_forward_s_not_registration():
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.late = torch.nn.Conv2d(4, 4, 1)  # registered first
            self.early = torch.nn.Conv2d(3, 4, 3)

        def forward(self, x):
            return self.late(self.early(x))

    net = Net()
    assert ck.module_call_order(net, torch.zeros(1, 3, 8, 8)) == [
        "early", "late"]
    assert not net._forward_pre_hooks  # the hooks are gone afterwards
    assert not net.late._forward_pre_hooks


# --------------------------------------------------------------------- #
# SlowFast: the name map and the two file formats
# --------------------------------------------------------------------- #

def _pkl(state, path, variant):
    """A caffe2 blob pickle of ``state``: ``py2`` (protocol 2, numpy.core
    names as py2 / numpy 1 write them), ``np2`` (protocol 2 as numpy 2
    writes it), ``p5`` (protocol 5, out-of-band-capable buffers)."""
    blobs = ck.slowfast_c2_blobs(state, SF_LAYERS)
    blobs["model_iter"] = 12  # not an array: skipped
    proto = 5 if variant == "p5" else 2
    data = pickle.dumps({"blobs": blobs, "model_name": "slowfast"},
                        protocol=proto)
    if variant == "py2":
        data = data.replace(b"numpy._core.multiarray\n",
                            b"numpy.core.multiarray\n")
        assert b"numpy.core.multiarray\n_reconstruct" in data
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


@pytest.fixture(scope="module")
def sf_state():
    return ck.slowfast_reference_state(SF_LAYERS, WIDTH, seed=5)


def _sf_inputs(seed=0):
    g = np.random.default_rng(seed)
    frames = g.standard_normal((2, 32, 32, 32, 3)).astype(np.float32)
    slow, fast = slowfast_pathways(torch.from_numpy(frames))
    return slow.numpy(), fast.numpy()


@pytest.mark.parametrize("fmt", ["pyth", "pkl-py2", "pkl-np2", "pkl-p5"])
def test_slowfast_import_matches_avtex(fmt, sf_state, tmp_path):
    if fmt == "pyth":
        path = _save_torch(sf_state, tmp_path / "sf.pyth",
                           wrap="model_state", prefix="model.")
    else:
        path = _pkl(sf_state, tmp_path / "sf.pkl", fmt.split("-")[1])
    got = ck.load_slowfast_state(path)
    want = j_convert.load_slowfast_state(path)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # every conv and BN tensor of the written state came back
    for k, v in sf_state.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(got[k], v, err_msg=k)

    port = SlowFastR50(SF_LAYERS, WIDTH, dtype=torch.float32, norm="affine")
    port.load_state_dict(ck.convert_slowfast(got, port.state_dict(),
                                             SF_LAYERS))
    jm = JaxSF(layers=SF_LAYERS, width=WIDTH, dtype=jnp.float32,
               norm="affine")
    slow, fast = _sf_inputs()
    jparams = j_convert.convert_slowfast(
        want, jax.jit(jm.init)(jax.random.key(0), slow[:1], fast[:1]),
        layers=SF_LAYERS)
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(slow), torch.from_numpy(fast))
    ref = np.asarray(jax.jit(jm.apply)(jparams, slow, fast))
    assert out.shape == ref.shape == (2, WIDTH * 32 + WIDTH * 4)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_c2_pickle_admits_only_numpy(tmp_path):
    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))
    path = tmp_path / "evil.pkl"
    path.write_bytes(pickle.dumps({"blobs": {"conv1_w": Evil()}},
                                  protocol=2))
    with pytest.raises(RuntimeError, match="not allowed") as e:
        ck.load_slowfast_state(str(path))
    assert "torch save" in str(e.value)  # both readers' errors


def test_unreadable_file_raises_with_both_errors(tmp_path):
    path = tmp_path / "junk.pkl"
    path.write_bytes(np.random.default_rng(0).bytes(300))
    with pytest.raises(RuntimeError) as e:
        ck.load_slowfast_state(str(path))
    msg = str(e.value)
    assert str(path) in msg and "torch save" in msg \
        and "caffe2 pickle" in msg


def _drop(state, prefix):
    return {k: v for k, v in state.items() if not k.startswith(prefix)}


def _sf_error_cases():
    """(label, port call, avtex call, message) on the module's state."""
    st = ck.slowfast_reference_state(SF_LAYERS, WIDTH, seed=5)
    wide = ck.slowfast_reference_state(SF_LAYERS, 2 * WIDTH, seed=5)
    extra = dict(st, **{"s9.extra.weight": np.zeros((1, 1, 1, 1, 1),
                                                    np.float32)})
    return {
        "slowfast-unmapped": (extra, "affine", "unmapped modules"),
        "slowfast-missing-conv": (_drop(st, "s3.pathway1_res0.branch2.b."),
                                  "affine", "missing conv"),
        "slowfast-missing-bn": (_drop(st, "s1_fuse.bn."), "affine",
                                "missing bn"),
        "slowfast-shape": (wide, "affine", "shape mismatch"),
        "slowfast-no-slot": (st, "group", "no port slot"),
    }


@pytest.mark.parametrize("case", sorted(_sf_error_cases()))
def test_slowfast_import_errors_raise(case):
    state, norm, msg = _sf_error_cases()[case]
    port = SlowFastR50(SF_LAYERS, WIDTH, dtype=torch.float32, norm=norm)
    with pytest.raises(ValueError, match=msg):
        ck.convert_slowfast(state, port.state_dict(), SF_LAYERS)
    jm = JaxSF(layers=SF_LAYERS, width=WIDTH, dtype=jnp.float32, norm=norm)
    slow, fast = _sf_inputs()
    shapes = jax.eval_shape(jm.init, jax.random.key(0), slow[:1], fast[:1])
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)
    with pytest.raises(ValueError):
        j_convert.convert_slowfast(state, tree, layers=SF_LAYERS)


def _bn_error_state(case, port):
    st = {k: v for k, v in ck.resnet_reference_state(
        port, (2, 2, 2, 2), seed=1).items() if not k.startswith("fc.")}
    keys = list(st)
    if case == "count":
        return {k: v for k, v in st.items()
                if not k.startswith("layer4.1.bn2.")}
    if case == "kind":  # a BN before the stem conv
        first = [k for k in keys if k.startswith("bn1.")]
        return {**{k: st[k] for k in first},
                **{k: v for k, v in st.items() if k not in first}}
    if case == "conv-shape":
        st["layer2.0.conv1.weight"] = st["layer2.0.conv1.weight"][:, :-1]
        return st
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        st[f"layer3.1.bn1.{leaf}"] = st[f"layer3.1.bn1.{leaf}"][:-1]
    return st


@pytest.mark.parametrize("case, msg", [
    ("count", "slot count mismatch"), ("kind", "slot kind mismatch at"),
    ("conv-shape", "shape mismatch at BasicBlock2D_2.Conv_0"),
    ("norm-shape", "norm shape mismatch at BasicBlock2D_5.Affine_0")])
def test_bn_folded_errors_raise(case, msg):
    port = resnet2d.resnet2d18(width=WIDTH, dtype=torch.float32,
                               norm="affine")
    state = _bn_error_state(case, port)
    with pytest.raises(ValueError, match=msg):
        ck.convert_bn_folded(state, port, port.state_dict(),
                             torch.zeros((1, 32, 32, 3)))
    jm = j_resnet2d.resnet2d18(width=WIDTH, dtype=jnp.float32, norm="affine")
    jex = jnp.zeros((1, 32, 32, 3))
    with pytest.raises(ValueError):
        j_convert.convert_bn_folded(
            state, jm, jax.jit(jm.init)(jax.random.key(0), jex), jex)


# --------------------------------------------------------------------- #
# Synthesis: both towers, avtex's tables
# --------------------------------------------------------------------- #

def test_affine_synthesis_loads_the_file_into_both_towers(
        monkeypatch, tmp_path):
    """``-ea resnet18 --norm affine`` with ``$AVTEX_ENCODER_CKPT`` on an
    ``r3d18_KM_200ep.pth``-style file at width 8: both towers of the
    port get the BN-folded file, and the server's tables equal avtex's
    (fp32, within 1e-4)."""
    from avtex.config import Config as JaxConfig
    from avtex.media import read_video, write_video
    from avtex.nn import encoders as j_encoders
    from avtex.synth.server import TextureServer as JaxServer
    from avtex_torch.config import Config
    from avtex_torch.synth import TextureServer

    monkeypatch.chdir(tmp_path)
    for env in ("AVTEX_ENCODER_CKPT", "AVTEX_SLOMO_CKPT",
                "AVTEX_VGGISH_CKPT"):
        monkeypatch.delenv(env, raising=False)
    def small_r18(dtype=None, **kw):  # fp32 whatever the model asks
        return j_resnet3d.resnet3d18(width=WIDTH, dtype=jnp.float32, **kw)
    monkeypatch.setitem(j_encoders.ENCODER_REGISTRY, "resnet18",
                        (small_r18, "clip"))
    t, h, w = 40, 32, 32
    yy, xx = np.mgrid[0:h, 0:w]
    vid = np.clip(127 + 60 * np.stack(
        [np.sin(xx / 3 + i / 2) + np.cos(yy / 5 - i / 7) for i in range(t)]
    )[..., None].repeat(3, -1), 0, 255).astype(np.uint8)
    clip = str(tmp_path / "clip.mp4")
    write_video(vid, clip, fps=8.0)
    frames, fps = read_video(clip)

    port_enc = resnet3d.resnet3d18(width=WIDTH, dtype=torch.float32,
                                   norm="affine")
    ckpt = _save_torch(ck.resnet_reference_state(port_enc, (2, 2, 2, 2),
                                                 seed=7),
                       tmp_path / "r3d18_KM_200ep.pth")
    monkeypatch.setenv("AVTEX_ENCODER_CKPT", ckpt)
    common = dict(enc_arch="resnet18", norm="affine", img_size=32,
                  mini_batchsize=8, seed=0)
    server = TextureServer.from_frames(
        Config(**common, compute_dtype="float32"), frames, fps, None,
        device="cpu", width=WIDTH)
    jserver = JaxServer(JaxConfig(**common), clip, params=None)

    loaded = server.model.state_dict()
    want = ck.convert_bn_folded(
        {k: v for k, v in ck.load_torch_state(ckpt).items()
         if not k.startswith("fc.")}, port_enc, port_enc.state_dict(),
        torch.zeros((1, 8, 32, 32, 3)))
    for k, v in want.items():
        for tower in ("q_embedder", "t_embedder"):
            assert torch.equal(loaded[f"{tower}.video_encoder.{k}"], v), k
    assert server.L == jserver.L > 10
    for mine, theirs in ((server.q_table, jserver.q_table),
                         (server.t_table, jserver.t_table)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------- #
# The import CLI
# --------------------------------------------------------------------- #

def test_import_cli_ok_and_out(sf_state, tmp_path, capsys):
    from flax.serialization import msgpack_restore
    from avtex_torch.cli.import_slowfast import main
    from avtex_torch.convert import export_params
    path = _pkl(sf_state, tmp_path / "sf.pkl", "np2")
    out = str(tmp_path / "sf.msgpack")
    assert main([path, "--layers", "2,1,1,1", "--width", "8", "--device",
                 "cpu", "--out", out]) == 0
    text = capsys.readouterr().out
    for line in ("[1/3]", "[2/3]", "[3/3]", "IMPORT OK"):
        assert line in text
    with open(out, "rb") as f:
        tree = msgpack_restore(f.read())
    port = SlowFastR50(SF_LAYERS, WIDTH, dtype=torch.float32, norm="affine")
    want = export_params(ck.convert_slowfast(
        ck.load_slowfast_state(path), port.state_dict(), SF_LAYERS))
    flat_got = jax.tree_util.tree_leaves_with_path(tree)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (_, a), (_, b) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("what", ["garbage", "wrong-depth"])
def test_import_cli_failed_without_traceback(what, sf_state, tmp_path):
    if what == "garbage":
        path = tmp_path / "junk.pkl"
        path.write_bytes(np.random.default_rng(1).bytes(500))
        args = [str(path)]
    else:  # a (2, 1, 1, 1) file read as SlowFast-R50
        args = [_pkl(sf_state, tmp_path / "sf.pkl", "np2"), "--width", "8"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "avtex_torch.cli.import_slowfast", *args,
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 1
    assert "IMPORT FAILED" in out.stderr
    assert "Traceback" not in out.stderr + out.stdout
