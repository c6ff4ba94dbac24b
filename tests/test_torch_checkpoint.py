"""avtex's checkpoint files in the port (avtex_torch/train/checkpoint.py,
its msgpack codec avtex_torch/train/_msgpack.py, export_params in
avtex_torch/convert.py) against avtex/train/checkpoint.py (flax msgpack).

- a file avtex writes, restored by the port and carried over by
  ``convert_params``, gives avtex's embeddings within 1e-4 (fp32; the
  frameworks sum convs in other orders);
- a file the port writes is byte-identical to avtex's for the same
  payload, and avtex's ``restore_checkpoint`` reads it back with
  bit-identical arrays and equal metadata;
- the codec decodes what ``msgpack`` encodes, and refuses truncated
  data, unknown extension codes, flax's chunked arrays and bfloat16.
"""

import os

import msgpack
import numpy as np
import pytest
import torch

import flax.serialization
import jax
import jax.numpy as jnp

from avtex.contrastive.model import ContrastiveTextures as JaxCT
from avtex.train import checkpoint as jax_ckpt
from avtex_torch.contrastive.model import ContrastiveTextures
from avtex_torch.convert import convert_params, export_params
from avtex_torch.train import _msgpack, restore_checkpoint, save_checkpoint

torch.set_num_threads(1)


def _clips(seed=0):
    return np.random.default_rng(seed).standard_normal(
        (2, 8, 32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def avtex_model():
    """avtex's resnet10 ContrastiveTextures in fp32 (group norm), its
    params and both towers' embeddings of two clips."""
    m = JaxCT(arch="resnet10", dtype=jnp.float32)
    x = _clips()
    params = jax.jit(m.init)(jax.random.key(1), x, x[:, None])
    params = jax.tree_util.tree_map(np.asarray, params)
    emb = {tower: np.asarray(jax.jit(
        lambda p, v, tower=tower: m.apply(p, v, method=m.embed,
                                          tower=tower))(params, x))
        for tower in ("query", "target")}
    return params, emb


def _port_model():
    return ContrastiveTextures(arch="resnet10", dtype=torch.float32).eval()


def _opt_state():
    return {"0": {"trace": {"w": np.arange(6, dtype=np.float32)}},
            "1": {"count": np.asarray(12, np.int32)}}


def test_avtex_file_restores_into_the_port(tmp_path, avtex_model):
    params, emb = avtex_model
    path = jax_ckpt.save_checkpoint(
        str(tmp_path), "run", params, epoch=7, arch="resnet10",
        best_loss=0.25, is_best=True, opt_state=_opt_state(), step=1234)
    payload = restore_checkpoint(path)
    assert (payload["epoch"], payload["arch"], payload["best_loss"],
            payload["step"]) == (7, "resnet10", 0.25, 1234)
    assert payload["opt_state"]["1"]["count"] == 12  # a plain tree
    model = _port_model()
    model.load_state_dict(convert_params(payload["state"], model))
    x = torch.from_numpy(_clips())
    with torch.no_grad():
        for tower, want in emb.items():
            np.testing.assert_allclose(
                model.embed(x, tower=tower).numpy(), want, rtol=1e-4,
                atol=1e-4)


def _tree_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k])
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and np.array_equal(x, y), k


def test_port_file_is_avtex_file(tmp_path, avtex_model):
    params, _ = avtex_model
    model = _port_model()
    model.load_state_dict(convert_params(params, model))
    tree = export_params(model.state_dict())
    _tree_equal(tree, params)  # the same tree, array for array
    port_path = save_checkpoint(str(tmp_path / "port"), "run", tree,
                                epoch=3, arch="resnet10", best_loss=0.5,
                                is_best=True, opt_state=_opt_state(),
                                step=99)
    avtex_path = jax_ckpt.save_checkpoint(
        str(tmp_path / "avtex"), "run", params, epoch=3, arch="resnet10",
        best_loss=0.5, is_best=True, opt_state=_opt_state(), step=99)
    assert os.path.basename(port_path) == os.path.basename(avtex_path)
    with open(port_path, "rb") as f, open(avtex_path, "rb") as g:
        assert f.read() == g.read()
    payload = jax_ckpt.restore_checkpoint(port_path, params, _opt_state())
    assert (payload["epoch"], payload["arch"], payload["best_loss"],
            payload["step"]) == (3, "resnet10", 0.5, 99)
    _tree_equal(jax.tree_util.tree_map(np.asarray, payload["state"]), tree)
    _tree_equal(payload["opt_state"], _opt_state())


def test_latest_and_best_paths(tmp_path):
    tree = {"params": {"w": np.ones(3, np.float32)}}
    got = save_checkpoint(str(tmp_path), "x", tree, 0, "a", 1.0, False)
    assert got == str(tmp_path / "x_latest")
    assert not (tmp_path / "x_best").exists()
    got = save_checkpoint(str(tmp_path), "x", tree, 1, "a", 0.5, True)
    assert got == str(tmp_path / "x_best")
    assert (tmp_path / "x_latest").read_bytes() == \
        (tmp_path / "x_best").read_bytes()
    assert restore_checkpoint(str(tmp_path / "absent")) is None


@pytest.mark.parametrize("obj", [
    {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
              2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
              -2**31, -2**31 - 1, -2**63]},
    {"f": [0.1, -2.5e300, 1.0], "b": [True, False, None]},
    {"s": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 70000,
           "é漢"], "bin": [b"", b"x" * 300, b"y" * 70000]},
    {str(i): {"nested": list(range(i))} for i in range(20)},
])
def test_codec_reads_what_msgpack_writes(obj):
    data = msgpack.packb(obj, use_bin_type=True)
    assert _msgpack.unpackb(data) == msgpack.unpackb(data, raw=False)
    assert _msgpack.unpackb(_msgpack.packb(obj)) == obj


def test_codec_reads_float32_and_flax_arrays():
    data = msgpack.packb({"x": 1.5, "y": [0.25]}, use_single_float=True)
    assert data[3] == 0xCA  # float 32
    assert _msgpack.unpackb(data) == {"x": 1.5, "y": [0.25]}
    arrays = {"a": np.arange(24, dtype=np.int16).reshape(2, 3, 4),
              "b": np.zeros((0, 5), np.float64),
              "c": np.float32(2.5), "d": np.ones((1,), np.uint8),
              "e": np.arange(3, dtype=np.float16)}
    out = _msgpack.unpackb(flax.serialization.msgpack_serialize(arrays))
    for k, v in arrays.items():
        assert np.asarray(out[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(out[k], v)


def test_codec_refusals(tmp_path, monkeypatch):
    good = flax.serialization.msgpack_serialize(
        {"state": {"w": np.ones(10, np.float32)}, "epoch": 1})
    for cut in (1, 5, len(good) // 2, len(good) - 1):
        with pytest.raises(ValueError, match="truncated"):
            _msgpack.unpackb(good[:cut])
    with pytest.raises(ValueError, match="trailing"):
        _msgpack.unpackb(good + b"\x00")
    for code in (7, 2):  # 2: flax's complex, which no checkpoint holds
        with pytest.raises(ValueError, match=f"ext code {code}"):
            _msgpack.unpackb(msgpack.packb(
                {"x": msgpack.ExtType(code, b"ab")}))
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 16)
    chunked = flax.serialization.msgpack_serialize(
        {"w": np.ones(10, np.float32)})
    with pytest.raises(ValueError, match="chunked"):
        _msgpack.unpackb(chunked)
    bf16 = flax.serialization.msgpack_serialize(
        {"w": jnp.ones(3, jnp.bfloat16)})
    with pytest.raises(ValueError, match="bfloat16"):
        _msgpack.unpackb(bf16)
    path = tmp_path / "cut_latest"
    path.write_bytes(good[:-3])
    with pytest.raises(ValueError, match="truncated"):
        restore_checkpoint(str(path))
    path.write_bytes(msgpack.packb({"epoch": 1}))
    with pytest.raises(ValueError, match="not an avtex checkpoint"):
        restore_checkpoint(str(path))
    with pytest.raises(TypeError, match="str"):
        _msgpack.packb({1: 2})
    with pytest.raises(TypeError, match="cannot write"):
        _msgpack.packb({"x": object()})
