"""The port's VGGish (avtex_torch/nn/vggish.py) and its checkpoint loader
(avtex_torch/checkpoints.py) against avtex's (avtex/nn/vggish.py,
avtex/utils/convert.py).

- full width (64/128/256/256/512/512 channels on [100, 64] patches) in
  fp32 on 3 examples, from avtex's parameters carried across by
  ``convert_params``: max |diff| <= 1e-4 max |ref| (fp32 convolutions
  summed in another order; a wrong flatten order or layout would move
  whole features, not rounding);
- 12288 features per example;
- ``pytorch_vggish.pth`` written by the test under the reference's key
  names (fc head and a trailing 4-D tensor included): the port's loader
  takes the same six convs as avtex's ``convert_vggish`` and drops the
  rest; without a file both warn and keep the weights.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avtex.nn import vggish as jax_vggish
from avtex.utils import convert as jax_convert
from avtex_torch import checkpoints
from avtex_torch.convert import convert_params, export_params
from avtex_torch.nn.vggish import VGGish, vggish_feat_dim

torch.set_num_threads(1)


def _avtex_params(seed=0):
    """avtex VGGish params as numpy, drawn directly (no init compile):
    lecun-scaled kernels and non-zero biases."""
    shapes = jax.eval_shape(jax_vggish.VGGish(dtype=jnp.float32).init,
                            jax.random.key(0), jnp.zeros((1, 100, 64)))
    g = np.random.default_rng(seed)

    def draw(path, s):
        if path[-1].key == "bias":
            return (0.05 * g.standard_normal(s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (g.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
            np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _examples(n, seed=1):
    g = np.random.default_rng(seed)
    return (g.standard_normal((n, 100, 64)) - 2.0).astype(np.float32)


def test_feature_dim():
    assert vggish_feat_dim() == jax_vggish.vggish_feat_dim() == 12288
    assert vggish_feat_dim(96, 64) == jax_vggish.vggish_feat_dim(96, 64)
    out = VGGish(torch.float32)(torch.zeros(2, 100, 64))
    assert tuple(out.shape) == (2, 12288) and out.dtype == torch.float32


def test_full_width_fp32_matches_avtex():
    jparams = _avtex_params()
    x = _examples(3)
    want = np.asarray(jax_vggish.VGGish(dtype=jnp.float32).apply(
        jparams, jnp.asarray(x)))
    model = VGGish(torch.float32)
    model.load_state_dict(convert_params(jparams, model))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        # avtex's channels-last [B, frames, bands, 1] input too
        got4 = model(torch.from_numpy(x[..., None])).numpy()
    assert got.shape == want.shape == (3, 12288)
    scale = np.abs(want).max()
    assert scale > 0 and (want > 0).mean() > 0.05
    assert np.abs(got - want).max() <= 1e-4 * scale
    np.testing.assert_array_equal(got, got4)
    # the parameters go back to avtex's tree unchanged
    back = export_params(model.state_dict())["params"]
    for k, leaves in jparams["params"].items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(back[k][leaf], v)


def test_bf16_module_keeps_avtex_s_dtype_contract():
    model = VGGish()
    assert model.Conv_0.weight.dtype == torch.bfloat16
    out = model(torch.from_numpy(_examples(1)))
    assert out.dtype == torch.float32 and out.shape == (1, 12288)


def _reference_file(tmp_path, seed=3):
    """A pytorch_vggish.pth under the reference's names: six feature
    convs, an fc head, and one more 4-D tensor that must be dropped."""
    src = VGGish(torch.float32)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in src.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    state = checkpoints.vggish_reference_state(src)
    state.update({"embeddings.0.weight": torch.randn(32, 48, generator=g),
                  "embeddings.0.bias": torch.randn(32, generator=g),
                  "embeddings.2.weight": torch.randn(8, 32, generator=g),
                  "extra.weight": torch.randn(4, 4, 3, 3, generator=g)})
    path = str(tmp_path / "pytorch_vggish.pth")
    torch.save(state, path)
    return path, src


def test_pth_loader_matches_convert_vggish(tmp_path):
    path, src = _reference_file(tmp_path)
    assert list(checkpoints.vggish_reference_state(src))[:4] == [
        "features.0.weight", "features.0.bias", "features.3.weight",
        "features.3.bias"]
    jparams = _avtex_params(seed=5)
    want = jax_convert.convert_vggish(jax_convert.load_torch_state(path),
                                      jparams)
    model = VGGish(torch.float32)
    start = convert_params(jparams, model)
    got, loaded = checkpoints.maybe_load_vggish(start, path, context="test")
    assert loaded
    mine = convert_params(want, model)
    assert sorted(got) == sorted(mine)
    for k in got:
        torch.testing.assert_close(got[k], mine[k], rtol=0, atol=0)
    for k, v in src.state_dict().items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)


def test_pth_loader_refuses_a_wrong_file(tmp_path):
    state = checkpoints.vggish_reference_state(VGGish(torch.float32))
    state["features.3.weight"] = torch.zeros(128, 64, 5, 5)
    torch.save(state, tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoints.maybe_load_vggish(VGGish(torch.float32).state_dict(),
                                      str(tmp_path / "bad.pth"))
    del state["features.13.weight"]
    torch.save(state, tmp_path / "short.pth")
    with pytest.raises(ValueError, match="conv count"):
        checkpoints.maybe_load_vggish(VGGish(torch.float32).state_dict(),
                                      str(tmp_path / "short.pth"))


def test_without_a_file_both_warn(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("AVTEX_VGGISH_CKPT", raising=False)
    start = VGGish(torch.float32).state_dict()
    got, loaded = checkpoints.maybe_load_vggish(start, context="here")
    assert not loaded
    assert all(torch.equal(got[k], start[k]) for k in start)
    _, jloaded = jax_convert.maybe_load_vggish(_avtex_params(),
                                               context="here")
    assert not jloaded
    err = capsys.readouterr().err
    assert err.count("no pytorch_vggish.pth found (here)") == 2
    assert "RANDOM weights" in err


def test_graft_into_a_model_state(tmp_path, monkeypatch):
    from avtex_torch.contrastive.model import ContrastiveTextures
    path, src = _reference_file(tmp_path)
    monkeypatch.setenv("AVTEX_VGGISH_CKPT", path)
    model = ContrastiveTextures("slowfast", 2, width=8, layers=(1, 1, 1, 1),
                                norm="affine", dtype=torch.float32)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    got, loaded = checkpoints.maybe_load_vggish_into_model(state)
    assert loaded
    for k, v in src.state_dict().items():
        assert torch.equal(got["audio_encoder." + k], v)
    assert all(torch.equal(got[k], state[k]) for k in state
               if not k.startswith("audio_encoder."))
    video_only = ContrastiveTextures("slowfast", 1, width=8,
                                     layers=(1, 1, 1, 1), norm="affine")
    _, loaded = checkpoints.maybe_load_vggish_into_model(
        video_only.state_dict())
    assert not loaded
