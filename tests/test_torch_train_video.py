"""The port's ``train_video`` (avtex_torch/train/loop.py) end to end, and
the SlowFast step-parity case's GroupNorm variance check; split from
tests/test_torch_train.py, whose helpers and cases these share, so that
neither file holds a ``--dist loadfile`` worker for long.

- ``test_flax_fast_variance_moves_avtex_gradients``: the clip of the
  SlowFast case on which flax's default GroupNorm variance cancels
  (tests/test_torch_train.py's docstring says why avtex runs that case
  with the two-pass variance).
- ``train_video``: resume from ``_latest`` replays the uninterrupted run
  bit for bit, the ``_best`` / ``_latest`` files (avtex reads them), early
  stop and ``start_epoch``, and its errors: a bf16 ResNet10 at 32 px
  (``tiny_cfg``), two or three epochs of three steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtex.train import checkpoint as jax_ckpt
from avtex_torch.config import Config
from avtex_torch.contrastive.model import ContrastiveTextures
from avtex_torch.convert import convert_params
from avtex_torch.data.pipeline import SegmentBatches
from avtex_torch.data.preprocess import preprocess_clip
from avtex_torch.nn.slowfast import slowfast_pathways
from avtex_torch.train import (TrainConfigError, restore_checkpoint,
                               train_video)
from test_torch_train import (CASES, SMALL_SF, JaxSF, _avtex_patches,
                              _avtex_run, _batches, _video)

torch.set_num_threads(1)


@pytest.fixture
def no_onednn():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.mark.usefixtures("no_onednn")
def test_flax_fast_variance_moves_avtex_gradients():
    """The clip of the SlowFast case's second batch on which flax's default
    GroupNorm variance cancels: from avtex's parameters after the first
    step, the port's encoder gradient agrees with avtex's two-pass one
    within 1e-4 of each tensor's largest element, and avtex's default one
    is off by over 1e-2."""
    _, states, _, _ = _avtex_run("slowfast")
    tree = jax.tree.map(np.asarray, dict(
        states[1].params["params"]["t_embedder"]["video_encoder"]))
    t = _batches(SegmentBatches, CASES["slowfast"], None)[1]["t_frames"]
    with torch.no_grad():
        slow, fast = slowfast_pathways(preprocess_clip(
            torch.from_numpy(np.ascontiguousarray(t[0, 4:5])), 32, True))
    slow, fast = slow.numpy(), fast.numpy()
    w = np.random.default_rng(4).standard_normal((1, 576)).astype(np.float32)
    port = ContrastiveTextures("slowfast", 1, dtype=torch.float32,
                               **SMALL_SF).q_embedder.video_encoder
    holder = torch.nn.Module()
    holder.add_module("enc", port)
    holder.load_state_dict(convert_params({"enc": tree}, holder))
    (port(torch.from_numpy(slow), torch.from_numpy(fast))
     * torch.from_numpy(w)).sum().backward()
    errs = {}
    for two_pass in (True, False):
        with pytest.MonkeyPatch.context() as mp:
            _avtex_patches(mp, two_pass)
            m = JaxSF(**SMALL_SF, dtype=jnp.float32)
            gj = jax.grad(lambda p: (m.apply({"params": p}, slow, fast)
                                     * w).sum())(tree)
        want = convert_params({"enc": jax.tree.map(np.asarray, gj)}, holder)
        errs[two_pass] = max(
            float((q.grad - want[n]).abs().max() / want[n].abs().max())
            for n, q in holder.named_parameters())
    assert errs[True] <= 1e-4 and errs[False] > 1e-2, errs



# ---- train_video ------------------------------------------------------- #

@pytest.fixture
def tiny_cfg():
    return Config(enc_arch="resnet10", model_type=1, img_size=32,
                  window=4, train_stride=2, stride=2, n_negs=4,
                  batch_size=4, lr=0.05, lr_steps=1, epochs=2, seed=0,
                  early_stop_loss=1e-9)


# 30 frames: 12 train queries, three batches of 4 an epoch
SPE = 3


@pytest.fixture
def tiny_video():
    return _video(t=30)


def test_resume_replays_the_uninterrupted_run(tmp_path, tiny_cfg,
                                              tiny_video):
    """Stop after epoch 2 of 3 and resume from _latest: the same losses,
    parameters, momentum and step, bit for bit (bf16 model, augmentation
    on, an LR boundary inside)."""
    full, full_hist = train_video(tiny_cfg, tiny_video, epochs=3,
                                  device="cpu")
    _, h1 = train_video(tiny_cfg, tiny_video, epochs=2, device="cpu",
                        ckpt_dir=str(tmp_path), ckpt_name="r")
    res, h2 = train_video(tiny_cfg, tiny_video, epochs=3, device="cpu",
                          resume=str(tmp_path / "r_latest"),
                          ckpt_dir=str(tmp_path), ckpt_name="r")
    assert len(h1) == 2 and len(h2) == 1
    assert h1 + h2 == full_hist
    assert res.step == full.step == 3 * SPE
    mom_a, mom_b = full.momentum(), res.momentum()
    for name, p in full.params.items():
        assert torch.equal(p, res.params[name]), name
        assert torch.equal(mom_a[name], mom_b[name]), name
    for (n, a), b in zip(full.model.named_parameters(),
                         res.model.parameters()):
        assert a.dtype == torch.bfloat16 or "GroupNorm" in n
        assert torch.equal(a, b), n


def test_best_and_latest_files(tmp_path, tiny_cfg, tiny_video):
    _, hist = train_video(tiny_cfg, tiny_video, device="cpu",
                          ckpt_dir=str(tmp_path), ckpt_name="b")
    assert (tmp_path / "b_latest").exists() and (tmp_path / "b_best").exists()
    payload = restore_checkpoint(str(tmp_path / "b_latest"))
    assert payload["epoch"] == 2 and payload["step"] == 2 * SPE
    assert payload["best_loss"] == pytest.approx(min(hist), rel=1e-6)
    assert int(payload["opt_state"]["1"]["1"]["count"]) == 2 * SPE
    # avtex reads the port's trained file without templates too
    assert jax_ckpt.restore_checkpoint(str(tmp_path / "b_best"),
                                       None)["arch"] == "resnet10"


def test_early_stop_and_start_epoch(tiny_cfg, tiny_video):
    cfg = dataclasses.replace(tiny_cfg, early_stop_loss=1e6)
    _, hist = train_video(cfg, tiny_video, epochs=10, device="cpu")
    assert len(hist) == 1
    cfg = dataclasses.replace(tiny_cfg, start_epoch=1)
    state, hist = train_video(cfg, tiny_video, epochs=3, device="cpu")
    assert len(hist) == 2 and state.step == 2 * SPE


def test_train_video_errors(tmp_path, tiny_cfg, tiny_video, monkeypatch):
    with pytest.raises(FileNotFoundError, match="No checkpoint"):
        train_video(tiny_cfg, tiny_video, epochs=1, device="cpu",
                    resume=str(tmp_path / "missing"))
    with pytest.raises(TrainConfigError, match="audio"):
        train_video(dataclasses.replace(tiny_cfg, model_type=2), tiny_video,
                    device="cpu")
    with pytest.raises(TrainConfigError, match="ckpt_name"):
        train_video(tiny_cfg, tiny_video, device="cpu",
                    ckpt_dir=str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_video(tiny_cfg, tiny_video)
