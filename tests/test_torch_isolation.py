"""avtex_torch stands alone: it imports neither jax, flax, msgpack nor
avtex, and its entry points do not fall back to the CPU on their own."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "avtex_torch"

_PROBE = r"""
import importlib, pkgutil, sys
import avtex_torch
names = [m.name for m in pkgutil.walk_packages(avtex_torch.__path__,
                                               "avtex_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack",
                                    "avtex"))
print(len(names), bad)
assert not bad, bad
for name in ("avtex_torch.audio.mel", "avtex_torch.audio.params",
             "avtex_torch.nn.vggish", "avtex_torch.train.loop",
             "avtex_torch.data.pipeline", "avtex_torch.contrastive.infonce",
             "avtex_torch.obs.meters"):
    assert name in names, name
"""


def test_import_pulls_in_no_jax_flax_or_avtex():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 20  # every submodule was imported


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in list(PORT.rglob("*.py"))
    + [REPO / "chip_smoke.py"]))
def test_no_source_imports_avtex(path):
    text = (REPO / path).read_text()
    assert not re.search(r"^\s*(from|import)\s+(avtex|jax|flax)\b(?!_torch)",
                         text, re.M), path


def test_entry_points_without_device_raise_on_a_cpu_only_machine(
        monkeypatch):
    from avtex_torch.config import Config
    from avtex_torch.device import resolve_device
    from avtex_torch.synth import TextureServer, synthesize_frames
    from avtex_torch.train import train_video

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frames = np.zeros((40, 16, 16, 3), np.uint8)
    cfg = Config(enc_arch="slowfast", norm="affine", img_size=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TextureServer.from_frames(cfg, frames, 8.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthesize_frames(cfg, frames, 8.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_video(Config(enc_arch="resnet10", img_size=16, window=4,
                           stride=2), frames)
    assert resolve_device("cpu").type == "cpu"
