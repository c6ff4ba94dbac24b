"""``avtex_torch.obs.trace`` (the port of avtex/obs/profiler.py): a
torch.profiler block that writes a Chrome trace into ``logdir``, and
nothing at all with ``logdir=None``."""

import json
import os

import torch

from avtex_torch.obs import trace

torch.set_num_threads(1)


def _work():
    x = torch.randn(64, 64)
    return (x @ x).relu().sum()


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "profiles"
    with trace(str(logdir), name="embed_batch"):
        _work()
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].startswith("embed_batch.")
    assert files[0].endswith(".pt.trace.json")
    with open(logdir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "embed_batch" in names  # the block's range
    assert any(n and "mm" in n for n in names)  # the ops inside it
    with trace(str(logdir), name="embed_batch"):  # a second file
        _work()
    assert len(os.listdir(logdir)) == 2


def test_trace_without_logdir_does_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with trace(None):
        out = _work()
    assert torch.isfinite(out) and os.listdir(tmp_path) == []
    assert not torch.autograd.profiler._is_profiler_enabled
