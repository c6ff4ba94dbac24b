"""``gpubench/program_spans.py`` and the readers built on it, on hand-made
device events and program spans: device ms by launch inside a span, idle
cut by the spans' own intervals, the window's filter, the per-span
divisors, and silence where the program records no spans."""

import sys
import types

import pytest

from avtex_torch.obs import spans as program
from gpubench import program_spans, spec
from gpubench.trace import TraceSummary

MS = 1_000_000  # ns


def _span(name, start, end, id, parent=None, root=None, thread=1,
          **attrs):
    return program.Span(name, start * MS, end * MS, id, parent,
                        id if root is None else root, thread, attrs)


def _trace(window, ops):
    """A trace summary of ``ops``: (start, end, launch) in ms, each a
    device operation with its runtime call at ``launch`` (None: no call
    recorded)."""
    t = TraceSummary.__new__(TraceSummary)
    t.window = (window[0] * MS, window[1] * MS)
    t.window_s = (window[1] - window[0]) / 1e3
    t.device, t.launches, t.ranges = [], {}, []
    for corr, (start, end, launch) in enumerate(ops):
        t.device.append((start * MS, end * MS, f"k{corr}", corr))
        if launch is not None:
            t.launches[corr] = launch * MS
    t.device.sort()
    return t


@pytest.fixture
def ring(monkeypatch):
    fresh = program.Ring(64)
    monkeypatch.setattr(program, "RING", fresh)
    return fresh


def test_device_ms_counts_operations_by_their_launch():
    trace = _trace((0, 100), [(12, 20, 11),   # launched inside a
                              (30, 45, 19),   # inside a, runs past its end
                              (50, 52, 25),   # launched inside b
                              (60, 61, None),  # no launch recorded
                              (70, 74, 65)])  # inside the second a
    spans = [_span("a", 10, 20, 1), _span("a", 64, 66, 2),
             _span("b", 24, 26, 3)]
    assert program_spans.device_ms(trace, spans, "a") == 8 + 15 + 4
    assert program_spans.device_ms(trace, spans, "b") == 2
    assert program_spans.device_ms(trace, spans, "c") == 0


def test_idle_is_cut_by_the_spans_own_intervals():
    # busy [0, 5] and [15, 20]; the gap [5, 15] straddles a -> b
    trace = _trace((0, 30), [(0, 5, 0), (15, 20, 14)])
    spans = [_span("a", 0, 10, 1), _span("b", 10, 20, 2),
             _span("a", 25, 28, 3)]
    assert program_spans.idle_intervals(trace) == [
        (5 * MS, 15 * MS), (20 * MS, 30 * MS)]
    assert program_spans.idle_ms(trace, spans, "a") == 5 + 3
    assert program_spans.idle_ms(trace, spans, "b") == 5


def test_idle_by_innermost_splits_gaps_by_nesting():
    trace = _trace((0, 40), [(2, 4, 1), (12, 30, 11)])
    spans = [_span("step", 0, 20, 1), _span("fwd", 5, 10, 2, 1, 1),
             _span("inner", 6, 8, 3, 2, 1), _span("opt", 10, 12, 4, 1, 1),
             _span("other", 0, 40, 5, thread=2)]
    assert program_spans.innermost(spans, 1) == [
        (0, 5 * MS, "step"), (5 * MS, 6 * MS, "fwd"),
        (6 * MS, 8 * MS, "inner"), (8 * MS, 10 * MS, "fwd"),
        (10 * MS, 12 * MS, "opt"), (12 * MS, 20 * MS, "step")]
    idle = program_spans.idle_by_innermost(trace, spans, 1)
    # idle: [0, 2], [4, 12], [30, 40]
    assert idle == pytest.approx({"step": 2 + 1, "fwd": 1 + 2, "inner": 2,
                                  "opt": 2, "no span": 10})
    assert sum(idle.values()) == pytest.approx(20)


def test_window_keeps_only_spans_wholly_inside(ring):
    for s in (_span("a", 5, 15, 1), _span("a", 12, 18, 2),
              _span("a", 18, 30, 3), _span("a", 25, 35, 4)):
        ring.append(s)
    trace = _trace((10, 30), [])
    assert [s.id for s in program_spans.window_spans(trace)] == [2, 3]
    assert program_spans.window_spans(None) is None


def _ctx(trace, **work):
    return types.SimpleNamespace(trace=trace, work=work, spans={},
                                 window_s=trace.window_s)


def _reader(name):
    return spec.load_module("metrics", name)


def test_embed_readers_divide_by_the_videos(ring):
    trace = _trace((0, 100), [(2, 3, 1), (4, 10, 3), (11, 20, 5),
                              (30, 31, 26), (32, 40, 28), (41, 45, 29)])
    for s in (_span("embed.video", 0, 24, 1),
              _span("embed.upload", 0, 2, 2),
              _span("embed.preprocess", 2, 4, 3),
              _span("embed.towers", 4, 24, 4),
              _span("embed.video", 25, 50, 5),
              _span("embed.preprocess", 25, 27, 6),
              _span("embed.towers", 27, 30, 7)):
        ring.append(s)
    ctx = _ctx(trace, videos=2)
    assert _reader("preprocess_ms.embed").read(ctx) == (6 + 1) / 2
    assert _reader("towers_ms.embed").read(ctx) == (9 + 8 + 4) / 2


def test_train_readers_divide_by_the_steps(ring):
    trace = _trace((0, 100), [(1, 3, 1), (5, 9, 3), (10, 12, 5),
                              (13, 14, 9), (21, 24, 21), (25, 27, 24),
                              (31, 32, 30)])
    for s in (_span("train.step", 0, 15, 1),
              _span("train.augment", 0, 2, 2),
              _span("train.forward", 2, 4, 3),
              _span("train.backward", 4, 8, 4),
              _span("train.optimizer", 8, 14, 5),
              _span("data.wait", 16, 20, 6, queued=0),
              _span("train.step", 20, 35, 7),
              _span("train.forward", 20, 23, 8),
              _span("train.backward", 23, 29, 9),
              _span("train.optimizer", 29, 34, 10),
              _span("data.wait", 36, 37, 11, queued=2),
              _span("data.gather", 3, 7, 12, thread=2),
              _span("data.gather", 8, 10, 13, thread=2)):
        ring.append(s)
    ctx = _ctx(trace, steps=2)
    assert _reader("augment_ms.train").read(ctx) == 2 / 2
    assert _reader("forward_ms.train").read(ctx) == (4 + 3) / 2
    assert _reader("backward_ms.train").read(ctx) == (2 + 2) / 2
    assert _reader("optimizer_ms.train").read(ctx) == (1 + 1) / 2
    # idle in the steps: [0, 1], [3, 5], [9, 10], [12, 13], [14, 15];
    # [20, 21], [24, 25], [27, 31], [32, 35]; none of the wait's [16, 20]
    assert _reader("step_idle_ms.train").read(ctx) == (6 + 9) / 2
    assert _reader("gather_ms.train").read(ctx) == (4 + 2) / 2
    assert _reader("queue_empty_share.train").read(ctx) == 50.0


NEW = ["preprocess_ms.embed", "towers_ms.embed", "augment_ms.train",
       "forward_ms.train", "backward_ms.train", "optimizer_ms.train",
       "step_idle_ms.train", "gather_ms.train", "queue_empty_share.train"]


@pytest.mark.parametrize("metric", NEW)
def test_readers_are_silent_without_spans(ring, monkeypatch, metric):
    trace = _trace((0, 100), [(1, 2, 1)])
    reader = _reader(metric)
    assert reader.read(_ctx(trace, videos=1, steps=1)) is None
    assert reader.read(types.SimpleNamespace(trace=None, work={})) is None
    # a program without the span module (an older checkout)
    monkeypatch.setitem(sys.modules, "avtex_torch.obs.spans", None)
    monkeypatch.delattr(sys.modules["avtex_torch.obs"], "spans")
    assert program_spans.window_spans(trace) is None
    assert reader.read(_ctx(trace, videos=1, steps=1)) is None
