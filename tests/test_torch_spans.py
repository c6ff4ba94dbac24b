"""The port's program spans (avtex_torch/obs/spans.py): the no-op with no
profiler, ids under nesting and across threads, the clock against the
profiler's own ranges, the ring's bound, and the spans the embed, the
train step and the batch pipeline record. No JAX: the ``cuda`` case runs
on the card with
``python -m pytest --noconftest -q tests/test_torch_spans.py``.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from avtex_torch.config import Config
from avtex_torch.contrastive.model import ContrastiveTextures
from avtex_torch.data.pipeline import SegmentBatches, prefetch
from avtex_torch.nn.slowfast import STEMS_RANGE, SlowFastR50
from avtex_torch.obs import spans
from avtex_torch.synth.embeddings import precompute_embeddings_from_video
from avtex_torch.train.loop import (create_state, make_train_step,
                                    step_generator)

ALL = (0, 2 ** 63 - 1)
TRAIN_CHILDREN = ["train.upload", "train.draws", "train.augment",
                  "train.forward", "train.backward", "train.optimizer"]


@pytest.fixture
def ring(monkeypatch):
    """A fresh ring of 64 spans in the module's place."""
    fresh = spans.Ring(64)
    monkeypatch.setattr(spans, "RING", fresh)
    return fresh


@pytest.fixture
def recording(monkeypatch, ring):
    """Spans record as under a profiler, with no profiler's ranges: the
    process-wide flag on, no thread's profiler state."""
    monkeypatch.setattr(autograd_profiler, "_is_profiler_enabled", True)
    return ring


def _video(t=40, size=32, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (t, size, size, 3), dtype=np.uint8)


def _range_events(prof, name):
    """The host ranges named ``name`` (on CUDA a range is mirrored on
    the device's timeline too)."""
    host = torch.autograd.DeviceType.CPU
    return [e for e in prof.profiler.kineto_results.events()
            if e.name() == name and e.device_type() == host]


def test_no_profiler_records_nothing(ring):
    assert not autograd_profiler._is_profiler_enabled
    ctx = spans.span("idle", a=1)
    assert ctx is spans.NOOP and spans.span("other") is ctx
    with ctx as entered:
        assert entered is None
    assert ring.collect(*ALL) == []


def test_nesting_gives_parent_thread_and_root(recording):
    with spans.span("outer", k=1):
        with spans.span("mid"):
            with spans.span("inner"):
                pass
        with spans.span("sibling"):
            pass
    with spans.span("next"):
        pass
    got = {s.name: s for s in recording.collect(*ALL)}
    assert [s.name for s in recording.collect(*ALL)] == [
        "inner", "mid", "sibling", "outer", "next"]
    outer = got["outer"]
    assert outer.parent is None and outer.root == outer.id
    assert outer.attrs == {"k": 1}
    assert got["mid"].parent == outer.id and got["sibling"].parent == outer.id
    assert got["inner"].parent == got["mid"].id
    assert {got[n].root for n in ("mid", "inner", "sibling")} == {outer.id}
    assert got["next"].root == got["next"].id != outer.id
    assert {s.thread for s in got.values()} == {threading.get_ident()}
    for s in got.values():
        assert s.start_ns <= s.end_ns
    assert outer.start_ns <= got["mid"].start_ns <= got["inner"].start_ns
    assert got["inner"].end_ns <= got["mid"].end_ns <= outer.end_ns


def test_ring_keeps_the_last_spans_up_to_its_bound(recording):
    for i in range(100):
        with spans.span("s", i=i):
            pass
    kept = recording.collect(*ALL)
    assert len(kept) == 64
    assert [s.attrs["i"] for s in kept] == list(range(36, 100))
    recording.clear()
    assert recording.collect(*ALL) == []


def test_collect_keeps_spans_wholly_inside_the_interval(recording):
    with spans.span("a"):
        pass
    (a,) = recording.collect(*ALL)
    assert recording.collect(a.start_ns, a.end_ns) == [a]
    assert recording.collect(a.start_ns + 1, a.end_ns) == []
    assert recording.collect(a.start_ns, a.end_ns - 1) == []


def test_threads_keep_their_own_nesting(recording, monkeypatch):
    """Threads open spans at once (a short switch interval interleaves
    them): every span's parent is on its own thread, none is lost."""
    workers, per = 8, 50
    ring = spans.Ring(2 * workers * per)
    monkeypatch.setattr(spans, "RING", ring)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(k):
        for i in range(per):
            with spans.span("root", worker=k):
                with spans.span("child", worker=k):
                    pass

    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    got = ring.collect(*ALL)
    assert len(got) == 2 * workers * per
    by_id = {s.id: s for s in got}
    assert len(by_id) == len(got)
    for s in got:
        if s.name == "child":
            parent = by_id[s.parent]
            assert parent.name == "root" and parent.thread == s.thread
            assert parent.attrs == s.attrs and s.root == parent.id
        else:
            assert s.parent is None


def test_thread_started_before_the_profiler_is_recorded(ring):
    """The profiler records nothing on such a thread; the ring does."""
    go, done = threading.Event(), threading.Event()

    def work():
        go.wait(timeout=30)
        with spans.span("on.thread", n=3):
            time.sleep(0.001)
        done.set()

    t = threading.Thread(target=work)
    t.start()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        go.set()
        assert done.wait(timeout=30)
    t.join(timeout=30)
    (s,) = ring.collect(*ALL)
    assert (s.name, s.attrs, s.thread) == ("on.thread", {"n": 3}, t.ident)
    assert s.end_ns - s.start_ns >= 1_000_000
    assert _range_events(prof, "on.thread") == []


def _clock_gaps(activities, block):
    """Per repeat, the larger of the start and end gaps (ns) between a
    span and the profiler's range of the same name."""
    with profile(activities=activities) as prof:
        with spans.span("warm-up"):  # the first range pays a set-up
            block()
        for i in range(20):
            with spans.span(f"clock.{i}"):
                block()
    got = {s.name: s for s in spans.collect(*ALL)
           if s.name.startswith("clock.")}
    gaps = []
    for i in range(20):
        (e,) = _range_events(prof, f"clock.{i}")
        s = got[f"clock.{i}"]
        gaps.append(max(abs(s.start_ns - e.start_ns()),
                        abs(s.end_ns - e.end_ns())))
    return gaps


def _calmest_median_gap(activities, block, tries=5):
    """The lowest median of ``_clock_gaps`` over up to ``tries``
    measurements half a second apart, each on a fresh ring. A thread that
    a busy host (or its hypervisor) deschedules between a range's stamp
    and its span's widens every gap of that measurement alike: that is
    the host's load, not a second clock."""
    medians = []
    for k in range(tries):
        if k:
            time.sleep(0.5)
        spans.clear()
        medians.append(float(np.median(_clock_gaps(activities, block))))
        if medians[-1] < 100_000:
            break
    return min(medians), medians


def test_span_shares_the_profilers_clock(ring):
    """A span and the range it opens agree within 100 us (median of 20;
    the ranges' own clock is Kineto's)."""
    best, medians = _calmest_median_gap(
        [ProfilerActivity.CPU],
        lambda: torch.randn(64, 64) @ torch.randn(64, 64))
    assert best < 100_000, medians


@pytest.mark.cuda
def test_span_shares_the_profilers_clock_on_cuda(ring):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x = torch.randn(1024, 1024, device="cuda")
    best, medians = _calmest_median_gap(
        [ProfilerActivity.CPU, ProfilerActivity.CUDA],
        lambda: torch.mm(x, x))
    torch.cuda.synchronize()
    assert best < 100_000, medians


def test_existing_stems_range_stays_in_the_profile(ring):
    model = SlowFastR50(width=8, layers=(1, 1, 1, 1),
                        dtype=torch.float32).eval()
    slow = torch.rand(1, 4, 32, 32, 3)
    fast = torch.rand(1, 16, 32, 32, 3)
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        model(slow, fast)
    assert len(_range_events(prof, STEMS_RANGE)) == 1
    assert [s.name for s in ring.collect(*ALL)] == [STEMS_RANGE]


def test_embed_records_upload_preprocess_and_towers(ring):
    model = ContrastiveTextures("resnet10", 1, 0.1, dtype=torch.float32,
                                width=8).eval()
    with profile(activities=[ProfilerActivity.CPU]):
        q, _ = precompute_embeddings_from_video(model, _video(), 4, 2, 17,
                                                img_size=32, batch_size=8)
    assert len(q) == 17
    got = ring.collect(*ALL)
    (video,) = [s for s in got if s.name == "embed.video"]
    # 17 segments in batches of 8: 3 batches, 7 padded rows
    assert video.attrs == {"segments": 17, "padded_rows": 7}
    children = sorted((s for s in got if s is not video),
                      key=lambda s: s.start_ns)
    assert [s.name for s in children] == ["embed.upload"] + [
        "embed.preprocess", "embed.towers"] * 3
    assert all(s.parent == video.id == s.root for s in children)


def test_train_step_records_its_phases_in_order(recording):
    video = _video()
    cfg = Config(enc_arch="resnet10", img_size=32, window=4, stride=2,
                 train_stride=2, batch_size=2, n_negs=2,
                 compute_dtype="float32")
    model = ContrastiveTextures("resnet10", 1, 0.1, dtype=torch.float32,
                                remat=True, width=8)
    data = SegmentBatches(video, 4, 2, n_negs=2, batch_size=2)
    state = create_state(model, cfg, len(data))
    step = make_train_step(model, 32, False, augment=True)
    batches = data.epoch(0)
    for k in range(2):
        state, _ = step(state, next(batches), step_generator(0, k))
    got = recording.collect(*ALL)
    roots = [s for s in got if s.name == "train.step"]
    assert [s.attrs for s in roots] == [{"step": 0}, {"step": 1}]
    for root in roots:
        children = sorted((s for s in got if s.parent == root.id),
                          key=lambda s: s.start_ns)
        assert [s.name for s in children] == TRAIN_CHILDREN
        assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
                   for s in children)


def test_train_step_without_augmentation_draws_nothing(recording):
    video = _video()
    cfg = Config(enc_arch="resnet10", img_size=32, window=4, stride=2,
                 train_stride=2, batch_size=2, n_negs=2,
                 compute_dtype="float32")
    model = ContrastiveTextures("resnet10", 1, 0.1, dtype=torch.float32,
                                width=8)
    data = SegmentBatches(video, 4, 2, n_negs=2, batch_size=2)
    state = create_state(model, cfg, len(data))
    step = make_train_step(model, 32, False, augment=False)
    step(state, next(data.epoch(0)), step_generator(0, 0))
    names = [s.name for s in sorted(recording.collect(*ALL),
                                    key=lambda s: s.start_ns)
             if s.name.startswith("train.")]
    assert names == ["train.step"] + [
        n for n in TRAIN_CHILDREN if n != "train.draws"]


class _Sink:
    """A stand-in state with ``apply_gradients`` alone (no step count),
    as an A/B that compares variants from the same parameters uses."""

    def __init__(self, model):
        self.model, self.applied = model, 0

    def apply_gradients(self, grad_hook=None):
        self.applied += 1
        self.model.zero_grad(set_to_none=True)


@pytest.mark.parametrize("on", [False, True], ids=["off", "recording"])
def test_train_step_takes_a_state_without_a_step_count(ring, monkeypatch,
                                                        on):
    if on:
        monkeypatch.setattr(autograd_profiler, "_is_profiler_enabled", True)
    model = ContrastiveTextures("resnet10", 1, 0.1, dtype=torch.float32,
                                width=8)
    data = SegmentBatches(_video(), 4, 2, n_negs=2, batch_size=2)
    sink = _Sink(model)
    step = make_train_step(model, 32, False, augment=False)
    _, m = step(sink, next(data.epoch(0)), step_generator(0, 0))
    assert sink.applied == 1 and torch.isfinite(m["loss"])
    roots = [s for s in ring.collect(*ALL) if s.name == "train.step"]
    assert [s.attrs for s in roots] == ([{"step": None}] if on else [])


def test_prefetch_records_gathers_and_waits(recording):
    """The producer is held until the consumer has begun its first wait,
    so that wait finds the queue empty; once all is gathered, the waits
    find what is left."""
    data = SegmentBatches(_video(), 4, 2, n_negs=3, batch_size=5,
                          audio_examples=np.zeros((30, 10, 64), np.float32))
    gate, gathered = threading.Event(), threading.Event()
    timer = threading.Timer(0.2, gate.set)

    def held():
        gate.wait(timeout=30)
        yield from data.epoch(4)
        gathered.set()

    timer.start()
    it = prefetch(held(), depth=len(data) + 1)
    batches = [next(it)]
    assert gathered.wait(timeout=30)
    batches += list(it)
    timer.join(timeout=30)
    got = recording.collect(*ALL)
    gathers = [s for s in got if s.name == "data.gather"]
    assert [(s.attrs["epoch"], s.attrs["batch"]) for s in gathers] == [
        (4, k) for k in range(len(data))]
    for s, b in zip(gathers, batches):
        assert s.attrs["bytes"] == sum(a.nbytes for a in b.values())
        assert s.thread != threading.get_ident() and s.parent is None
    waits = sorted((s for s in got if s.name == "data.wait"),
                   key=lambda s: s.start_ns)
    queued = [s.attrs["queued"] for s in waits]
    # one wait a batch, and one for the end of the stream
    assert len(waits) == len(data) + 1
    assert queued[0] == 0
    assert queued[1] >= len(data) - 1
    assert queued[1:] == sorted(queued[1:], reverse=True)
