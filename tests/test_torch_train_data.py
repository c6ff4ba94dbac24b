"""The port's training data path and loss against avtex's: the segment
sampler (avtex_torch/contrastive/segments.py), the batches and prefetch
(avtex_torch/data/pipeline.py), InfoNCE (avtex_torch/contrastive/
infonce.py) and the meters (avtex_torch/obs/meters.py).

The sampler and the batches are numpy on both sides: bit-exact under the
same ``np.random.Generator`` and the same ``(seed, epoch)``. InfoNCE agrees
within 1e-6 in fp32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtex.contrastive import infonce as jax_infonce
from avtex.contrastive import segments as jax_segments
from avtex.data import pipeline as jax_pipeline
from avtex.obs import meters as jax_meters
from avtex_torch.contrastive import infonce, segments
from avtex_torch.data import pipeline
from avtex_torch.obs import AverageMeter

torch.set_num_threads(1)


def _video(t=40, h=12, w=12, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (t, h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("n_total,n_negs", [(17, 4), (17, 8), (30, 20),
                                            (9, 7), (9, 2)])
def test_sample_negatives_bit_exact(n_total, n_negs):
    for idx in range(n_total):
        a = np.random.default_rng(idx)
        b = np.random.default_rng(idx)
        got = segments.sample_negatives(idx, n_total, n_negs, a)
        want = jax_segments.sample_negatives(idx, n_total, n_negs, b)
        np.testing.assert_array_equal(got, want)
        assert a.integers(1 << 30) == b.integers(1 << 30)  # same stream
        # the head of the draw is the hard negatives, truncated to n_negs
        hard = segments.hard_negative_ids(idx, n_total)[:n_negs]
        np.testing.assert_array_equal(got[:len(hard)], hard)
        assert idx not in got and idx + 1 not in got


@pytest.mark.parametrize("idx,max_id", [(0, 10), (3, 10), (9, 10), (10, 10),
                                        (2, 3)])
def test_segment_geometry_matches_avtex(idx, max_id):
    np.testing.assert_array_equal(segments.hard_negative_ids(idx, max_id),
                                  jax_segments.hard_negative_ids(idx, max_id))
    np.testing.assert_array_equal(segments.segment_frame_ids(idx, 15, 6),
                                  jax_segments.segment_frame_ids(idx, 15, 6))
    np.testing.assert_array_equal(
        segments.target_ordering(idx, max_id + 1),
        jax_segments.target_ordering(idx, max_id + 1))
    for split in ("train", "val"):
        np.testing.assert_array_equal(
            segments.segment_start_frames(60 + idx, 15, 6, split),
            jax_segments.segment_start_frames(60 + idx, 15, 6, split))


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("audio", [False, True])
@pytest.mark.parametrize("drop_last,batch_size,n_negs", [
    (False, 4, 4), (True, 4, 4), (False, 5, 8), (True, 3, 2)])
def test_segment_batches_bit_exact_over_two_epochs(audio, drop_last,
                                                   batch_size, n_negs):
    frames = _video()
    # fewer examples than segments: the last ones are clipped
    ex = (np.random.default_rng(1).standard_normal((12, 10, 8))
          .astype(np.float32) if audio else None)
    kw = dict(window=4, stride=2, n_negs=n_negs, batch_size=batch_size,
              audio_examples=ex, seed=3, drop_last=drop_last)
    port = pipeline.SegmentBatches(frames, **kw)
    ref = jax_pipeline.SegmentBatches(frames, **kw)
    assert len(port) == len(ref) and port.n_train == ref.n_train
    for epoch in (0, 1):
        got = list(port.epoch(epoch))
        _assert_same_batches(got, list(ref.epoch(epoch)))
        assert got[0]["q_frames"].dtype == np.uint8
        assert len(got) == len(port)
    # the stateful stream (no epoch given) too, twice in a row
    for _ in range(2):
        _assert_same_batches(list(port.epoch()), list(ref.epoch()))
    # replaying an epoch gives the same batches
    _assert_same_batches(list(port.epoch(1)), list(ref.epoch(1)))


def test_strided_source_frames_are_copied():
    frames = _video(80)[::2]
    a = pipeline.SegmentBatches(frames, 4, 2, n_negs=2, batch_size=2)
    assert a.frames.flags["C_CONTIGUOUS"]
    b = next(a.epoch(0))
    np.testing.assert_array_equal(b["t_frames"][0, 0],
                                  a.windows[b["q_ids"][0] + 1])


def test_prefetch_yields_in_order_and_relays_an_exception():
    assert list(pipeline.prefetch(iter(range(7)), depth=2)) == list(range(7))

    def failing():
        yield 1
        raise OSError("decode failed")

    got = []
    with pytest.raises(OSError, match="decode failed"):
        for item in pipeline.prefetch(failing()):
            got.append(item)
    assert got == [1]


@pytest.mark.parametrize("b,n,d", [(4, 5, 16), (2, 21, 2304)])
def test_info_nce_matches_avtex(b, n, d):
    g = np.random.default_rng(b)
    q = g.standard_normal((b, d)).astype(np.float32)
    t = g.standard_normal((b, n, d)).astype(np.float32)
    want = np.asarray(jax_infonce.cosine_logits(jnp.asarray(q),
                                                jnp.asarray(t), 0.1))
    got = infonce.cosine_logits(torch.from_numpy(q), torch.from_numpy(t),
                                0.1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    want = float(jax_infonce.info_nce_loss(jnp.asarray(q), jnp.asarray(t),
                                           0.1))
    got = float(infonce.info_nce_loss(torch.from_numpy(q),
                                      torch.from_numpy(t), 0.1))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    logits = g.standard_normal((b, n)).astype(np.float32) * 10
    want = float(jax_infonce.info_nce_from_logits(jnp.asarray(logits)))
    got = float(infonce.info_nce_from_logits(torch.from_numpy(logits)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


def test_info_nce_accumulates_in_fp32():
    q = torch.randn(3, 8, dtype=torch.bfloat16)
    t = torch.randn(3, 4, 8, dtype=torch.bfloat16)
    assert infonce.cosine_logits(q, t, 0.1).dtype == torch.float32
    assert infonce.info_nce_loss(q, t, 0.1).dtype == torch.float32


def test_meters_match_avtex():
    a, b = AverageMeter(), jax_meters.AverageMeter()
    for v, n in ((1.5, 2), (0.25, 3), (4.0, 1)):
        a.update(v, n)
        b.update(v, n)
    assert (a.val, a.avg, a.sum, a.count) == (b.val, b.avg, b.sum, b.count)
    a.reset()
    assert (a.val, a.avg, a.sum, a.count) == (0.0, 0.0, 0.0, 0)
