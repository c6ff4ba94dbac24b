"""Host-side training batches (the port of avtex/data/pipeline.py).

A zero-copy windowing sampler and a prefetch thread. The host only slices
uint8 windows out of the decoded video (a stride-tricks view, then one
gather per batch); the consumer uploads them and does all float work on
the device (avtex_torch/data/preprocess.py).

Batch contract (numpy, uint8 frames):
  q_frames  [B, W, H, W_px, 3]         query windows
  t_frames  [B, 1+negs, W, H, W_px, 3] positive at index 0, then negatives
  q_audio   [B, mel_frames, 64]        query segment's log-mel example
  t_audio   [B, 1+negs, mel_frames, 64]
  q_ids     [B] int64
The positive of query i is i + 1; hard negatives overwrite the head of
the random draw; each segment takes one audio example, clipped to the
last one available. The same ``seed`` and ``epoch`` give avtex's batches
bit for bit.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from avtex_torch.contrastive.segments import (gather_windows,
                                              require_segments,
                                              sample_negatives)
from avtex_torch.obs.spans import span


class SegmentBatches:
    """Iterable over epochs of contrastive training batches."""

    def __init__(self, frames: np.ndarray, window: int, stride: int,
                 n_negs: int = 20, batch_size: int = 8,
                 audio_examples: Optional[np.ndarray] = None,
                 seed: int = 0, drop_last: bool = False) -> None:
        # a contiguous copy, so the window view never aliases a strided
        # source such as frames[::k]
        self.frames = np.ascontiguousarray(frames)
        self.window = window
        self.stride = stride
        self.n_negs = n_negs
        self.batch_size = batch_size
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        # the view covers ids [0, n_train]: the last id is only ever a
        # positive or a negative
        self.n_train = require_segments(len(self.frames), window, stride,
                                        "train")
        self.windows = gather_windows(self.frames, window, stride, "val")
        self.audio = audio_examples
        self.max_audio_id = (len(audio_examples) - 1
                             if audio_examples is not None else 0)
        self.drop_last = drop_last

    def __len__(self) -> int:
        if self.drop_last:
            return self.n_train // self.batch_size
        return -(-self.n_train // self.batch_size)

    def _audio_for(self, seg_ids: np.ndarray) -> np.ndarray:
        return self.audio[np.minimum(seg_ids, self.max_audio_id)]

    def epoch(self, epoch: Optional[int] = None) -> Iterator[dict]:
        """One epoch of batches. With ``epoch`` given, the order and the
        negatives come from ``default_rng((seed, epoch))``, so a resumed
        run replays the uninterrupted stream; without it, from the
        object's own stateful generator."""
        rng = (self.rng if epoch is None
               else np.random.default_rng((self.seed, epoch)))
        order = rng.permutation(self.n_train)
        for k, b0 in enumerate(range(0, self.n_train, self.batch_size)):
            ids = order[b0:b0 + self.batch_size]
            if self.drop_last and len(ids) < self.batch_size:
                break
            with span("data.gather", epoch=epoch, batch=k) as rec:
                t_ids = np.stack([
                    np.concatenate((
                        [i + 1],
                        sample_negatives(i, self.n_train, self.n_negs, rng)))
                    for i in ids])
                batch = {
                    "q_frames": self.windows[ids],
                    "t_frames": self.windows[t_ids],
                    "q_ids": ids.astype(np.int64),
                }
                if self.audio is not None:
                    batch["q_audio"] = self._audio_for(ids)
                    batch["t_audio"] = self._audio_for(t_ids)
                if rec is not None:
                    rec.attrs["bytes"] = sum(a.nbytes
                                             for a in batch.values())
            yield batch


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Run ``iterator`` in a daemon thread behind a queue of ``depth``.

    An exception in the wrapped iterator is raised again in the consumer:
    a failing epoch must not look like a short successful one (its meter
    would read 0.0, beat the early-stop threshold and be saved as best).
    """
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    failure = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            failure.append(e)
        finally:
            q.put(end)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        with span("data.wait") as rec:
            if rec is not None:
                rec.attrs["queued"] = q.qsize()
            item = q.get()
        if item is end:
            if failure:
                raise failure[0]
            return
        yield item
