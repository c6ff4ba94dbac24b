"""The transition walk (the port of avtex/synth/engine.py:32-79, :231-299).

Per-step semantics follow the reference's validate.py: candidates are the
positive ``min(q+1, L-1)`` first and then every other segment in
ascending order; scores are sum-normalised (not softmax); entries below
``max - threshold*max`` are zeroed and the next segment is drawn uniformly
over the survivors; a jump is any choice other than ``q+1``.

The ``[L, L]`` logit matrix is one ``torch.matmul`` on the tables' device;
the per-step walk is numpy on the host, bit-exact with avtex given the
same tables and ``np.random.default_rng(seed)``. The device scan walk
(avtex's ``synthesize_indices``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class SynthesisResult:
    """Host-side view of a completed walk."""

    seed_id: int
    indices: np.ndarray        # [steps] chosen segment ids
    jumps: np.ndarray          # [steps] bool, chosen != prev+1
    entropies: np.ndarray      # [steps]
    nonzero_counts: np.ndarray  # [steps]
    greedy_ids: np.ndarray     # [steps] argmax (non-random) choice
    pos_prob: np.ndarray       # [steps] normalised score of the positive


def num_synthesis_steps(max_length: int, window: int, stride: int) -> int:
    """Steps for ``while len(new_frames) < max_length``: the first segment
    emits W frames, every later one its last S frames."""
    if max_length <= window:
        return 1
    return 1 + -(-(max_length - window) // stride)


def seed_segment(audio_examples, driving_example, default: int = 10,
                 num_segments: Optional[int] = None) -> int:
    """Initial q_id: ``default``, or the segment whose audio example best
    matches the first driving example (cosine; strictly-greater updates
    from q_id=0, max_sim=0, so ties keep the earliest id and no positive
    match keeps 0)."""
    if driving_example is None or audio_examples is None:
        return default
    src = torch.as_tensor(np.asarray(audio_examples), dtype=torch.float32)
    src = src.reshape(src.shape[0], -1)
    if num_segments is not None:
        src = src[:num_segments]
    src = src / (torch.linalg.vector_norm(src, dim=1, keepdim=True) + 1e-12)
    d = torch.as_tensor(np.asarray(driving_example),
                        dtype=torch.float32).reshape(-1)
    d = d / (torch.linalg.vector_norm(d) + 1e-12)
    sims = src @ d
    best = int(torch.argmax(sims))
    return best if float(sims[best]) > 0.0 else 0


def logit_matrix(q_table: torch.Tensor, t_table: torch.Tensor) -> np.ndarray:
    """``q_table @ t_table.T`` in fp32 on the tables' device, to the host."""
    q = torch.as_tensor(q_table).float()
    t = torch.as_tensor(t_table).float().to(q.device)
    return torch.matmul(q, t.t()).cpu().numpy()


def synthesize_indices_host(q_table, t_table, num_steps: int,
                            temp: float = 0.1, threshold: float = 0.0,
                            seed_id: int = 10,
                            rng: Optional[np.random.Generator] = None
                            ) -> SynthesisResult:
    """Host-side walk with the reference's exact per-step procedure.

    ``rng`` may be a ``np.random.Generator``, a ``RandomState`` or the
    ``np.random`` module. Driving audio (avtex's ``audio_logits`` blend)
    is not ported yet.
    """
    if rng is None:
        rng = np.random.default_rng(0)
    logits = logit_matrix(q_table, t_table) / temp
    L = logits.shape[0]
    ids = np.arange(L)

    q_id = int(seed_id)
    idxs, jumps, ents, nnzs, greedy, pos_probs = [], [], [], [], [], []
    for _ in range(num_steps):
        pos = min(q_id + 1, L - 1)
        mask = np.ones(L, dtype=bool)
        mask[[q_id, pos]] = False
        ordering = np.concatenate(([pos], ids[mask]))

        out = logits[q_id][ordering].astype(np.float64)
        out = out / out.sum()
        greedy.append(int(ordering[np.argmax(out)]))
        pos_probs.append(float(out[0]))

        mx = out.max()
        out[out < mx - threshold * mx] = 0.0
        nz = np.flatnonzero(out)
        renorm = out[nz] / out[nz].sum()
        ents.append(float(abs(np.log(renorm).mean())))
        nnzs.append(len(nz))
        nxt = int(ordering[int(rng.choice(nz))])
        jumps.append(nxt != q_id + 1)
        idxs.append(nxt)
        q_id = nxt

    return SynthesisResult(
        seed_id=int(seed_id),
        indices=np.asarray(idxs), jumps=np.asarray(jumps),
        entropies=np.asarray(ents), nonzero_counts=np.asarray(nnzs),
        greedy_ids=np.asarray(greedy), pos_prob=np.asarray(pos_probs))
