"""The transition walk (the port of avtex/synth/engine.py:32-79, :231-299).

Per-step semantics follow the reference's validate.py: candidates are the
positive ``min(q+1, L-1)`` first and then every other segment in
ascending order; scores are sum-normalised (not softmax); entries below
``max - threshold*max`` are zeroed and the next segment is drawn uniformly
over the survivors; a jump is any choice other than ``q+1``.

With driving audio, each step blends the sum-normalised video row with
the step's sum-normalised audio row, ``alpha * video + (1 - alpha) *
audio``, in float64 over the same candidate order.

The ``[L, L]`` logit matrix is one ``torch.matmul`` on the tables' device.
Two walks use it:

- ``synthesize_indices_host`` (the default of the server and the
  pipeline): numpy on the host, bit-exact with avtex's given the same
  tables, audio rows and ``np.random.default_rng(seed)``;
- ``synthesize_indices`` (avtex's ``lax.scan`` walk, ``_walk``): every
  step on the tables' device, the current id a one-element device
  tensor, rows gathered with ``index_select``, no host copy inside the
  loop. Its
  uniform draw over the survivors is the argmax of ``[steps, L]`` uniform
  noise, drawn from a ``torch.Generator`` seeded from ``seed`` or given
  as ``noise=``: given avtex's noise it picks avtex's ids.
"""

from __future__ import annotations

import dataclasses
import math
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
    src = torch.as_tensor(audio_examples).float()
    src = src.reshape(src.shape[0], -1)
    if num_segments is not None:
        src = src[:num_segments]
    src = src / (torch.linalg.vector_norm(src, dim=1, keepdim=True) + 1e-12)
    d = torch.as_tensor(driving_example).float().to(src.device).reshape(-1)
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
                            alpha: float = 0.5, audio_logits=None,
                            seed_id: int = 10,
                            rng: Optional[np.random.Generator] = None
                            ) -> SynthesisResult:
    """Host-side walk with the reference's exact per-step procedure.

    ``audio_logits``: optional ``[num_steps, L]`` driving-audio rows
    (already divided by temp), one per step, blended with weight
    ``1 - alpha``. ``rng`` may be a ``np.random.Generator``, a
    ``RandomState`` or the ``np.random`` module.
    """
    if rng is None:
        rng = np.random.default_rng(0)
    logits = logit_matrix(q_table, t_table) / temp
    audio = (None if audio_logits is None
             else torch.as_tensor(audio_logits).float().cpu().numpy())
    L = logits.shape[0]
    ids = np.arange(L)

    q_id = int(seed_id)
    idxs, jumps, ents, nnzs, greedy, pos_probs = [], [], [], [], [], []
    for step_i in range(num_steps):
        pos = min(q_id + 1, L - 1)
        mask = np.ones(L, dtype=bool)
        mask[[q_id, pos]] = False
        ordering = np.concatenate(([pos], ids[mask]))

        out = logits[q_id][ordering].astype(np.float64)
        out = out / out.sum()
        if audio is not None:
            oa = audio[step_i][ordering].astype(np.float64)
            out = alpha * out + (1.0 - alpha) * (oa / oa.sum())
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


def candidate_rows(L: int, device) -> torch.Tensor:
    """``[L, L]`` bool: row q marks the candidates of a step from q, every
    id but q itself, except from q = L-1 (where the positive is q) every
    id (avtex's mask removes the same row twice there)."""
    cand = ~torch.eye(L, dtype=torch.bool, device=device)
    cand[L - 1] = True
    return cand


def _sum_normalised(rows: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    rows = torch.where(cand, rows, 0.0)
    return rows / rows.sum(-1, keepdim=True)


def candidate_scores(logits: torch.Tensor, cand_rows: torch.Tensor,
                     alpha: Optional[float] = None) -> torch.Tensor:
    """Every row's sum-normalised candidate scores (times ``alpha`` when
    given: the video's weight of a blend with audio rows), -inf off the
    candidates: ``walk_steps``' ``video_p``."""
    video_p = _sum_normalised(logits, cand_rows)
    if alpha is not None:
        video_p = alpha * video_p
    return torch.where(cand_rows, video_p, -math.inf)


def walk_steps(video_p: torch.Tensor, cand_rows: torch.Tensor,
               noise: torch.Tensor, q0: torch.Tensor, threshold: float,
               audio_logits: Optional[torch.Tensor] = None,
               alpha: float = 0.5) -> torch.Tensor:
    """The device walk's loop (the choice of avtex's ``_walk`` step,
    ``engine.py:103-135``): ``[len(noise)]`` int64 ids from the 0-d id
    ``q0``.

    ``video_p`` is ``candidate_scores(logits, cand_rows, alpha)`` (alpha
    only when ``audio_logits`` are given), ``cand_rows`` is
    ``candidate_rows(L)``. A step blends the row with the step's
    sum-normalised audio row and picks the argmax of the step's noise
    over the survivors ``p >= max - threshold * max`` with ``p > 0``.
    Only what the next choice needs runs in the loop (about 9 kernels a
    step, 15 with audio; ``walk_stats`` computes the rest for all steps
    at once), and nothing in it waits for the host, so the loop can be
    captured in a CUDA graph.
    """
    q = q0.view(1)  # rows are [1, L], ids [1]: no views in the loop
    rows = noise.unbind(0)
    audio = None if audio_logits is None else audio_logits.unbind(0)
    chosen = []
    for s, noise_s in enumerate(rows):
        p = video_p.index_select(0, q)
        if audio is not None:
            cand = cand_rows.index_select(0, q)
            p = p + (1.0 - alpha) * _sum_normalised(audio[s], cand)
        mx = p.amax(dim=1, keepdim=True)
        keep = (p >= (mx - threshold * mx)) & (p > 0.0)
        q = torch.where(keep, noise_s, -1.0).argmax(dim=1)
        chosen.append(q)
    return torch.cat(chosen)


def walk_stats(video_p: torch.Tensor, cand_rows: torch.Tensor,
               idx: torch.Tensor, q0: torch.Tensor, threshold: float,
               audio_logits: Optional[torch.Tensor] = None,
               alpha: float = 0.5) -> torch.Tensor:
    """avtex's per-step statistics of a walk that chose ``idx`` from
    ``q0``, for all steps at once: ``[6, steps]`` float64 of indices,
    jumps, the survivors' entropy ``|sum log p_renorm| / max(n_nz, 1)``,
    survivor counts, greedy ids (argmax over the candidates) and the
    positive's score ``p[min(q + 1, L - 1)]``."""
    L = video_p.shape[0]
    prev = torch.cat([q0.view(1), idx[:-1]])
    p = video_p.index_select(0, prev)
    if audio_logits is not None:
        cand = cand_rows.index_select(0, prev)
        p = p + (1.0 - alpha) * _sum_normalised(
            audio_logits[:len(idx)], cand)
    mx = p.amax(dim=1, keepdim=True)
    p_thresh = torch.where(p >= mx - threshold * mx, p, 0.0)
    n_nz = (p_thresh != 0.0).sum(dim=1)
    p_renorm = p_thresh / p_thresh.sum(dim=1, keepdim=True)
    logs = torch.where(p_renorm > 0, torch.log(p_renorm), 0.0)
    entropy = (logs.sum(dim=1) / n_nz.clamp_min(1)).abs()
    pos = (prev + 1).clamp_max(L - 1)
    pos_prob = p.gather(1, pos[:, None])[:, 0]
    return torch.stack([v.to(torch.float64) for v in (
        idx, idx != prev + 1, entropy, n_nz, p.argmax(dim=1), pos_prob)])


def synthesize_indices(q_table, t_table, num_steps: int, temp: float = 0.1,
                       threshold: float = 0.0, alpha: float = 0.5,
                       audio_logits=None, seed_id: int = 10, seed: int = 0,
                       noise: Optional[torch.Tensor] = None
                       ) -> SynthesisResult:
    """The walk on the tables' device (avtex's ``synthesize_indices``):
    ``walk_logits`` on the ``[L, L]`` fp32 logits / temp. avtex pads L
    and the step count to reuse compiled XLA programs; here nothing is
    padded."""
    q = torch.as_tensor(q_table).float()
    t = torch.as_tensor(t_table).float().to(q.device)
    return walk_logits(torch.matmul(q, t.t()) / temp, num_steps, threshold,
                       alpha, audio_logits, seed_id, seed, noise)


def walk_logits(logits: torch.Tensor, num_steps: int, threshold: float = 0.0,
                alpha: float = 0.5, audio_logits=None, seed_id: int = 10,
                seed: int = 0, noise: Optional[torch.Tensor] = None
                ) -> SynthesisResult:
    """The device walk over ``[L, L]`` logits (already / temp), on their
    device: every row's sum-normalised candidate scores once, then
    ``walk_steps`` and ``walk_stats``; the ``[steps]`` outputs reach the
    host in one copy at the end. ``audio_logits``: optional
    ``[num_steps, L]`` driving-audio rows (already / temp), blended with
    weight ``1 - alpha``. ``noise``: optional ``[num_steps, L]`` uniform
    [0, 1) draws; without it they come from a ``torch.Generator`` on the
    logits' device seeded with ``seed``."""
    dev, L = logits.device, logits.shape[0]
    cand = candidate_rows(L, dev)
    audio = None
    if audio_logits is not None:
        audio = torch.as_tensor(audio_logits).float().to(dev)
    video_p = candidate_scores(logits, cand,
                               None if audio is None else alpha)
    if noise is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        noise = torch.rand((num_steps, L), generator=gen, device=dev)
    noise = torch.as_tensor(noise).float().to(dev)[:num_steps]
    q0 = torch.tensor(int(seed_id), dtype=torch.int64, device=dev)
    idx = walk_steps(video_p, cand, noise, q0, threshold, audio, alpha)
    out = walk_stats(video_p, cand, idx, q0, threshold, audio,
                     alpha).cpu().numpy()
    return SynthesisResult(
        seed_id=int(seed_id), indices=out[0].astype(np.int64),
        jumps=out[1].astype(bool), entropies=out[2].astype(np.float32),
        nonzero_counts=out[3].astype(np.int64),
        greedy_ids=out[4].astype(np.int64),
        pos_prob=out[5].astype(np.float32))


def driving_audio_logits(source_audio_feats: torch.Tensor,
                         driving_audio_feats: torch.Tensor,
                         temp: float = 0.1) -> torch.Tensor:
    """[steps, L] cosine / temp rows between driving features [steps, F]
    and per-segment source features [L, F], in fp32 on their device (no
    TF32 while ``torch.backends.cuda.matmul.allow_tf32`` keeps its
    default)."""
    s = torch.as_tensor(source_audio_feats).float()
    d = torch.as_tensor(driving_audio_feats).float().to(s.device)
    s = s / (torch.linalg.vector_norm(s, dim=1, keepdim=True) + 1e-12)
    d = d / (torch.linalg.vector_norm(d, dim=1, keepdim=True) + 1e-12)
    return (d @ s.t()) / temp
