"""Audio nearest-neighbour baseline (the port of avtex/baselines/audio_nn.py).

One ``[n_driving, L]`` cosine product over flattened log-mel patches on the
examples' device, then avtex's frame-emission rule on the host: the first
match emits its whole window, every later one its last S frames.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def cosine_matches(driving: torch.Tensor, source: torch.Tensor
                   ) -> torch.Tensor:
    """Per driving example, the source segment of the largest cosine,
    or segment 0 when no cosine is strictly positive (the reference starts
    from max_sim = 0 with a strict ``>``)."""
    d = driving.float().reshape(driving.shape[0], -1)
    s = source.float().to(d.device).reshape(source.shape[0], -1)
    d = d / (torch.linalg.vector_norm(d, dim=1, keepdim=True) + 1e-12)
    s = s / (torch.linalg.vector_norm(s, dim=1, keepdim=True) + 1e-12)
    sims = d @ s.t()
    return torch.where(sims.amax(dim=1) > 0, sims.argmax(dim=1), 0)


def audio_nearest_neighbour(driving_examples, source_examples,
                            window: int, stride: int, max_length: int
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """(frame_ids, matched segment ids): per driving example the
    best-matching segment's frames, the first whole, later ones their last
    ``stride``. Whole blocks are emitted until ``max_length`` is reached
    (the output may overshoot by up to a block). The driving sequence
    wraps around when it is shorter than the requested length, as avtex's
    does (the reference would IndexError there)."""
    matches = cosine_matches(torch.as_tensor(driving_examples),
                             torch.as_tensor(source_examples)).cpu().numpy()
    frame_ids: list = []
    seg_ids = []
    i = 0
    while len(frame_ids) < max_length:
        seg = int(matches[i % len(matches)])
        if not frame_ids:
            frame_ids.extend(range(seg * stride, seg * stride + window))
        else:
            start = seg * stride + (window - stride)
            frame_ids.extend(range(start, seg * stride + window))
        seg_ids.append(seg)
        i += 1
    return np.asarray(frame_ids), np.asarray(seg_ids)
