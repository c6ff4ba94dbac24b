"""Embed-once segment tables (the port of avtex/synth/embeddings.py:84-246).

Both towers embed all L segments exactly once, in fixed-size batches; the
walk then needs only one matrix product. The decoded uint8 video is moved
to the model's device once and every batch gathers its windows there
(overlapping windows would make a host-side windowed copy ~W/S times
larger than the video). Each batch is preprocessed once and fed to both
towers.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from avtex_torch.contrastive.model import ContrastiveTextures
from avtex_torch.data.preprocess import preprocess_clip
from avtex_torch.device import module_device
from avtex_torch.nn.slowfast import slowfast_pathways


def _padded_starts(num_segments: int, stride: int, batch_size: int
                   ) -> np.ndarray:
    """Segment start frames, padded to a whole number of batches by
    repeating the last start."""
    starts = np.arange(num_segments, dtype=np.int64) * stride
    pad = (-num_segments) % batch_size
    if pad:
        starts = np.concatenate([starts, np.repeat(starts[-1:], pad)])
    return starts


def _embed_batches(model: ContrastiveTextures, video_u8, window: int,
                   starts: np.ndarray, batch_size: int, img_size: int,
                   towers: Sequence[str]) -> Tuple[torch.Tensor, ...]:
    device = module_device(model)
    video = torch.as_tensor(video_u8).to(device)  # one transfer
    slowfast = model.arch == "slowfast"
    offsets = torch.arange(window, device=device)
    outs = [[] for _ in towers]
    with torch.inference_mode():
        for b0 in range(0, len(starts), batch_size):
            st = torch.from_numpy(starts[b0:b0 + batch_size]).to(device)
            frames = video[st[:, None] + offsets[None, :]]  # [B, W, H, W, 3]
            x = preprocess_clip(frames, size=img_size, slowfast=slowfast)
            if slowfast:
                x = slowfast_pathways(x)
            for out, tower in zip(outs, towers):
                out.append(model.embed(x, tower=tower))
    return tuple(torch.cat(o, dim=0) for o in outs)


def embed_segments_from_video(model: ContrastiveTextures, video_u8,
                              window: int, stride: int, num_segments: int,
                              *, tower: str = "target", img_size: int = 224,
                              batch_size: int = 32) -> torch.Tensor:
    """[L, D] table of one tower, on the model's device."""
    starts = _padded_starts(num_segments, stride, batch_size)
    (table,) = _embed_batches(model, video_u8, window, starts, batch_size,
                              img_size, (tower,))
    return table[:num_segments]


def precompute_embeddings_from_video(model: ContrastiveTextures, video_u8,
                                     window: int, stride: int,
                                     num_segments: int, *,
                                     img_size: int = 224,
                                     batch_size: int = 32
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, T) [L, D] tables; both towers share each batch's gather and
    preprocessing.

    The batch shrinks to the smallest multiple of 8 that covers L in the
    same number of batches (L=297 at 128: 3x104 instead of 3x128).
    """
    L = num_segments
    n_b = -(-L // batch_size)
    batch_size = min(batch_size, ((-(-L // n_b) + 7) // 8) * 8)
    starts = _padded_starts(L, stride, batch_size)
    q, t = _embed_batches(model, video_u8, window, starts, batch_size,
                          img_size, ("query", "target"))
    return q[:L], t[:L]
