"""Embed-once segment tables (the port of avtex/synth/embeddings.py:84-273).

Both towers embed all L segments exactly once, in fixed-size batches; the
walk then needs only one matrix product. The decoded uint8 video is moved
to the model's device once and every batch gathers its windows there
(overlapping windows would make a host-side windowed copy ~W/S times
larger than the video). Each batch is preprocessed once and fed to both
towers. For ``model_type=2`` segment i takes audio example
``min(i, len(examples) - 1)``, and the padded tail repeats the last row.
``vggish_audio_features`` featurises examples for the driving-audio
scorer. ``embed_segments`` and ``precompute_embeddings`` embed windows
the caller has already gathered (``[L, W, H, W, 3]``), with avtex's
semantics; the segment-sharded forms are in
``avtex_torch.parallel.sharded``.
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


def _segment_audio(audio_examples, num_segments: int, padded: int,
                  device) -> torch.Tensor:
    """[padded, 100, 64] audio rows on ``device``: segment i takes example
    ``min(i, len(examples) - 1)``, rows past ``num_segments`` repeat the
    last segment's."""
    examples = torch.as_tensor(audio_examples).to(device)
    ids = np.minimum(np.arange(padded), num_segments - 1)
    ids = np.minimum(ids, len(examples) - 1)
    return examples[torch.from_numpy(ids).to(device)]


def _audio_rows(model: ContrastiveTextures, audio_examples, num_segments,
                padded: int):
    """``_segment_audio`` on the model's device for ``model_type=2`` with
    examples, else None."""
    if audio_examples is None or model.model_type != 2:
        return None
    return _segment_audio(audio_examples, num_segments, padded,
                          module_device(model))


def _batch_plan(num_segments: int, batch_size: int) -> int:
    """The batch size that covers ``num_segments`` in as many batches as
    ``batch_size`` does, shrunk to the smallest such multiple of 8 (L=297
    at 128: 3x104 instead of 3x128)."""
    n_b = -(-num_segments // batch_size)
    return min(batch_size, ((-(-num_segments // n_b) + 7) // 8) * 8)


def _embed_batches(model: ContrastiveTextures, video_u8, window: int,
                   starts: np.ndarray, batch_size: int, img_size: int,
                   towers: Sequence[str], audio=None
                   ) -> Tuple[torch.Tensor, ...]:
    """One table per tower over the windows at ``starts`` (a whole number
    of batches), with ``audio`` rows aligned to ``starts`` (or None)."""
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
            a = None if audio is None else audio[b0:b0 + batch_size]
            for out, tower in zip(outs, towers):
                out.append(model.embed(x, a, tower=tower))
    return tuple(torch.cat(o, dim=0) for o in outs)


def embed_segments_from_video(model: ContrastiveTextures, video_u8,
                              window: int, stride: int, num_segments: int,
                              audio_examples=None, *, tower: str = "target",
                              img_size: int = 224,
                              batch_size: int = 32) -> torch.Tensor:
    """[L, D] table of one tower, on the model's device."""
    starts = _padded_starts(num_segments, stride, batch_size)
    (table,) = _embed_batches(model, video_u8, window, starts, batch_size,
                              img_size, (tower,),
                              _audio_rows(model, audio_examples,
                                          num_segments, len(starts)))
    return table[:num_segments]


def precompute_embeddings_from_video(model: ContrastiveTextures, video_u8,
                                     window: int, stride: int,
                                     num_segments: int,
                                     audio_examples=None, *,
                                     img_size: int = 224,
                                     batch_size: int = 32
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, T) [L, D] tables; both towers share each batch's gather and
    preprocessing (and, for model_type=2, its audio rows:
    ``audio_examples`` [N, 100, 64], numpy or a tensor).

    The batch shrinks to the smallest multiple of 8 that covers L in the
    same number of batches (L=297 at 128: 3x104 instead of 3x128).
    """
    L = num_segments
    batch_size = _batch_plan(L, batch_size)
    starts = _padded_starts(L, stride, batch_size)
    q, t = _embed_batches(model, video_u8, window, starts, batch_size,
                          img_size, ("query", "target"),
                          _audio_rows(model, audio_examples, L, len(starts)))
    return q[:L], t[:L]


def _windows_as_video(windows_u8) -> Tuple[np.ndarray, int]:
    """Pre-gathered windows [L, W, H, W, 3] as one frame array whose
    segment i starts at frame i * W (stride W), and W."""
    windows = np.asarray(windows_u8)
    return windows.reshape((-1,) + windows.shape[2:]), windows.shape[1]


def _embed_window_batches(model, windows_u8, audio_examples, towers,
                          img_size: int, batch_size: int):
    video, window = _windows_as_video(windows_u8)
    L = len(video) // window
    starts = _padded_starts(L, window, batch_size)
    tables = _embed_batches(model, video, window, starts, batch_size,
                            img_size, towers,
                            _audio_rows(model, audio_examples, L,
                                        len(starts)))
    return tuple(t[:L] for t in tables)


def embed_segments(model: ContrastiveTextures, windows_u8,
                   audio_examples=None, *, tower: str = "target",
                   img_size: int = 224, batch_size: int = 32
                   ) -> torch.Tensor:
    """[L, D] table of one tower over pre-gathered uint8 windows
    ``[L, W, H, W, 3]`` (the port of avtex/synth/embeddings.py:157-183),
    in batches of ``batch_size`` (the tail padded by repeating the last
    window); segment i takes audio example ``min(i, N - 1)``."""
    (table,) = _embed_window_batches(model, windows_u8, audio_examples,
                                     (tower,), img_size, batch_size)
    return table


def precompute_embeddings(model: ContrastiveTextures, windows_u8,
                          audio_examples=None, *, img_size: int = 224,
                          batch_size: int = 32
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, T) [L, D] tables over pre-gathered windows: both towers on each
    batch (``embed_segments`` twice, one preprocessing)."""
    return _embed_window_batches(model, windows_u8, audio_examples,
                                 ("query", "target"), img_size, batch_size)


def vggish_audio_features(vggish: torch.nn.Module, examples,
                          batch_size: int = 64) -> torch.Tensor:
    """Raw VGGish conv features [N, 12288] of ``examples`` [N, 100, 64],
    in batches of ``batch_size``, on the module's device."""
    device = module_device(vggish)
    examples = torch.as_tensor(examples).to(device)
    with torch.inference_mode():
        return torch.cat([vggish(examples[b0:b0 + batch_size])
                          for b0 in range(0, len(examples), batch_size)])
