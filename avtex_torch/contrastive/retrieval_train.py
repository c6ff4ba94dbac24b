"""Trainer of the VideoForAudio retrieval head (the port of
avtex/contrastive/retrieval_train.py:25-77), whose parameters
``-daf_resume`` loads.

InfoNCE where each segment's audio example is the query, its own video
segment the positive (column 0) and ``n_negs`` other segments of the same
video the negatives. As in avtex:

- Data: segment ``i`` takes audio example ``min(i, N - 1)``; each epoch
  draws ``permutation(L)`` from one ``np.random.default_rng(seed)``, then
  per row of a batch ``choice(np.delete(arange(L), i), n_negs,
  replace=False)``; a ragged tail batch is dropped. The stream is avtex's
  bit for bit.
- Optimizer: Adam as ``optax.adam(lr)`` defines it (b1 0.9, b2 0.999, eps
  1e-8 outside the square root, no weight decay), which is what
  ``torch.optim.Adam`` computes, on an fp32 master copy of the bf16 model
  (``avtex_torch.train.loop.TrainState``).
- The video goes to the device once as uint8; each batch gathers its
  ``[B, 1 + n_negs, T, H, W, 3]`` windows there and preprocesses them
  (``preprocess_clip``, no augmentation).

avtex initialises with ``jax.random``, which torch cannot reproduce: the
port starts from ``flax_style_init(model, seed)``, or from ``params``
(e.g. avtex's initial parameters through ``avtex_torch.convert``).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from avtex_torch.data.preprocess import preprocess_clip
from avtex_torch.device import resolve_device
from avtex_torch.train.loop import TrainState, load_master_copy

from .audio_retrieval import VideoForAudio
from .infonce import info_nce_from_logits
from .segments import num_segments


def retrieval_batches(L: int, batch_size: int, n_negs: int,
                      rng: np.random.Generator
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """One epoch's ``(ids [B], t_ids [B, 1 + n_negs])``, positives first,
    drawn from ``rng`` as avtex draws them."""
    order = rng.permutation(L)
    for b0 in range(0, L - batch_size + 1, batch_size):
        ids = order[b0:b0 + batch_size]
        negs = np.stack([rng.choice(np.delete(np.arange(L), i), n_negs,
                                    replace=False) for i in ids])
        yield ids, np.concatenate([ids[:, None], negs], axis=1)


def create_retrieval_state(model: VideoForAudio, lr: float,
                           params: Dict[str, torch.Tensor]) -> TrainState:
    """The fp32 master copy of ``params`` and its Adam optimizer, for
    ``model`` already on its device."""
    master = load_master_copy(model, params)
    optimizer = torch.optim.Adam(list(master.values()), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=0.0)
    return TrainState(model, master, optimizer, lambda step: lr)


def retrieval_step(state: TrainState, audio: torch.Tensor,
                   windows: torch.Tensor, img_size: int) -> torch.Tensor:
    """One Adam step on ``audio`` [B, 100, 64] examples against uint8
    ``windows`` [B, n, T, H, W, 3] (both on the model's device); returns
    the loss (0-d, on the device)."""
    logits = state.model(audio, preprocess_clip(windows, img_size))
    loss = info_nce_from_logits(logits)
    loss.backward()
    state.apply_gradients()
    return loss.detach()


def train_video_for_audio(frames: np.ndarray, audio_examples: np.ndarray,
                          window: int, stride: int, *,
                          arch: str = "resnet18", img_size: int = 112,
                          batch_size: int = 8, n_negs: int = 7,
                          epochs: int = 10, lr: float = 1e-3,
                          temp: float = 0.1, seed: int = 0,
                          params: Optional[Dict[str, torch.Tensor]] = None,
                          dtype: torch.dtype = torch.bfloat16,
                          device=None, **encoder_kwargs
                          ) -> Tuple[VideoForAudio, Dict[str, torch.Tensor],
                                     List[float]]:
    """Train ``VideoForAudio(arch, temp=temp, dtype=dtype)`` on one video's
    uint8 ``frames`` [T, H, W, 3] and its log-mel ``audio_examples``
    [N, 100, 64], on ``device`` (``cuda`` unless given ``"cpu"``).

    ``params``: the initial fp32 state_dict (None: ``flax_style_init``
    from ``seed``); ``encoder_kwargs`` reach the video encoder. Returns
    (module, fp32 master parameters by state_dict name, per-epoch mean
    losses); ``avtex_torch.convert.export_params`` makes the parameters
    avtex's tree, for ``save_checkpoint`` and ``-daf_resume``.
    """
    from avtex_torch.synth.pipeline import flax_style_init

    dev = resolve_device(device)
    L = num_segments(len(frames), window, stride, "val")
    aud_ids = np.minimum(np.arange(L), len(audio_examples) - 1)
    audio = torch.as_tensor(np.asarray(audio_examples, np.float32)[aud_ids]
                            ).to(dev)
    # segment i is frames[i * stride:i * stride + window]; the video goes
    # to the device once and each batch gathers its windows there
    video = torch.from_numpy(np.ascontiguousarray(frames)).to(dev)
    offsets = torch.arange(window, device=dev)

    model = VideoForAudio(arch=arch, temp=temp, dtype=dtype,
                          **encoder_kwargs)
    if params is None:
        params = flax_style_init(model, seed)
    state = create_retrieval_state(model.to(dev).train(), lr, params)
    rng = np.random.default_rng(seed)
    history: List[float] = []
    for _ in range(epochs):
        losses = []
        for ids, t_ids in retrieval_batches(L, batch_size, n_negs, rng):
            starts = torch.from_numpy(t_ids * stride).to(dev)
            losses.append(retrieval_step(
                state, audio[torch.from_numpy(ids).to(dev)],
                video[starts[..., None] + offsets], img_size))
        history.append(float(np.mean([float(x) for x in losses]))
                       if losses else float("nan"))
    return model, {k: v.detach() for k, v in state.params.items()}, history
