"""Synthesis-time class-activation-map (CAM) videos (the port of
avtex/synth/cam.py:33-134).

Activations never change during synthesis, so the spatial map of every
segment is captured once, on an embed pass of one tower, and each step's
CAM is a lookup. ``cam[l] = sum_c emb[l, c] * act[l, c]``: the segment's
own normalised embedding weights the channels of its encoder's deepest
spatial activation, averaged over time.

The activation is the one avtex's ``_last_spatial_intermediate`` picks
among the module outputs that flax captures: among the 5-D outputs, in
the order the modules finish (a module after the modules it calls), the
last one with the most channels. The port's modules mirror avtex's tree,
so forward hooks on every module of the video encoder see the same
outputs in the same order; a hook keeps only the current winner. For the
3D ResNets and SlowFast that is the last bottleneck's own output (for
SlowFast the slow pathway's, out of ``fused_conv1x1`` under
``fuse="all"``). A 2D frame-mean encoder has no 5-D output and raises
``ValueError``, as in avtex.

``cam_step_frames`` overlays each step's query segment's map and its
successor's on the segments' centre frames (``overlay_cam``).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Tuple

import numpy as np
import torch
from torch import nn

from avtex_torch.contrastive.model import ContrastiveTextures
from avtex_torch.data.preprocess import preprocess_clip
from avtex_torch.device import module_device
from avtex_torch.nn.slowfast import slowfast_pathways
from avtex_torch.obs.visualizations import overlay_cam

from .embeddings import _padded_starts, _segment_audio


@contextlib.contextmanager
def last_spatial_activation(encoder: nn.Module) -> Iterator[List]:
    """Within the block, ``box[0]`` holds the 5-D NCDHW output with the
    most channels, the last one on a tie, of the latest forward of
    ``encoder`` (avtex's ``_last_spatial_intermediate``)."""
    box: List = [None]

    def hook(module, args, out):
        if isinstance(out, torch.Tensor) and out.ndim == 5 and (
                box[0] is None or out.shape[1] >= box[0].shape[1]):
            box[0] = out

    handles = [m.register_forward_hook(hook) for m in encoder.modules()]
    try:
        yield box
    finally:
        for h in handles:
            h.remove()


def segment_cams(model: ContrastiveTextures, video_u8, window: int,
                 stride: int, num_segments: int, *, audio_examples=None,
                 tower: str = "query", img_size: int = 224,
                 batch_size: int = 16) -> torch.Tensor:
    """[L, h, w] float32 activation maps, one per segment, from one embed
    pass of ``tower``, on the model's device.

    ``audio_examples`` ([N, 100, 64]) are required for ``model_type=2``:
    segment i takes example ``min(i, N - 1)``, as the tables do.
    """
    if tower not in ("query", "target"):
        raise ValueError(f"tower must be 'query' or 'target', got {tower!r}")
    if model.model_type == 2 and audio_examples is None:
        raise ValueError("model_type=2 CAMs require audio_examples")
    dev = module_device(model)
    embedder = model.q_embedder if tower == "query" else model.t_embedder
    L = num_segments
    starts = _padded_starts(L, stride, batch_size)
    audio = (None if model.model_type != 2 else
             _segment_audio(audio_examples, L, len(starts), dev))
    video = torch.as_tensor(np.asarray(video_u8)).to(dev)  # one transfer
    offsets = torch.arange(window, device=dev)
    slowfast = model.arch == "slowfast"
    cams = []
    with torch.inference_mode(), \
            last_spatial_activation(embedder.video_encoder) as box:
        for b0 in range(0, len(starts), batch_size):
            st = torch.from_numpy(starts[b0:b0 + batch_size]).to(dev)
            x = preprocess_clip(video[st[:, None] + offsets[None, :]],
                                size=img_size, slowfast=slowfast)
            if slowfast:
                x = slowfast_pathways(x)
            box[0] = None
            emb = model.embed(
                x, None if audio is None else audio[b0:b0 + batch_size],
                tower=tower)
            if box[0] is None:
                raise ValueError("no 5-D spatial intermediate captured")
            act = box[0].float().mean(dim=2)              # [B, C, h, w]
            w = emb[:, :act.shape[1]]
            cams.append(torch.einsum("bchw,bc->bhw", act[:, :w.shape[1]], w))
    return torch.cat(cams)[:L]


def cam_step_frames(video_u8, cams, step_ids, window: int, stride: int,
                    alpha: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """(query_frames, pos_frames): uint8 [steps, H, W, 3] each, one
    CAM-overlaid frame per step: the query segment's map on its centre
    frame, and its successor's (``min(q + 1, L - 1)``) on that segment's
    centre frame. Computed on the device of ``cams`` when it is a
    tensor."""
    cams = torch.as_tensor(cams)
    dev = cams.device
    video = torch.as_tensor(np.asarray(video_u8)).to(dev)
    L, last = len(cams), len(video) - 1
    q = torch.as_tensor(np.asarray(step_ids, np.int64)).to(dev)
    pos = torch.clamp(q + 1, max=L - 1)

    def frames(ids):
        centre = torch.clamp(ids * stride + window // 2, max=last)
        return overlay_cam(video[centre], cams[ids], alpha).cpu().numpy()

    return frames(q), frames(pos)
