"""Per-frame features for the classic baseline's distance matrix (the
port of avtex/classic/features.py).

The reference's three ``-f`` modes:
- "RGB": raw flattened frames, *no* per-row normalization;
- "ResNet": per-frame ResNet-18 penultimate features (each frame resized
  to 112 px and normalised as a one-frame clip), L2-normalized rows;
- "ResNet_VGGish": those features with, for frame i, the raw VGGish
  features of audio example ``min(i // stride, len - 1)`` concatenated
  (512 + 12288 columns), L2-normalized rows.

The reference runs an ImageNet-pretrained resnet18. A file that
``find_encoder_checkpoint("resnet18_2d")`` finds (``$AVTEX_ENCODER_CKPT``,
``pretrained/resnet18-imagenet.pth``) is loaded into ``resnet2d18(norm=
"affine")``, BatchNorm folded (``maybe_load_encoder``); without one it
warns as loudly as avtex and runs seeded random weights (``norm="group"``,
bf16, flax-style init from seed 0). VGGish loads a found
``pytorch_vggish.pth`` and warns without one, as avtex does.
"""

from __future__ import annotations

import sys
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from avtex_torch.checkpoints import maybe_load_encoder, maybe_load_vggish
from avtex_torch.data.preprocess import preprocess_clip
from avtex_torch.device import module_device
from avtex_torch.utils import batched_apply


def rgb_features(frames: np.ndarray, device
                 ) -> Tuple[torch.Tensor, bool]:
    """(features [N, H*W*C] float32 on ``device``, normalize_rows=False).

    The uint8 frames cross to the device once and are converted there.
    """
    u8 = torch.as_tensor(np.ascontiguousarray(frames)).to(device)
    return u8.reshape(len(frames), -1).to(torch.float32), False


def _random_resnet18(device) -> nn.Module:
    """resnet18 from a found pretrained file (``norm="affine"``; the call
    order from a 32^2 image), else, after avtex's warning, seeded random
    group-norm weights; bf16 on ``device``."""
    from avtex_torch.nn.resnet2d import resnet2d18
    from avtex_torch.synth.pipeline import flax_style_init
    module = resnet2d18(norm="affine")
    state, loaded = maybe_load_encoder(
        "resnet18_2d", module, flax_style_init(module, 0),
        torch.zeros((1, 32, 32, 3)),
        context="classic ResNet features")
    if not loaded:
        print("[avtex_torch] WARNING: no pretrained resnet18 checkpoint "
              "found (classic ResNet features); the reference uses "
              "torchvision resnet18(pretrained=True) — random features "
              "make the distance matrix meaningless. Set "
              "$AVTEX_ENCODER_CKPT or place "
              "pretrained/resnet18-imagenet.pth.", file=sys.stderr)
        module = resnet2d18()
        state = flax_style_init(module, 0)
    module.load_state_dict(state)
    return module.to(device).eval()


def resnet_features(frames: np.ndarray, device,
                    module: Optional[nn.Module] = None,
                    img_size: int = 112, batch_size: int = 64
                    ) -> Tuple[torch.Tensor, bool]:
    """(per-frame ``ResNet2D`` features [N, 512] float32 on ``device``,
    normalize_rows=True). ``module`` is a ``ResNet2D`` with its weights
    (None: the resnet18 above, pretrained when a file is found). Frames go through in batches of
    ``batch_size``, the tail padded by its last frame and trimmed."""
    if module is None:
        module = _random_resnet18(device)
    dev = module_device(module)

    def run(x):
        clip = preprocess_clip(x.to(dev)[:, None], size=img_size)
        return module(clip[:, 0])

    with torch.inference_mode():
        feats = batched_apply(run, np.asarray(frames), batch_size=batch_size)
    return feats, True


def resnet_vggish_features(frames: np.ndarray,
                           audio_examples: Optional[torch.Tensor],
                           window: int, stride: int, device,
                           img_size: int = 112,
                           module: Optional[nn.Module] = None,
                           vggish: Optional[nn.Module] = None
                           ) -> Tuple[torch.Tensor, bool]:
    """ResNet frame features with, for frame i, the VGGish features of
    audio example ``min(i // stride, len - 1)``; normalize_rows=True.
    Without audio examples, the ResNet features alone (as avtex).
    ``vggish``: a VGGish with its weights (None: seeded, then a found
    ``pytorch_vggish.pth``)."""
    from avtex_torch.nn.vggish import VGGish
    from avtex_torch.synth.embeddings import vggish_audio_features
    from avtex_torch.synth.pipeline import flax_style_init
    vfeats, _ = resnet_features(frames, device, module, img_size)
    if audio_examples is None:
        return vfeats, True
    if vggish is None:
        vggish = VGGish()
        state, _ = maybe_load_vggish(
            flax_style_init(vggish, 0),
            context="classic ResNet_VGGish features")
        vggish.load_state_dict(state)
        vggish = vggish.to(vfeats.device).eval()
    afeats = vggish_audio_features(vggish, audio_examples)
    ids = np.minimum(np.arange(len(frames)) // stride, len(afeats) - 1)
    afeats = afeats[torch.from_numpy(ids).to(afeats.device)]
    return torch.cat([vfeats, afeats.to(vfeats.device)], dim=1), True


def frame_features(feats: str, frames: np.ndarray, device,
                   audio_examples: Optional[torch.Tensor] = None,
                   window: int = 0, stride: int = 1
                   ) -> Tuple[torch.Tensor, bool]:
    """Features of the ``-f`` mode ``feats`` (``audio_examples``,
    ``window`` and ``stride`` serve "ResNet_VGGish")."""
    if feats == "RGB":
        return rgb_features(frames, device)
    if feats == "ResNet":
        return resnet_features(frames, device)
    if feats == "ResNet_VGGish":
        return resnet_vggish_features(frames, audio_examples, window,
                                      stride, device)
    raise ValueError(f"unknown classic features {feats!r}")
