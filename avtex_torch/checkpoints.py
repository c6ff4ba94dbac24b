"""Where pretrained checkpoints are looked for (the port's copies of the
lookups in avtex/utils/convert.py).

Each ``find_*_checkpoint`` tries, in order, an explicit path, its
environment variable and the reference's conventional file names, and
returns the first that exists (None if none does). The port cannot load
any of these files yet; where avtex would load one, the port raises
``checkpoint_not_ported`` instead of silently running on other weights.
"""

from __future__ import annotations

import os
from typing import Optional

ENCODER_FILES = {"resnet18": "r3d18_KM_200ep.pth",
                 "resnet18_2d": "resnet18-imagenet.pth",
                 "slowfast": "SLOWFAST_8x8_R50.pkl"}


def _first_existing(*cands: Optional[str]) -> Optional[str]:
    for cand in cands:
        if cand and os.path.exists(cand):
            return cand
    return None


def find_vggish_checkpoint(explicit: Optional[str] = None) -> Optional[str]:
    """pytorch_vggish.pth: ``explicit``, $AVTEX_VGGISH_CKPT,
    ``pretrained/pytorch_vggish.pth``, ``pytorch_vggish.pth``."""
    return _first_existing(explicit, os.environ.get("AVTEX_VGGISH_CKPT"),
                           "pretrained/pytorch_vggish.pth",
                           "pytorch_vggish.pth")


def find_slomo_checkpoint(explicit: Optional[str] = None) -> Optional[str]:
    """SuperSloMo.ckpt: ``explicit``, $AVTEX_SLOMO_CKPT,
    ``pretrained/SuperSloMo.ckpt``, ``SuperSloMo.ckpt``."""
    return _first_existing(explicit, os.environ.get("AVTEX_SLOMO_CKPT"),
                           "pretrained/SuperSloMo.ckpt", "SuperSloMo.ckpt")


def find_encoder_checkpoint(arch: str,
                            explicit: Optional[str] = None) -> Optional[str]:
    """A pretrained encoder for ``arch``: ``explicit``,
    $AVTEX_ENCODER_CKPT, ``pretrained/<file>``, ``<file>`` (``<file>``
    from ``ENCODER_FILES``; an arch without one tries only the first
    two)."""
    fname = ENCODER_FILES.get(arch)
    return _first_existing(explicit, os.environ.get("AVTEX_ENCODER_CKPT"),
                           fname and f"pretrained/{fname}", fname)


def checkpoint_not_ported(path: str, what: str,
                          item: str) -> NotImplementedError:
    """The error for a found checkpoint that avtex would load here."""
    return NotImplementedError(
        f"found {path}, which avtex loads as {what}; loading it is not "
        f"ported to avtex_torch yet: ROADMAP.md Queue 1 '{item}'. Move the "
        f"file away to run on the port's own weights.")
