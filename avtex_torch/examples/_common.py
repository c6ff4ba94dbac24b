"""What the examples share: avtex's procedural clip and the command line."""

from __future__ import annotations

import argparse
import tempfile
from typing import Callable

import numpy as np


def loop_clip(t: int, h: int, w: int, period: int) -> np.ndarray:
    """uint8 RGB ``[t, h, w, 3]`` frames of a sine grating that moves with
    period ``period`` frames over a vertical ramp (avtex's examples)."""
    yy, xx = np.mgrid[0:h, 0:w]
    frames = np.stack([
        np.clip(np.sin(xx / 3 + 2 * np.pi * i / period) * 90 + 127 + yy,
                0, 255) for i in range(t)])
    return frames.astype(np.uint8)[..., None].repeat(3, -1)


def run_cli(main: Callable, doc: str, prefix: str) -> None:
    """``main(device, out_dir)`` from ``--device`` (the GPU unless "cpu")
    and ``--out-dir`` (a new temporary directory unless given)."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help='"cpu" to run on the CPU (default: the GPU)')
    ap.add_argument("--out-dir", default=None,
                    help="where to write the outputs (default: a new "
                         "temporary directory)")
    args = ap.parse_args()
    main(device=args.device,
         out_dir=args.out_dir or tempfile.mkdtemp(prefix=prefix))
