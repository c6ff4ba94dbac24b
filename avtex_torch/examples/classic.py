"""Classic Schödl video textures through the library API.

The port's counterpart of avtex's ``examples/classic.py``, two levels:

1. ``run_classic_frames``, the whole sigma sweep (what
   ``avtex_torch.cli.classic_main`` wraps): features -> D1 -> D2 -> value
   iteration -> threshold -> texture walk, per sigma;
2. ``classic_transition_matrix``, the chain D1 -> D2 -> D3 -> threshold
   on raw features in one call, on the features' device.

With ``out_dir`` each sigma's texture is written as PNG frames
(``<out_dir>/loop_classic_m1_sigma<s>/``) where avtex writes an mp4.

    python -m avtex_torch.examples.classic [--device cpu] [--out-dir D]
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from avtex_torch.classic.driver import run_classic_frames
from avtex_torch.classic.fused import classic_transition_matrix
from avtex_torch.config import ClassicConfig
from avtex_torch.device import resolve_device
from avtex_torch.media import write_frames_png

from ._common import loop_clip, run_cli

FPS = 8.0
# Classic mode, RGB features, a small sweep
CONFIG = ClassicConfig(model_type=1, feats="RGB", filter_size=8,
                       new_video_length=3, sigmas=(4.5, 4.55),
                       start_frame=5, interpolation=False)


def main(device=None, out_dir: Optional[str] = None) -> Dict:
    """Run the sweep and the one-call matrix; returns the sweep's results
    (each sigma's walk and frames) and the matrix as numpy."""
    frames = loop_clip(60, 32, 32, period=15)
    # 1. the full driver
    out = run_classic_frames(CONFIG, frames, FPS, name="loop", num_steps=20,
                             device=device)
    for sigma, r in out["sigma_results"].items():
        print(f"sigma {sigma}: {out['jump_counts'][sigma]} jumps, "
              f"{len(r['frames'])} frames")
        if out_dir is not None:
            write_frames_png(r["frames"], os.path.join(
                out_dir, f"loop_classic_m{CONFIG.model_type}_sigma{sigma}"))

    # 2. the chain on raw features, in one call
    feats = torch.from_numpy(
        (frames.reshape(len(frames), -1) / 255.0).astype(np.float32))
    probs = classic_transition_matrix(feats.to(resolve_device(device)),
                                      sigma_factor=4.5, filter_size=8)
    probs = probs.cpu().numpy()
    print(f"fused transition matrix: {probs.shape}, "
          f"{int((probs > 0).sum())} allowed transitions")
    return {"sweep": out, "probs": probs}


if __name__ == "__main__":
    run_cli(main, __doc__, "avtex_torch_classic_")
