"""Train a contrastive video-texture model and synthesize a texture.

The library equivalent of ``avtex -m 1 -ea resnet10 ...`` then ``avtex
-m 1 -e ...``, and the port's counterpart of avtex's
``examples/quickstart.py``: a procedural looping clip, a small encoder
trained for a few epochs, then a texture from the embed-once tables.
The clip goes to ``train_video`` and ``synthesize_frames`` as decoded
frames; with ``out_dir`` the checkpoints go there and the texture is
written as PNG frames (``<out_dir>/texture/``) where avtex writes an mp4.

    python -m avtex_torch.examples.quickstart [--device cpu] [--out-dir D]

For the flagship geometry use ``enc_arch="slowfast"``, ``img_size=224``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from avtex_torch.config import Config
from avtex_torch.media import write_frames_png
from avtex_torch.synth.pipeline import synthesize_frames
from avtex_torch.train.loop import train_video

from ._common import loop_clip, run_cli

FPS = 8.0
CONFIG = Config(
    enc_arch="resnet10",   # flagship is "slowfast" (use img_size=224)
    model_type=1,          # 1 = video-only; 2 = audio-conditioned
    img_size=32,
    window=4, stride=2,    # on real data these derive from fps
    n_negs=3, batch_size=4,
    lr=0.05, epochs=6,
    new_video_length=4,    # seconds of texture to synthesize
    threshold=0.4,         # transition-probability threshold (-th)
    mini_batchsize=8,
    seed=0,
)


def main(device=None, out_dir: Optional[str] = None) -> Dict:
    """Train, then synthesize; returns the epoch losses, the trained
    parameters, the walk and the texture's uint8 frames."""
    frames = loop_clip(80, 32, 32, period=20)  # a real loop of 20 frames
    state, losses = train_video(CONFIG, frames, ckpt_dir=out_dir,
                                ckpt_name="loop", device=device)
    print(f"epoch losses: {[round(x, 3) for x in losses]}")

    out = synthesize_frames(CONFIG, frames, FPS, state.params, name="loop",
                            device=device)
    texture = out["stitched"]["frames"]
    print(f"walk over segments: {[int(i) for i in out['result'].indices]}")
    if out_dir is not None:
        write_frames_png(texture, os.path.join(out_dir, "texture"))
        print(f"outputs in {out_dir}: {sorted(os.listdir(out_dir))}")
    return {"losses": losses, "params": state.params,
            "result": out["result"], "frames": texture}


if __name__ == "__main__":
    run_cli(main, __doc__, "avtex_torch_quickstart_")
