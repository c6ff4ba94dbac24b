"""Warm texture serving: embed once, synthesize many.

The deployment shape for "infinite textures", and the port's counterpart
of avtex's ``examples/serve.py``: one ``TextureServer`` stays resident
per source video, and each request is a walk over the ``[L, L]`` logits
plus stitching. Here a random-init ResNet10 on a procedural clip with a
source tone serves a short request, a longer wilder one, one driven by a
wav (``-daf Mel``, alpha 0.5) and the first again, which must repeat it.
With ``out_dir`` each texture is written as PNG frames
(``<out_dir>/request_<name>/``); the tone is written there too.

    python -m avtex_torch.examples.serve [--device cpu] [--out-dir D]
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional

import numpy as np

from avtex_torch.config import Config
from avtex_torch.media import write_frames_png, write_wav
from avtex_torch.synth.server import TextureServer

from ._common import loop_clip, run_cli

FPS = 8.0
SR = 16000
CONFIG = Config(enc_arch="resnet10", model_type=1, img_size=32,
                new_video_length=3, threshold=0.4, mini_batchsize=8,
                da_feats="Mel", seed=0)


def song() -> np.ndarray:
    """10 s of a 220 Hz tone at ``SR``."""
    return (0.3 * np.sin(np.arange(SR * 10) / SR * 2 * np.pi * 220)
            ).astype(np.float32)


def run_requests(server, song_path: str) -> Dict[str, Dict]:
    """The example's four requests on ``server`` (avtex's server takes the
    same calls); the last repeats the first and must give its walk."""
    outs = {
        "a": server.synthesize(seconds=3, threshold=0.4, seed=1),
        "b": server.synthesize(seconds=5, threshold=0.2, seed=2),  # wilder
        "c": server.synthesize(seconds=3, driving_audio=song_path,
                               alpha=0.5, seed=3),             # audio-driven
    }
    for name, r in outs.items():
        print(f"request {name}: {len(r['result'].indices)} transitions, "
              f"{len(r['frames'])} frames"
              + (", audio attached" if r["audio"] is not None else ""))
    # identical request -> identical texture (deterministic serving)
    outs["a2"] = server.synthesize(seconds=3, threshold=0.4, seed=1)
    if not np.array_equal(outs["a"]["result"].indices,
                          outs["a2"]["result"].indices):
        raise AssertionError("a repeated request gave another walk")
    print("deterministic replay OK")
    return outs


def main(device=None, out_dir: Optional[str] = None) -> Dict:
    """Load a server and answer the requests; returns the server and each
    request's output."""
    with tempfile.TemporaryDirectory() as tmp:
        song_path = write_wav(os.path.join(out_dir or tmp, "song.wav"),
                              song(), SR)
        # params=None -> the seeded random-init encoder (pass trained
        # parameters, a state_dict, for real use)
        server = TextureServer.from_frames(
            CONFIG, loop_clip(80, 32, 32, period=20), FPS,
            audio_path=song_path, device=device, name="loop")
        print(f"resident: {server.L} segments embedded once")
        outs = run_requests(server, song_path)
    if out_dir is not None:
        for name, r in outs.items():
            write_frames_png(r["frames"],
                             os.path.join(out_dir, f"request_{name}"))
    return {"server": server, "requests": outs}


if __name__ == "__main__":
    run_cli(main, __doc__, "avtex_torch_serve_")
