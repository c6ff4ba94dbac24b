"""Audio-conditioned video textures: train AV towers, drive with a wav.

The library equivalent of the paper's headline mode, ``avtex -m 2 ...``
then ``avtex -m 2 -e -da song -alpha 0.5 -daf VGG``, and the port's
counterpart of avtex's ``examples/audio_driven.py``: a procedural
looping clip with an amplitude-modulated source tone locked to its loop,
the audio+video contrastive model (``model_type=2``) trained for a few
epochs, then a texture driven by a different wav (VGGish scoring, the
alpha blend, the seed from the audio's best match, the driving waveform
as the output track). With ``out_dir`` the checkpoints and both wavs go
there, and the texture is written as PNG frames (``<out_dir>/texture/``)
with its track as ``texture.wav``, where avtex muxes an mp4.

    python -m avtex_torch.examples.audio_driven [--device cpu] [--out-dir D]
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional

import numpy as np

from avtex_torch.audio import waveform_to_examples
from avtex_torch.config import Config
from avtex_torch.media import write_frames_png, write_wav
from avtex_torch.synth.pipeline import synthesize_frames
from avtex_torch.train.loop import train_video

from ._common import loop_clip, run_cli

T, FPS, SR = 80, 8, 16000
CONFIG = Config(
    enc_arch="resnet10",   # flagship is "slowfast" (use img_size=224)
    model_type=2,          # audio+video contrastive towers
    img_size=32,
    window=4, stride=2,
    n_negs=3, batch_size=4,
    lr=0.05, epochs=4,
    new_video_length=4,    # seconds of texture (driving length also clips)
    threshold=0.4,
    alpha=0.5,             # blend: alpha*video logits + (1-alpha)*audio
    da_feats="VGG",        # reference default scoring (VGGish features)
    mini_batchsize=8,
    seed=0,
)


def source_tone() -> np.ndarray:
    """440 Hz whose envelope shares the video's loop period (20 frames)."""
    ts = np.arange(int(T / FPS * SR)) / SR
    return (0.5 * np.sin(2 * np.pi * 440 * ts)
            * (0.6 + 0.4 * np.sin(2 * np.pi * ts * FPS / 20))
            ).astype(np.float32)


def driving_tone() -> np.ndarray:
    """6 s of a different carrier with a faster rhythm."""
    td = np.arange(6 * SR) / SR
    return (0.5 * np.sin(2 * np.pi * 660 * td)
            * (0.5 + 0.5 * np.square(np.sin(2 * np.pi * td * 1.2)))
            ).astype(np.float32)


def main(device=None, out_dir: Optional[str] = None) -> Dict:
    """Train, then synthesize driven by the second wav; returns the epoch
    losses, the walk, the texture's frames and its track (the driving
    waveform as read from its file) with the track's rate."""
    frames = loop_clip(T, 32, 32, period=20)
    source = source_tone()
    examples = waveform_to_examples(source, SR, device=device)
    state, losses = train_video(CONFIG, frames, examples.cpu().numpy(),
                                ckpt_dir=out_dir, ckpt_name="loop_av",
                                device=device)
    print(f"epoch losses: {[round(x, 3) for x in losses]}")

    with tempfile.TemporaryDirectory() as tmp:
        wav_dir = out_dir or tmp
        audio_path = write_wav(os.path.join(wav_dir, "loop.wav"), source, SR)
        driving_path = write_wav(os.path.join(wav_dir, "driving.wav"),
                                 driving_tone(), SR)
        out = synthesize_frames(CONFIG, frames, float(FPS), state.params,
                                name="loop", audio_path=audio_path,
                                driving_audio_path=driving_path,
                                device=device)
    r, stitched = out["result"], out["stitched"]
    print(f"audio-driven walk: seed {r.seed_id}, {len(r.indices)} steps, "
          f"{int(r.jumps.sum())} jumps")
    if out_dir is not None:
        write_frames_png(stitched["frames"], os.path.join(out_dir, "texture"))
        write_wav(os.path.join(out_dir, "texture.wav"), stitched["audio"],
                  SR)
        print(f"outputs in {out_dir}: {sorted(os.listdir(out_dir))}")
    return {"losses": losses, "result": r, "frames": stitched["frames"],
            "audio": stitched["audio"], "sample_rate": SR}


if __name__ == "__main__":
    run_cli(main, __doc__, "avtex_torch_audio_driven_")
