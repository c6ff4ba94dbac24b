"""Audio/video muxing and texture-output writing (the port's copy of
avtex/media/mux.py).

With an ``ffmpeg`` executable on PATH the texture is muxed to H.264 + AAC;
otherwise the in-package AVI muxer interleaves MJPEG video with PCM audio.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional, Sequence

import numpy as np

from .audio_io import write_wav
from .video import write_video


def _ffmpeg_mux(frames: np.ndarray, wav_path: str, out_path: str,
                fps: float) -> str:
    tmp_video = out_path + ".video.mp4"
    write_video(frames, tmp_video, fps)
    cmd = ["ffmpeg", "-y", "-i", tmp_video, "-i", wav_path,
           "-c:v", "copy", "-c:a", "aac", "-shortest", out_path]
    subprocess.run(cmd, check=True, capture_output=True)
    os.remove(tmp_video)
    return out_path


def mux_audio_video(frames: np.ndarray, audio: Optional[np.ndarray],
                    sample_rate: int, out_path: str, fps: float) -> str:
    """Write frames (+ optional audio) to one playable file; returns the
    path written (``.avi`` when the AVI muxer is used)."""
    if audio is None:
        return write_video(frames, out_path, fps)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    wav_path = os.path.splitext(out_path)[0] + ".wav"
    write_wav(wav_path, audio, sample_rate)
    if shutil.which("ffmpeg"):
        out = _ffmpeg_mux(frames, wav_path, out_path, fps)
    else:
        from . import avimux
        out = avimux.write_avi(os.path.splitext(out_path)[0] + ".avi",
                               frames, fps, audio=np.asarray(audio),
                               sample_rate=sample_rate)
    os.remove(wav_path)  # the audio is in the container
    return out


def save_texture_outputs(result_dir: str, name: str,
                         frames: Sequence[np.ndarray], fps: float,
                         audio: Optional[np.ndarray] = None,
                         sample_rate: int = 22050,
                         frames_intp: Optional[Sequence[np.ndarray]] = None,
                         sf: int = 5) -> dict:
    """Write the plain texture at source fps and, when interpolated frames
    exist, the slow-motion variant at ``fps * (sf + 1) / 2``."""
    os.makedirs(result_dir, exist_ok=True)
    out = {"texture": mux_audio_video(
        np.stack(list(frames)), audio, sample_rate,
        os.path.join(result_dir, f"{name}.mp4"), fps)}
    if frames_intp is not None:
        out["texture_interp"] = mux_audio_video(
            np.stack(list(frames_intp)), audio, sample_rate,
            os.path.join(result_dir, f"{name}_interp.mp4"),
            fps * (sf + 1) / 2)
    return out
