"""Warm-process texture serving: embed once, synthesize many (the port of
avtex/synth/server.py:36-198).

    server = TextureServer.from_frames(cfg, frames_u8, fps, params)
    a = server.synthesize(seconds=30, threshold=0.4, seed=1)
    b = server.synthesize(seconds=60, threshold=0.2, seed=2)

The decoded frames and both embedding tables stay resident; each request
is one host walk over the ``[L, L]`` logits plus stitching, with
SuperSloMo at jumps when interpolating: ``interp_fn`` if given, else one
loaded once per server from a checkpoint that ``find_slomo_checkpoint``
finds, else the crossfade. ``TextureServer(cfg, video_path, params)``
decodes the file first. Driving audio and the device walk raise until
their slices land.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from avtex_torch.checkpoints import maybe_make_slomo_interp_fn
from avtex_torch.config import Config
from avtex_torch.contrastive.segments import require_segments
from avtex_torch.device import resolve_device

from .embeddings import precompute_embeddings_from_video
from .engine import num_synthesis_steps, synthesize_indices_host
from .interp import InterpFn
from .pipeline import _not_yet, build_model
from .stitcher import stitch_texture


class TextureServer:
    """One source video, resident embedding tables, many requests."""

    def __init__(self, cfg: Config, video_path: str, params=None,
                 audio_path: Optional[str] = None, *, device=None,
                 interp_fn: Optional[InterpFn] = None,
                 **encoder_kwargs: Any):
        from avtex_torch.media import read_video
        frames, fps = read_video(video_path)
        self._setup(cfg, frames, fps, params, audio_path, device,
                    os.path.splitext(os.path.basename(video_path))[0],
                    interp_fn, encoder_kwargs)

    @classmethod
    def from_frames(cls, cfg: Config, frames_u8: np.ndarray, fps: float,
                    params=None, *, audio_path: Optional[str] = None,
                    device=None, name: str = "texture",
                    interp_fn: Optional[InterpFn] = None,
                    **encoder_kwargs: Any) -> "TextureServer":
        """Serve already-decoded uint8 RGB frames [T, H, W, 3].

        ``params`` is the port's state_dict (None: seeded flax-style init);
        ``interp_fn(frame0, frame1, n_mid)`` makes the frames at jumps
        (None: SuperSloMo from a found checkpoint, else the crossfade);
        ``encoder_kwargs`` reach the encoder (e.g. ``width``, ``layers``).
        """
        self = cls.__new__(cls)
        self._setup(cfg, frames_u8, fps, params, audio_path, device, name,
                    interp_fn, encoder_kwargs)
        return self

    def _setup(self, cfg, frames_u8, fps, params, audio_path, device, name,
               interp_fn, encoder_kwargs):
        self.device = resolve_device(device)
        self._interp_fn = interp_fn
        self.video_full, self.fps = np.asarray(frames_u8), float(fps)
        self.cfg = cfg.derive_geometry(self.fps)
        self.sub = max(1, int(cfg.subsample_rate))
        self.video = self.video_full[::self.sub]
        self.W, self.S = self.cfg.window, self.cfg.stride
        self.L = require_segments(len(self.video), self.W, self.S, "val",
                                  what=name)
        self.name = name

        self.audio, self.sample_rate = None, 22050
        if audio_path is not None and os.path.exists(audio_path):
            from avtex_torch.media import read_wav
            self.audio, self.sample_rate = read_wav(audio_path)
            apf = int(np.floor(self.sample_rate * self.sub / self.fps))
            self.audio = self.audio[: len(self.video) * apf]

        self.model = build_model(self.cfg, params, self.device,
                                 **encoder_kwargs)
        t0 = time.perf_counter()
        self.q_table, self.t_table = precompute_embeddings_from_video(
            self.model, self.video, self.W, self.S, self.L,
            img_size=self.cfg.img_size,
            batch_size=max(self.cfg.mini_batchsize, 1))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.embed_s = time.perf_counter() - t0

    def synthesize(self, seconds: Optional[float] = None,
                   threshold: Optional[float] = None,
                   alpha: Optional[float] = None,
                   seed: Optional[int] = None,
                   seed_segment_id: Optional[int] = None,
                   driving_audio: Optional[str] = None,
                   walk_on_device: bool = False,
                   stitch: bool = True,
                   interpolate: Optional[bool] = None) -> Dict:
        """One texture from the resident tables.

        Returns {"result": SynthesisResult, "frames", "frames_intp",
        "audio", "sample_rate", "fps", "jump_count", "timings"}; knobs
        default to the server's cfg. ``alpha`` weighs driving audio against
        the video, so it has no effect until driving audio is ported.
        Until the server has an ``interp_fn``, an interpolating request
        looks for a SuperSloMo checkpoint and loads it (kept for later
        requests), reporting the time as ``timings["interp_load_s"]``.
        """
        if driving_audio is not None:
            raise _not_yet("driving audio", "Audio-conditioned synthesis, -m 2")
        if walk_on_device:
            raise _not_yet("the device scan walk", "Device scan walk")
        cfg = self.cfg
        seconds = cfg.new_video_length if seconds is None else seconds
        threshold = cfg.threshold if threshold is None else threshold
        seed = cfg.seed if seed is None else seed
        interpolate = (cfg.interpolation if interpolate is None
                       else interpolate)
        seed_id = min(cfg.start_segment if seed_segment_id is None
                      else seed_segment_id, self.L - 1)
        max_length = int(seconds * self.fps)  # original-rate frames
        steps = num_synthesis_steps(-(-max_length // self.sub), self.W,
                                    self.S)
        t0 = time.perf_counter()
        result = synthesize_indices_host(
            self.q_table, self.t_table, steps, temp=cfg.temp,
            threshold=threshold, seed_id=seed_id,
            rng=np.random.default_rng(seed))
        timings = {"walk_s": time.perf_counter() - t0}

        out = {"result": result, "fps": self.fps, "frames": None,
               "frames_intp": None, "audio": self.audio,
               "sample_rate": self.sample_rate, "jump_count": None,
               "timings": timings}
        if stitch:
            if interpolate and self._interp_fn is None:
                t0 = time.perf_counter()
                self._interp_fn = maybe_make_slomo_interp_fn(
                    device=self.device)
                timings["interp_load_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            stitched = stitch_texture(
                self.video_full, result.indices, self.W, self.S, sf=cfg.SF,
                subsample_rate=self.sub, interpolate=interpolate,
                interp_fn=self._interp_fn if interpolate else None,
                frames_bar=cfg.frames_bar, source_audio=self.audio,
                audio_sample_rate=self.sample_rate, fps=self.fps)
            timings["stitch_s"] = time.perf_counter() - t0
            out["frames"] = stitched["frames"]
            out["frames_intp"] = stitched["frames_intp"]
            out["audio"] = stitched["audio"]
            out["jump_count"] = stitched["jump_count"]
        return out
