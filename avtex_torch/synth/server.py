"""Warm-process texture serving: embed once, synthesize many (the port of
avtex/synth/server.py:36-198).

    server = TextureServer.from_frames(cfg, frames_u8, fps, params,
                                       audio_path="surf.wav")
    a = server.synthesize(seconds=30, threshold=0.4, seed=1)
    b = server.synthesize(seconds=60, threshold=0.2, seed=2)
    c = server.synthesize(seconds=30, driving_audio="song.wav", alpha=0.5)

The decoded frames, the source's log-mel examples and both embedding
tables stay resident; each request is one walk over the ``[L, L]``
logits (on the host by default, on the tables' device with
``walk_on_device=True``) plus stitching, with SuperSloMo at jumps when
interpolating: ``interp_fn`` if given, else one loaded once per server
from a checkpoint that ``find_slomo_checkpoint`` finds, else the
crossfade. A driving-audio request featurises only its own wav: the
scoring state of ``cfg.da_feats`` (VGGish and the source's features) is
built on the first such request and kept. ``TextureServer(cfg,
video_path, params)`` decodes the file first.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from avtex_torch.audio import waveform_to_examples
from avtex_torch.checkpoints import maybe_make_slomo_interp_fn
from avtex_torch.config import Config
from avtex_torch.contrastive.segments import require_segments
from avtex_torch.device import resolve_device

from .embeddings import precompute_embeddings_from_video
from .engine import (num_synthesis_steps, synthesize_indices,
                     synthesize_indices_host)
from .interp import InterpFn
from .pipeline import build_model, make_audio_scorer
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
        self.audio_examples = None
        if audio_path is not None and os.path.exists(audio_path):
            from avtex_torch.media import read_wav
            self.audio, self.sample_rate = read_wav(audio_path)
            # examples on the subsampled timeline (rate scaled by sub),
            # the waveform clipped to the encoded frames' span
            apf = int(np.floor(self.sample_rate * self.sub / self.fps))
            self.audio = self.audio[: len(self.video) * apf]
            self.audio_examples = waveform_to_examples(
                self.audio, self.sample_rate * self.sub, device=self.device)
        self._scorers: Dict[str, Any] = {}

        self.model = build_model(self.cfg, params, self.device,
                                 **encoder_kwargs)
        t0 = time.perf_counter()
        self.q_table, self.t_table = precompute_embeddings_from_video(
            self.model, self.video, self.W, self.S, self.L,
            self.audio_examples, img_size=self.cfg.img_size,
            batch_size=max(self.cfg.mini_batchsize, 1))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.embed_s = time.perf_counter() - t0

    def _scorer(self):
        """The driving-audio scoring state of ``cfg.da_feats``, built once
        per server and mode."""
        mode = self.cfg.da_feats
        if mode not in self._scorers:
            self._scorers[mode] = make_audio_scorer(
                self.cfg, self.video, self.audio_examples, self.L, self.W,
                self.S, self.device)
        return self._scorers[mode]

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
        default to the server's cfg. With ``driving_audio`` (a wav path)
        the length is clipped to the driving clip, the walk starts at the
        segment whose audio best matches the clip's first example and
        blends the clip's rows with weight ``1 - alpha``; ``audio`` is
        then the raw driving waveform at its own rate (``sample_rate``
        says which), and ``timings["audio_rows_s"]`` the time to the rows
        (``"scorer_s"`` of it when this request built the scoring state).
        Until the server has an ``interp_fn``, an interpolating request
        looks for a SuperSloMo checkpoint and loads it (kept for later
        requests), reporting the time as ``timings["interp_load_s"]``.
        ``walk_on_device=True`` walks on the tables' device
        (``synthesize_indices``, its noise from a ``torch.Generator``
        seeded with ``seed``) instead of the host walk's
        ``np.random.default_rng(seed)``.
        """
        cfg = self.cfg
        seconds = cfg.new_video_length if seconds is None else seconds
        threshold = cfg.threshold if threshold is None else threshold
        alpha = cfg.alpha if alpha is None else alpha
        seed = cfg.seed if seed is None else seed
        interpolate = (cfg.interpolation if interpolate is None
                       else interpolate)
        seed_id = (cfg.start_segment if seed_segment_id is None
                   else seed_segment_id)
        max_length = int(seconds * self.fps)  # original-rate frames
        timings: Dict[str, float] = {}
        audio_logits, drv, d_sr = None, None, self.sample_rate
        t0 = time.perf_counter()
        if driving_audio is not None:
            from avtex_torch.media import read_wav
            if cfg.da_feats not in self._scorers:
                self._scorer()
                timings["scorer_s"] = time.perf_counter() - t0
            drv, d_sr = read_wav(driving_audio)
            # scaled like the source examples; the output track stays the
            # raw waveform at d_sr
            drv_eg = waveform_to_examples(drv, d_sr * self.sub,
                                          device=self.device)
            max_length = min(max_length,
                             int(len(drv_eg) / 10 * self.fps) * self.sub)
        steps = num_synthesis_steps(-(-max_length // self.sub), self.W,
                                    self.S)
        if driving_audio is not None:
            audio_logits, seed_id = self._scorer()(drv_eg, steps)
            if not walk_on_device:
                audio_logits = audio_logits.cpu()
            timings["audio_rows_s"] = time.perf_counter() - t0
        seed_id = min(seed_id, self.L - 1)
        t0 = time.perf_counter()
        walk = dict(temp=cfg.temp, threshold=threshold, alpha=alpha,
                    audio_logits=audio_logits, seed_id=seed_id)
        if walk_on_device:
            result = synthesize_indices(self.q_table, self.t_table, steps,
                                        seed=seed, **walk)
        else:
            result = synthesize_indices_host(
                self.q_table, self.t_table, steps,
                rng=np.random.default_rng(seed), **walk)
        timings["walk_s"] = time.perf_counter() - t0

        out = {"result": result, "fps": self.fps, "frames": None,
               "frames_intp": None,
               "audio": drv if drv is not None else self.audio,
               "sample_rate": d_sr, "jump_count": None,
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
                frames_bar=cfg.frames_bar,
                source_audio=self.audio if drv is None else None,
                audio_sample_rate=self.sample_rate, fps=self.fps)
            timings["stitch_s"] = time.perf_counter() - t0
            out["frames"] = stitched["frames"]
            out["frames_intp"] = stitched["frames_intp"]
            out["audio"] = stitched["audio"] if drv is None else drv
            out["jump_count"] = stitched["jump_count"]
        return out
