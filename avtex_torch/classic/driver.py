"""Classic video-textures driver: the sigma sweep end to end (the port of
avtex/classic/driver.py).

``run_classic(cfg, video_path, ...)`` decodes the video and calls
``run_classic_frames(cfg, frames_u8, fps, ...)``, which does the rest:
features, then per sigma D1 -> D2 (strided only in mode 3) -> value
iteration -> threshold -> the walk, all on the device, one fetch of the
walk and the sigmas, then the frame ids, the position bars, the
interpolated track (mode 1) and the outputs. D1 is recomputed per sigma,
as avtex does. The thresholded matrix reaches the host only for the
logger's figures.

The walk is ``sample_texture_walk`` with a ``torch.Generator`` on the
device seeded ``cfg.seed + i`` for the i-th sigma; avtex walks on the
device with ``jax.random.key(cfg.seed + i)``, which torch cannot
reproduce: the same distribution, another stream. Jumps are interpolated
with ``interp_fn`` if given, else (mode 1) with SuperSloMo from a
checkpoint that ``find_slomo_checkpoint`` finds, loaded once per run,
else with the native crossfade (``avtex_torch.native.stitch``), as avtex
does.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from avtex_torch.checkpoints import maybe_make_slomo_interp_fn
from avtex_torch.config import ClassicConfig
from avtex_torch.device import resolve_device
from avtex_torch.obs import Logger
from avtex_torch.synth.interp import InterpFn
from avtex_torch.native.stitch import crossfade

from .d1 import compute_d1, distance_to_transition_probs
from .d2 import compute_d2
from .features import frame_features
from .future_cost import anticipated_future_cost, threshold_rows
from .interp_track import burn_position_bars, classic_interp_track
from .sampler import expand_walk_to_frames, sample_texture_walk


def run_classic(cfg: ClassicConfig, video_path: str,
                audio_path: Optional[str] = None,
                out_dir: Optional[str] = None,
                logger: Optional[Logger] = None,
                num_steps: Optional[int] = None,
                interp_fn: Optional[InterpFn] = None,
                device=None) -> Dict:
    """Run the full classic pipeline on one video file; outputs go to
    ``out_dir`` (default ``cfg.results_folder``)."""
    from avtex_torch.media import read_video, read_wav
    frames, fps = read_video(video_path)
    audio, sr = None, cfg.sr
    if audio_path is not None and os.path.exists(audio_path):
        audio, sr = read_wav(audio_path)
    return run_classic_frames(
        cfg, frames, fps,
        name=os.path.splitext(os.path.basename(video_path))[0],
        audio=audio, sample_rate=sr, out_dir=out_dir or cfg.results_folder,
        logger=logger, num_steps=num_steps, interp_fn=interp_fn,
        device=device)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_classic_frames(cfg: ClassicConfig, frames_u8: np.ndarray, fps: float,
                       *, name: str = "texture",
                       audio: Optional[np.ndarray] = None,
                       sample_rate: Optional[int] = None,
                       out_dir: Optional[str] = None,
                       logger: Optional[Logger] = None,
                       num_steps: Optional[int] = None,
                       interp_fn: Optional[InterpFn] = None,
                       device=None) -> Dict:
    """Run the classic pipeline on decoded uint8 RGB frames [T, H, W, 3].

    Returns {"sigma_results": {sigma: entry}, "jump_counts": {sigma: n}}.
    Each entry holds "walk", "jump_count", "frame_ids", "sigmas"
    (D1, D2, D3), "p3_new" (the thresholded matrix the walk used, on the
    device), "sweeps"
    (value-iteration sweeps), "timings" (seconds per stage) and "paths";
    with ``out_dir=None`` no file is written and the entry holds the
    texture's "frames", "frames_intp" and "audio" instead.
    """
    dev = resolve_device(device)
    if cfg.interpolation and cfg.model_type == 1 and interp_fn is None:
        interp_fn = maybe_make_slomo_interp_fn(device=dev)
    frames = np.asarray(frames_u8)
    sr = sample_rate or cfg.sr
    audio_examples = None
    if cfg.feats == "ResNet_VGGish" and audio is not None:
        from avtex_torch.audio import waveform_to_examples
        audio_examples = waveform_to_examples(audio, sr, device=dev)
    feats, normalize = frame_features(cfg.feats, frames, dev, audio_examples,
                                      cfg.filter_size, cfg.stride)
    if num_steps is None:
        num_steps = int(cfg.new_video_length * fps)

    results: Dict = {"sigma_results": {}, "jump_counts": {}}
    for i, sigma_factor in enumerate(cfg.sigmas):
        t: Dict[str, float] = {}
        t0 = time.perf_counter()

        def lap(key: str, sync: bool = False) -> None:
            nonlocal t0
            if sync:
                _sync(dev)
            now = time.perf_counter()
            t[key] = now - t0
            t0 = now

        d1, p1, s1 = compute_d1(feats, sigma_factor, normalize=normalize)
        lap("d1_s", sync=True)
        stride = cfg.stride if cfg.model_type == 3 else 1
        d2, p2, s2 = compute_d2(d1, sigma_factor, cfg.filter_size, stride)
        lap("d2_s", sync=True)
        d3, sweeps = anticipated_future_cost(
            d2, p=cfg.q_p, alpha=cfg.q_alpha, eps=cfg.q_eps,
            return_sweeps=True)
        p3, s3 = distance_to_transition_probs(d3, sigma_factor)
        p3_new = threshold_rows(p3, cfg.threshold)
        lap("d3_s", sync=True)

        n = p3_new.shape[0]
        start = min(cfg.start_frame, n - 1)
        # mode 2 transitions from min(chosen + stride, n-1) and clips its
        # emitted blocks to the MATRIX size, not the frame count
        adv = cfg.stride if cfg.model_type == 2 else 0
        walk, jumps = sample_texture_walk(
            p3_new, start, num_steps,
            generator=torch.Generator(device=dev).manual_seed(cfg.seed + i),
            advance=adv)
        lap("walk_s", sync=True)
        walk, jumps = walk.cpu().numpy(), jumps.cpu().numpy()
        sigmas = tuple(float(s) for s in torch.stack([s1, s2, s3]).cpu())
        lap("fetch_s")
        clip_n = n if cfg.model_type == 2 else len(frames)
        frame_ids = expand_walk_to_frames(
            walk, cfg.model_type, cfg.stride, cfg.filter_size, clip_n)
        frame_ids = np.clip(frame_ids, 0, len(frames) - 1)

        # main track: red position bar burned into every frame, always
        tex_frames = burn_position_bars(frames[frame_ids], frame_ids,
                                        len(frames))
        tex_audio = None
        if audio is not None:
            apf = int(sr / fps)
            tex_audio = np.concatenate(
                [audio[f * apf:(f + 1) * apf] for f in frame_ids])
        lap("bars_s")
        frames_intp = None
        if cfg.interpolation and cfg.model_type == 1:
            # jump-interpolated track at fps*(SF+1)/2
            frames_intp = classic_interp_track(
                frames, walk, cfg.SF, interp_fn or crossfade, len(frames))
        lap("interp_s")

        entry = {"walk": walk, "jump_count": int(jumps.sum()),
                 "frame_ids": frame_ids, "sigmas": sigmas,
                 "p3_new": p3_new, "sweeps": sweeps, "timings": t,
                 "paths": {}}
        if out_dir is not None:
            from avtex_torch.media import save_texture_outputs
            entry["paths"] = save_texture_outputs(
                out_dir, f"{name}_classic_m{cfg.model_type}_sigma"
                         f"{sigma_factor}",
                tex_frames, fps, audio=tex_audio, sample_rate=sr,
                frames_intp=frames_intp, sf=cfg.SF)
            lap("write_s")
        else:
            entry.update(frames=tex_frames, frames_intp=frames_intp,
                         audio=tex_audio)
        results["sigma_results"][sigma_factor] = entry
        results["jump_counts"][sigma_factor] = entry["jump_count"]

        if logger is not None:
            _log_matrices(logger, i, D1=d1, P1=p1, D2=d2, P2=p2, D3=d3,
                          P3=p3, P3_new=p3_new)

    if logger is not None:
        _log_jump_counts(logger, results["jump_counts"])
    return results


def _log_matrices(logger: Logger, step: int, **mats: torch.Tensor) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    for tag, mat in mats.items():
        fig = plt.figure()
        ax = fig.add_subplot(1, 1, 1)
        im = ax.imshow(mat.cpu().numpy(), interpolation="nearest")
        fig.colorbar(im)
        logger.log_figure(fig, f"classic/{tag}", step)
        plt.close(fig)


def _log_jump_counts(logger: Logger, jump_counts: Dict) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = plt.figure()
    ax = fig.add_subplot(1, 1, 1)
    ax.bar([str(s) for s in jump_counts], list(jump_counts.values()))
    ax.set_xlabel("sigma factor")
    ax.set_ylabel("jumps")
    logger.log_figure(fig, "classic/jump_counts", 0)
    plt.close(fig)
