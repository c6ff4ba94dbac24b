"""End-to-end contrastive synthesis (the port of avtex/synth/pipeline.py).

``synthesize(cfg, video_path, params)`` decodes the video and calls
``synthesize_frames(cfg, frames_u8, fps, params)``, which builds a
``TextureServer`` (both towers embed every segment once), answers one
request with the cfg's knobs (the ``[L, L]`` walk on the host, then
stitching) and, with ``out_dir``, writes the videos, the per-step
entropy and survivor bar plots and the HTML report, as avtex does. With a
``logger`` it logs avtex's scalars (and with ``cfg.visualize_evaluate``,
``-ve``, the jump-frame strips and the probability-row figures).

Ported: ``model_type=1`` without driving audio, with SuperSloMo at jumps
(``interp_fn``, or one loaded from a found ``SuperSloMo.ckpt``, else the
crossfade). Not yet: driving audio, the device scan walk, multi-GPU and
CAM videos (``cfg.vcam``). Where avtex would load a pretrained encoder
file that it finds, the port raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from avtex_torch.checkpoints import (checkpoint_not_ported,
                                     find_encoder_checkpoint)
from avtex_torch.config import Config
from avtex_torch.contrastive.model import ContrastiveTextures

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _not_yet(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to avtex_torch yet: ROADMAP.md Queue 1 "
        f"'{item}'")


def init_params_for_synthesis(cfg: Config, model: nn.Module,
                              seed: Optional[int] = None
                              ) -> Dict[str, torch.Tensor]:
    """Random parameters initialised the way flax initialises avtex's
    model: ``lecun_normal`` convs (truncated normal, std
    ``sqrt(1/fan_in)/0.8796``, cut at two std), ones/zeros norm scale/bias.
    Drawn on the CPU from ``torch.Generator().manual_seed(seed)``
    (``cfg.seed`` by default); returns a float32 state_dict.

    Raises ``NotImplementedError`` for ``norm="affine"`` when a pretrained
    encoder checkpoint is found: avtex loads it into both towers here.
    """
    if cfg.norm == "affine":
        found = find_encoder_checkpoint(cfg.enc_arch)
        if found is not None:
            raise checkpoint_not_ported(
                found, f"the pretrained {cfg.enc_arch} encoder of "
                "norm=affine synthesis", "Checkpoint import and observability")
    g = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    out = {}
    for key, value in model.state_dict().items():
        leaf = key.rsplit(".", 1)[-1]
        if value.ndim == 5:  # conv kernels, OIDHW
            fan_in = math.prod(value.shape[1:])
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            t = torch.empty(value.shape, dtype=torch.float32)
            torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                        generator=g)
        elif leaf in ("scale", "weight"):
            t = torch.ones(value.shape)
        elif leaf == "bias":
            t = torch.zeros(value.shape)
        else:
            raise KeyError(f"no initialiser for parameter {key!r}")
        out[key] = t
    return out


def build_model(cfg: Config, params: Optional[Dict[str, torch.Tensor]],
                device, **encoder_kwargs: Any) -> ContrastiveTextures:
    """The port's ContrastiveTextures for ``cfg`` on ``device``, loaded
    with ``params`` (a state_dict; None -> seeded flax-style init)."""
    if cfg.model_type != 1:
        raise _not_yet("model_type=2", "Audio-conditioned synthesis, -m 2")
    model = ContrastiveTextures(
        arch=cfg.enc_arch, model_type=cfg.model_type, temp=cfg.temp,
        dtype=_DTYPES[cfg.compute_dtype], norm=cfg.norm, **encoder_kwargs)
    if params is None:
        params = init_params_for_synthesis(cfg, model)
    model.load_state_dict(params)
    return model.to(device).eval()


def synthesize(cfg: Config, video_path: str, params=None,
               audio_path: Optional[str] = None,
               driving_audio_path: Optional[str] = None,
               out_dir: Optional[str] = None, logger=None,
               walk_on_device: bool = False, device=None, interp_fn=None,
               **encoder_kwargs: Any) -> Dict:
    """Synthesize one texture from a video file (decode, then
    ``synthesize_frames``)."""
    from avtex_torch.media import read_video
    t0 = time.perf_counter()
    frames, fps = read_video(video_path)
    decode_s = time.perf_counter() - t0
    out = synthesize_frames(
        cfg, frames, fps, params,
        name=os.path.splitext(os.path.basename(video_path))[0],
        audio_path=audio_path, driving_audio_path=driving_audio_path,
        out_dir=out_dir, logger=logger, walk_on_device=walk_on_device,
        device=device, interp_fn=interp_fn, **encoder_kwargs)
    out["timings"]["decode_s"] = decode_s
    return out


def synthesize_frames(cfg: Config, frames_u8: np.ndarray, fps: float,
                      params=None, *, name: str = "texture",
                      audio_path: Optional[str] = None,
                      driving_audio_path: Optional[str] = None,
                      out_dir: Optional[str] = None, logger=None,
                      walk_on_device: bool = False, device=None,
                      interp_fn=None, **encoder_kwargs: Any) -> Dict:
    """Synthesize one texture from decoded uint8 RGB frames [T, H, W, 3]:
    ``TextureServer.from_frames`` and one request with the cfg's knobs.

    ``params`` is the port's state_dict (None: seeded flax-style init);
    ``interp_fn`` makes the frames at jumps (None: SuperSloMo from a found
    checkpoint, else the crossfade);
    ``encoder_kwargs`` reach the encoder (e.g. ``width``, ``layers``).
    ``logger`` takes ``log_scalar`` (and with ``cfg.visualize_evaluate``
    ``log_video`` and ``log_figure``), as ``avtex_torch.obs.Logger``.
    Returns {"result", "paths", "timings", "stitched", "num_segments",
    "fps", "window", "stride"}.
    """
    from .server import TextureServer  # server.py imports build_model here

    if driving_audio_path is not None:
        raise _not_yet("driving audio", "Audio-conditioned synthesis, -m 2")
    if walk_on_device:
        raise _not_yet("the device scan walk", "Device scan walk")
    if out_dir is not None and cfg.vcam:
        raise _not_yet("CAM videos (-vcam)", "Contrastive extras")
    server = TextureServer.from_frames(
        cfg, frames_u8, fps, params, audio_path=audio_path, device=device,
        name=name, interp_fn=interp_fn, **encoder_kwargs)
    out = server.synthesize()
    result = out["result"]
    stitched = {k: out[k] for k in ("frames", "frames_intp", "audio",
                                    "jump_count")}
    timings = {"embed_s": server.embed_s, **out["timings"]}

    paths = {}
    if out_dir is not None:
        from avtex_torch.media import save_texture_outputs
        from avtex_torch.obs import generate_html_report, save_bar_plot
        t0 = time.perf_counter()
        base = os.path.join(out_dir, server.cfg.eval_logname(name))
        paths = save_texture_outputs(
            out_dir, server.cfg.eval_logname(name), stitched["frames"],
            server.fps, audio=stitched["audio"],
            sample_rate=out["sample_rate"],
            frames_intp=stitched["frames_intp"], sf=server.cfg.SF)
        timings["mux_s"] = time.perf_counter() - t0
        paths["entropy_png"] = save_bar_plot(
            result.entropies, base + "_entropy.png", "per-step entropy")
        paths["nonzero_png"] = save_bar_plot(
            result.nonzero_counts, base + "_nonzero.png",
            "surviving candidates per step")
        paths["report"] = generate_html_report(
            base + "_report.html",
            {k: os.path.basename(v) for k, v in paths.items()
             if str(v).endswith((".mp4", ".avi"))},
            {"jumps": int(stitched["jump_count"]),
             "steps": len(result.indices),
             "segments": server.L,
             "seed_segment": result.seed_id})

    if logger is not None:
        _log_synthesis(logger, server, result, stitched["jump_count"])

    return {"result": out["result"], "paths": paths, "timings": timings,
            "stitched": stitched, "num_segments": server.L,
            "fps": server.fps, "window": server.W, "stride": server.S}


def _log_synthesis(logger, server, result, jump_count: int) -> None:
    """avtex's synthesis logging (avtex/synth/pipeline.py:230-263): the
    per-step entropy and survivor count, the jump count and, with ``-ve``,
    the query/choice frame strips at jumps and each step's logit row."""
    for i, e in enumerate(result.entropies):
        logger.log_scalar(float(e), "synth/entropy", i)
        logger.log_scalar(int(result.nonzero_counts[i]), "synth/nonzero", i)
    # jumps past the first step only, as stitch_texture counts them
    logger.log_scalar(int(jump_count), "synth/jump_count", 0)
    if not server.cfg.visualize_evaluate:
        return
    W, S, video = server.W, server.S, server.video
    prev = result.seed_id
    for i, q_id in enumerate(result.indices):
        if bool(result.jumps[i]) and i > 0:
            logger.log_video(video[prev * S:prev * S + W],
                             "synth/jump_query", i)
            logger.log_video(video[int(q_id) * S:int(q_id) * S + W],
                             "synth/jump_choice", i)
        prev = int(q_id)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    probs = ((server.q_table @ server.t_table.T) / server.cfg.temp
             ).float().cpu().numpy()
    for i, q_id in enumerate([result.seed_id] + list(result.indices[:-1])):
        fig = plt.figure()
        ax = fig.add_subplot(1, 1, 1)
        im = ax.imshow(np.tile(probs[int(q_id)], (20, 1)),
                       interpolation="nearest", aspect="auto")
        fig.colorbar(im)
        logger.log_figure(fig, "synth/probs_queryframe", i)
        plt.close(fig)
