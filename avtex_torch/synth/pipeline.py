"""End-to-end contrastive synthesis (the port of avtex/synth/pipeline.py).

``synthesize(cfg, video_path, params)`` decodes the video and calls
``synthesize_frames(cfg, frames_u8, fps, params)``, which builds a
``TextureServer`` (both towers embed every segment once), answers one
request with the cfg's knobs (the ``[L, L]`` walk on the host, or on the
device with ``walk_on_device=True``, then stitching) and, with
``out_dir``, writes the videos, the per-step entropy and survivor bar
plots and the HTML report, as avtex does. With a
``logger`` it logs avtex's scalars (and with ``cfg.visualize_evaluate``,
``-ve``, the jump-frame strips and the probability-row figures).

Ported: ``model_type=1`` and ``model_type=2`` (video + the source's
log-mel examples through a shared VGGish; a found ``pytorch_vggish.pth``
is grafted in at random init), driving audio (``driving_audio_path``:
``-daf VGG`` or ``Mel`` rows blended with weight ``1 - cfg.alpha``, the
audio-matched seed segment, the length clipped to the driving clip, the
driving waveform as the output track), SuperSloMo at jumps
(``interp_fn``, or one loaded from a found ``SuperSloMo.ckpt``, else the
crossfade), ``-daf Contrastive`` (the ``VideoForAudio`` retrieval head,
random or from ``-daf_resume``) and, with ``out_dir`` and ``cfg.vcam``
(``-vcam``), the CAM videos ``_cam_q.mp4`` and ``_cam_p.mp4``
(``avtex_torch/synth/cam.py``). Under ``norm="affine"`` without given
parameters, a pretrained encoder file that ``find_encoder_checkpoint``
finds is loaded into both towers, BatchNorm folded, as avtex does. Not
yet: multi-GPU.

Rates: source and driving examples are computed at ``sr * sub``, not
``sr`` (the reference's quirk, kept by avtex), the source waveform
clipped to the encoded frames' span.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from avtex_torch.checkpoints import (maybe_load_encoder_into_model,
                                     maybe_load_vggish,
                                     maybe_load_vggish_into_model)
from avtex_torch.config import Config
from avtex_torch.contrastive.audio_retrieval import (
    VideoForAudio, embed_video_table, video_for_audio_logits)
from avtex_torch.contrastive.model import ContrastiveTextures
from avtex_torch.convert import convert_params
from avtex_torch.device import resolve_device
from avtex_torch.nn.vggish import VGGish

from .cam import cam_step_frames, segment_cams
from .embeddings import vggish_audio_features
from .engine import driving_audio_logits, seed_segment

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _not_yet(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to avtex_torch yet: ROADMAP.md Queue 1 "
        f"'{item}'")


def flax_style_init(model: nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """Random parameters initialised the way flax initialises avtex's
    modules: ``lecun_normal`` kernels (truncated normal, std
    ``sqrt(1/fan_in)/0.8796``, cut at two std) for conv kernels (3-D
    ``Conv1d``, 4-D and 5-D, fan_in = C_in x kernel size) and 2-D
    ``Linear`` weights (fan_in = in_features), ones/zeros norm
    scale/bias, zero conv and ``Linear`` biases. Any other ``weight``
    shape than a 1-D norm scale raises. Drawn on the CPU from
    ``torch.Generator().manual_seed(seed)`` in state_dict order; returns
    a float32 state_dict."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for key, value in model.state_dict().items():
        leaf = key.rsplit(".", 1)[-1]
        if value.ndim in (4, 5) or (leaf == "weight" and value.ndim in (2, 3)):
            # Linear [out, in], Conv1d [out, in, k], OIHW, OIDHW
            fan_in = math.prod(value.shape[1:])
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            t = torch.empty(value.shape, dtype=torch.float32)
            torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                        generator=g)
        elif leaf in ("scale", "weight") and value.ndim == 1:
            t = torch.ones(value.shape)
        elif leaf == "bias":
            t = torch.zeros(value.shape)
        else:
            raise KeyError(f"no initialiser for parameter {key!r} of shape "
                           f"{tuple(value.shape)}")
        out[key] = t
    return out


def init_params_for_synthesis(cfg: Config, model: nn.Module,
                              seed: Optional[int] = None
                              ) -> Dict[str, torch.Tensor]:
    """``flax_style_init(model, seed)`` (``cfg.seed`` by default); for
    ``model_type=2`` a found ``pytorch_vggish.pth`` is grafted into the
    shared VGGish (a loud warning without one); for ``norm="affine"`` a
    found pretrained encoder file (``$AVTEX_ENCODER_CKPT``,
    ``pretrained/<file>``) into both towers' video encoders, in avtex's
    order. The call order of a BN-folded import comes from ``model``'s
    query encoder on a zero clip of ``cfg.window`` frames.
    """
    out = flax_style_init(model, cfg.seed if seed is None else seed)
    if cfg.model_type == 2:
        out, _ = maybe_load_vggish_into_model(
            out, context="model_type=2 synthesis (random init)")
    if cfg.norm == "affine":
        # The affine configuration exists to run pretrained frozen-BN
        # imports: random affine weights defeat it.
        q = getattr(model, "q_embedder", None)
        out, _ = maybe_load_encoder_into_model(
            cfg.enc_arch, out, window=cfg.window,
            encoder=None if q is None else q.video_encoder,
            context="norm=affine synthesis (no trained checkpoint)")
    return out


def build_model(cfg: Config, params: Optional[Dict[str, torch.Tensor]],
                device, **encoder_kwargs: Any) -> ContrastiveTextures:
    """The port's ContrastiveTextures for ``cfg`` on ``device``, loaded
    with ``params`` (a state_dict; None -> seeded flax-style init)."""
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
    ``audio_path`` is the source's wav (needed for ``model_type=2`` and
    driving audio), ``driving_audio_path`` a driving wav (its waveform
    becomes the output track);
    ``interp_fn`` makes the frames at jumps (None: SuperSloMo from a found
    checkpoint, else the crossfade);
    ``encoder_kwargs`` reach the encoder (e.g. ``width``, ``layers``).
    ``logger`` takes ``log_scalar`` (and with ``cfg.visualize_evaluate``
    ``log_video`` and ``log_figure``), as ``avtex_torch.obs.Logger``.
    Returns {"result", "paths", "timings", "stitched", "num_segments",
    "fps", "window", "stride"}.
    """
    from .server import TextureServer  # server.py imports build_model here

    server = TextureServer.from_frames(
        cfg, frames_u8, fps, params, audio_path=audio_path, device=device,
        name=name, interp_fn=interp_fn, **encoder_kwargs)
    out = server.synthesize(driving_audio=driving_audio_path,
                            walk_on_device=walk_on_device)
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
        if server.cfg.vcam:
            t0 = time.perf_counter()
            paths.update(_cam_videos(server, result, base))
            timings["cam_s"] = time.perf_counter() - t0
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


def _cam_videos(server, result, base: str) -> Dict[str, str]:
    """``-vcam``: the query tower's CAM of every segment, overlaid per step
    on the query segment's and its successor's centre frames, written as
    ``<base>_cam_q.mp4`` and ``_cam_p.mp4`` (avtex/synth/pipeline.py:
    192-225). Where ``segment_cams`` raises ``ValueError`` (a 2D
    frame-mean encoder, or ``model_type=2`` without source audio), warns
    and writes none."""
    import sys

    from avtex_torch.media import write_video
    try:
        cams = segment_cams(server.model, server.video, server.W, server.S,
                            server.L, audio_examples=server.audio_examples,
                            tower="query", img_size=server.cfg.img_size)
    except ValueError as e:
        print(f"[avtex_torch] WARNING: skipping CAM videos ({e})",
              file=sys.stderr)
        return {}
    q_ids = np.concatenate([[result.seed_id],
                            np.asarray(result.indices[:-1])])
    q_frames, p_frames = cam_step_frames(server.video, cams, q_ids,
                                         server.W, server.S)
    return {"cam_q_video": write_video(q_frames, base + "_cam_q.mp4",
                                       server.fps),
            "cam_p_video": write_video(p_frames, base + "_cam_p.mp4",
                                       server.fps)}


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


def make_audio_scorer(cfg: Config, video, audio_examples, L: int, W: int,
                      S: int, device=None):
    """The reusable driving-audio scoring state for ``cfg.da_feats`` (the
    port of avtex/synth/pipeline.py:309-416).

    "Contrastive" scores the driving examples' ``VideoForAudio`` audio
    embeddings against its ``[L, 128]`` video table, embedded here once
    from the ``[T, H, W, 3]`` uint8 ``video``'s segments (``W``, ``S``) in
    ``cfg.mini_batchsize`` chunks; the arch is ``cfg.enc_arch``
    (``slowfast`` becomes ``resnet18``), the module bf16 whatever
    ``cfg.compute_dtype`` is and seeded flax-style from ``cfg.seed``, then
    overwritten by avtex's checkpoint at ``cfg.daf_resume[0]`` when that
    file exists. Its seed segment is None without source audio.
    "Mel" scores raw flattened log-mel examples; "VGG" (the reference's
    default) raw VGGish conv features, from a VGGish at its default bf16
    whatever ``cfg.compute_dtype`` is (as avtex), seeded flax-style from
    seed 0 and overwritten by a found ``pytorch_vggish.pth`` (a loud
    warning without one). What depends only on the source (the modules,
    the per-segment source features or video table) is computed here
    once; the returned ``score(driving_examples, steps) -> (audio_logits
    [steps, L], seed_id)`` does only per-request work. ``audio_examples``
    are the source's [N, 100, 64] examples (or None).
    """
    if cfg.da_feats == "Contrastive":
        return ContrastiveScorer(cfg, video, audio_examples, L, W, S,
                                 resolve_device(device))
    if audio_examples is None:
        raise ValueError(
            f"driving audio given with -daf {cfg.da_feats} but the source "
            "video has no audio track (-adata): VGG/Mel modes score "
            "driving audio against source audio. Provide the source wav "
            "or use -daf Contrastive.")
    if cfg.da_feats not in ("VGG", "Mel"):
        raise ValueError(f"unknown -daf {cfg.da_feats!r}")
    dev = resolve_device(device)
    source = torch.as_tensor(audio_examples).to(dev)

    if cfg.da_feats == "Mel":
        def featurize(examples):
            return examples.reshape(len(examples), -1)
    else:
        vg = VGGish()
        state, _ = maybe_load_vggish(flax_style_init(vg, 0),
                                     context="-daf VGG scoring")
        vg.load_state_dict(state)
        vg = vg.to(dev).eval()

        def featurize(examples):
            return vggish_audio_features(vg, examples)

    # source rows aligned to segment ids, clipped to the last example
    seg_ids = np.minimum(np.arange(L), len(source) - 1)
    src_rows = featurize(source)[torch.from_numpy(seg_ids).to(dev)]

    def score(driving_examples, steps: int):
        drv_ex = torch.as_tensor(driving_examples).to(dev)
        ids = np.minimum(np.arange(steps), len(drv_ex) - 1)
        drv = featurize(drv_ex)[torch.from_numpy(ids).to(dev)]
        audio_logits = driving_audio_logits(src_rows, drv, cfg.temp)
        seed_id = seed_segment(source, drv_ex[0], num_segments=L)
        return audio_logits, seed_id

    return score


class ContrastiveScorer:
    """``make_audio_scorer``'s "Contrastive" state (avtex/synth/
    pipeline.py:323-369): ``vfa`` (the ``VideoForAudio`` module, on its
    device), ``video_table`` (``[L, 128]`` unit rows, fp32) and the
    source's examples (or None). Called as ``score(driving_examples,
    steps) -> (audio_logits [steps, L], seed_id or None)``."""

    def __init__(self, cfg: Config, video, audio_examples, L: int, W: int,
                 S: int, dev: torch.device):
        from avtex_torch.train.checkpoint import restore_checkpoint

        self.L, self.temp = L, cfg.temp
        vfa = VideoForAudio(arch=(cfg.enc_arch if cfg.enc_arch != "slowfast"
                                  else "resnet18"), temp=cfg.temp)
        payload = (restore_checkpoint(cfg.daf_resume[0]) if cfg.daf_resume
                   else None)
        vfa.load_state_dict(flax_style_init(vfa, cfg.seed) if payload is None
                            else convert_params(payload["state"], vfa))
        self.vfa = vfa.to(dev).eval()
        self.video_table = embed_video_table(
            self.vfa, video, W, S, L, cfg.img_size,
            max(cfg.mini_batchsize, 1))
        self.source = (None if audio_examples is None
                       else torch.as_tensor(audio_examples).to(dev))

    def __call__(self, driving_examples, steps: int):
        dev = self.video_table.device
        drv_ex = torch.as_tensor(driving_examples).to(dev)
        ids = np.minimum(np.arange(steps), len(drv_ex) - 1)
        audio_logits = video_for_audio_logits(
            self.vfa, drv_ex[torch.from_numpy(ids).to(dev)],
            self.video_table, self.temp)
        seed_id = (None if self.source is None else
                   seed_segment(self.source, drv_ex[0], num_segments=self.L))
        return audio_logits, seed_id


def driving_audio_rows(cfg: Config, video, audio_examples, driving_examples,
                       steps: int, L: int, W: int, S: int, device=None):
    """One-shot ``make_audio_scorer(...)(driving_examples, steps)``:
    (audio_logits [steps, L], seed_id)."""
    return make_audio_scorer(cfg, video, audio_examples, L, W, S,
                             device)(driving_examples, steps)
