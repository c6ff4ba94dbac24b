"""Contrastive video-textures CLI (the port of avtex/cli/main.py), with the
same flags plus ``-device``.

Ported: the synthesis branch, ``-e``, for ``-m 1`` and ``-m 2`` (which
needs ``<adata>/<video>.wav``): per video, derive W/S from the fps,
restore the checkpoint at ``-resume`` or the path derived from the flags
(``Config.default_ckpt_path``; avtex's flax msgpack file, read by
``avtex_torch.train.restore_checkpoint``), synthesize and write the
texture, the bar plots and the report under ``results_<video>``. With
``-da`` the i-th driving wav (``<dadata>/<name>.wav``) pairs with the
i-th video, as in avtex, scored by ``-daf VGG`` or ``Mel`` and blended
with weight ``1 - alpha``; results go under
``results_<video>_target_<video>_<audio>``. Training (no ``-e``),
``--mesh`` and ``-daf Contrastive`` raise ``NotImplementedError`` naming
their ROADMAP.md Queue 1 item.

One deviation from avtex: ``-rf/-results_folder`` defaults to None, and
any folder given is the parent of the per-video folder (avtex ignores an
explicit ``-rf results``, its default's value).

Usage:
  python -m avtex_torch.cli.main -m 1 -e -vdata data/videos -vl clip
  python -m avtex_torch.cli.main -m 2 -e -vdata data/videos \
      -adata data/audio -vl clip -da song -dadata audio/target -daf VGG

Decoding needs OpenCV; on a host without it drive
``avtex_torch.synth.synthesize_frames`` from decoded frames.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import List


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("avtex_torch contrastive video textures")
    p.add_argument("-m", "--model_type", type=int, default=1,
                   help="(1) video textures (2) audio+video textures")
    p.add_argument("-e", "--evaluate", action="store_true")
    p.add_argument("-ve", "--visualize_evaluate", action="store_true",
                   help="log extra synthesis figures")
    p.add_argument("-ea", "--enc_arch", default="resnet18")
    p.add_argument("-vdata", default=None, help="dir of <name>.mp4 videos")
    p.add_argument("-adata", default=None, help="dir of <name>.wav audio")
    p.add_argument("-dadata", default="audio/target")
    p.add_argument("-vl", "--video_list", nargs="+", default=None)
    p.add_argument("-da", "--driving_audio", nargs="+", default=None)
    p.add_argument("-daf", "--da_feats", default="VGG",
                   choices=["VGG", "Contrastive", "Mel"])
    p.add_argument("-alpha", type=float, default=0.5)
    p.add_argument("-w", "--window", type=int, default=20)
    p.add_argument("-stride", type=int, default=4)
    p.add_argument("-train_stride", type=int, default=None)
    p.add_argument("-temp", type=float, default=0.1)
    p.add_argument("-th", "--threshold", type=float, default=0.0)
    p.add_argument("-bs", "--batch_size", type=int, default=32)
    p.add_argument("-mbs", "--mini_batchsize", type=int, default=150)
    p.add_argument("-negs", "--n_negs", type=int, default=20)
    p.add_argument("-size", "--img_size", type=int, default=224)
    p.add_argument("-subsample", "--subsample_rate", type=int, default=1)
    p.add_argument("-nvl", "--new_video_length", type=int, default=30)
    p.add_argument("-SF", type=int, default=5)
    p.add_argument("-nintp", dest="interpolation", action="store_false")
    p.add_argument("-noaug", dest="augment", action="store_false")
    p.add_argument("-fb", "--frames_bar", action="store_true")
    p.add_argument("-norm", choices=["group", "affine"], default="group")
    p.add_argument("-vcam", action="store_true")
    p.add_argument("-epochs", type=int, default=60)
    p.add_argument("-lr", type=float, default=1e-2)
    p.add_argument("-lr_steps", type=int, default=30)
    p.add_argument("-momentum", type=float, default=0.9)
    p.add_argument("-wd", "--weight_decay", type=float, default=1e-4)
    p.add_argument("-workers", "-j", type=int, default=0)
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-resume", "--resume", default="")
    p.add_argument("-allow_random_init", action="store_true",
                   help="synthesize with random-init params when no "
                        "checkpoint is found")
    p.add_argument("-daf_resume", "--daf_resume", nargs="+", default=None)
    p.add_argument("-fps", type=float, default=None,
                   help="override container fps")
    p.add_argument("-l2", action="store_true",
                   help="accepted for parity (embeddings are always "
                        "L2-normalized)")
    p.add_argument("-long", "--long", action="store_true",
                   help="accepted for parity; unused")
    p.add_argument("-pdata", default=None, help="accepted for parity")
    p.add_argument("-fdata", default=None, help="accepted for parity")
    p.add_argument("-p", "--print_freq", type=int, default=5)
    p.add_argument("-lf", "--log_freq", type=int, default=10)
    p.add_argument("-vf", "--val_freq", type=int, default=5)
    p.add_argument("--start_epoch", type=int, default=None)
    p.add_argument("-logdir", default="./logs")
    p.add_argument("-logname", default="exp")
    p.add_argument("-rf", "-results_folder", "--results_folder",
                   default=None,
                   help="parent directory of results_<video> (default: "
                        "the working directory)")
    p.add_argument("-ckpt", default="./ckpt")
    p.add_argument("--mesh", action="store_true",
                   help="shard over all local devices (not ported)")
    p.add_argument("-device", default=None,
                   help="torch device (default: cuda; 'cpu' to run there)")
    return p


def args_to_config(args: argparse.Namespace):
    from avtex_torch.config import Config
    return Config(
        enc_arch=args.enc_arch, model_type=args.model_type,
        temp=args.temp, threshold=args.threshold, img_size=args.img_size,
        vdata=args.vdata, adata=args.adata, dadata=args.dadata,
        video_list=args.video_list, subsample_rate=args.subsample_rate,
        window=args.window, stride=args.stride,
        train_stride=args.train_stride, fps_override=args.fps,
        n_negs=args.n_negs, new_video_length=args.new_video_length,
        alpha=args.alpha, interpolation=args.interpolation, SF=args.SF,
        augment=args.augment, frames_bar=args.frames_bar, vcam=args.vcam,
        norm=args.norm, driving_audio=args.driving_audio,
        da_feats=args.da_feats, seed=args.seed, epochs=args.epochs,
        batch_size=args.batch_size, mini_batchsize=args.mini_batchsize,
        lr=args.lr, lr_steps=args.lr_steps, momentum=args.momentum,
        weight_decay=args.weight_decay, workers=args.workers,
        daf_resume=args.daf_resume, print_freq=args.print_freq,
        log_freq=args.log_freq, val_freq=args.val_freq,
        start_epoch=args.start_epoch, resume=args.resume,
        evaluate=args.evaluate, allow_random_init=args.allow_random_init,
        visualize_evaluate=args.visualize_evaluate, logdir=args.logdir,
        logname=args.logname, results_folder=args.results_folder,
        ckpt=args.ckpt)


def discover_video_list(vdata: str) -> List[str]:
    """Every file's name up to its first dot in ``vdata``, sorted, without
    hidden files, subdirectories or duplicates (avtex's rule)."""
    names = sorted(f.split(".")[0] for f in sorted(os.listdir(vdata))
                   if not f.startswith(".")
                   and os.path.isfile(os.path.join(vdata, f)))
    out: List[str] = []
    for n in names:
        if n not in out:
            out.append(n)
    return out


def per_video_config(cfg, video_name: str, itr: int = 0):
    """``cfg`` for video #``itr``, as avtex specialises it: the ``-da``
    and ``-daf_resume`` entries pair with the videos by index (not as a
    cross product); results go under ``results_<video>``, with
    ``_target_<video>_<audio>`` appended when synthesizing with driving
    audio, inside ``cfg.results_folder`` when one was given."""
    da, daf = cfg.driving_audio, cfg.daf_resume
    for flag, entries in (("-da", da), ("-daf_resume", daf)):
        if entries and itr >= len(entries):
            raise ValueError(
                f"{flag} lists {len(entries)} entries for {itr + 1}+ "
                f"videos; they pair with the videos by index: pass one "
                f"per video.")
    da = [da[itr]] if da else da
    daf = [daf[itr]] if daf else daf
    rf = f"results_{video_name}"
    if (cfg.evaluate or cfg.visualize_evaluate) and da:
        rf += f"_target_{video_name}_{os.path.split(da[0])[-1].split('.')[0]}"
    if cfg.results_folder:
        rf = os.path.join(cfg.results_folder, rf)
    return dataclasses.replace(cfg, driving_audio=da, daf_resume=daf,
                               results_folder=rf)


def _refuse_unported(args: argparse.Namespace) -> None:
    from avtex_torch.synth.pipeline import _not_yet
    if args.driving_audio and args.da_feats == "Contrastive":
        raise _not_yet("-daf Contrastive (the VideoForAudio retrieval "
                       "head)", "Contrastive extras")
    if not args.evaluate:
        raise _not_yet("training (the CLI without -e)", "Training")
    if args.mesh:
        raise _not_yet("--mesh", "Multi-GPU")


def run_one_video(cfg, video_name: str, device=None) -> dict:
    """Synthesize one video, once per driving wav (avtex's -e branch of
    ``run_one_video``)."""
    from avtex_torch.contrastive.model import ContrastiveTextures
    from avtex_torch.convert import convert_params
    from avtex_torch.media import video_fps
    from avtex_torch.obs import Logger
    from avtex_torch.synth.pipeline import _DTYPES, synthesize
    from avtex_torch.train import restore_checkpoint

    video_path = os.path.join(cfg.vdata or ".", f"{video_name}.mp4")
    audio_path = (os.path.join(cfg.adata, f"{video_name}.wav")
                  if cfg.adata else None)
    if cfg.model_type == 2 and (audio_path is None
                                or not os.path.exists(audio_path)):
        raise FileNotFoundError(f"model_type=2 requires {audio_path}")
    cfg = cfg.derive_geometry(video_fps(video_path))

    resume = cfg.resume or cfg.default_ckpt_path(video_name)
    params = None
    if os.path.exists(resume):
        payload = restore_checkpoint(resume)
        model = ContrastiveTextures(
            arch=cfg.enc_arch, model_type=cfg.model_type, temp=cfg.temp,
            dtype=_DTYPES[cfg.compute_dtype], norm=cfg.norm)
        params = convert_params(payload["state"], model)
        print(f"[avtex_torch] restored checkpoint {resume} (epoch "
              f"{payload['epoch']}, loss {payload['best_loss']:.4f})")
    elif not (cfg.allow_random_init or cfg.norm == "affine"):
        # As avtex: a missing checkpoint means the flags do not match
        # training's; norm="affine" loads pretrained imports instead.
        raise FileNotFoundError(
            f"No checkpoint found at '{resume}'. Pass the same "
            f"hyperparameter flags (-bs/-negs/-w/-stride/...) used at "
            f"training so the derived path matches, give -resume "
            f"explicitly, or pass -allow_random_init to synthesize "
            f"with random weights anyway.")
    else:
        print(f"[avtex_torch] no checkpoint at {resume}; random-init params",
              file=sys.stderr)

    driving_paths = [None]
    if cfg.driving_audio:
        driving_paths = [os.path.join(cfg.dadata, f"{d}.wav")
                         for d in cfg.driving_audio]
    logger = Logger(cfg.logdir, cfg.eval_logname(video_name))
    for d_path in driving_paths:
        out = synthesize(cfg, video_path, params, audio_path=audio_path,
                         driving_audio_path=d_path,
                         out_dir=cfg.results_folder, logger=logger,
                         device=device)
        r = out["result"]
        print(f"[avtex_torch] {video_name}: {len(r.indices)} steps, "
              f"{int(r.jumps.sum())} jumps, timings {out['timings']}, "
              f"outputs {list(out['paths'].values())}")
    return out


def main(argv=None) -> List[dict]:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    cfg = args_to_config(args)
    if not cfg.video_list:
        if cfg.vdata and os.path.isdir(cfg.vdata):
            cfg = dataclasses.replace(
                cfg, video_list=discover_video_list(cfg.vdata))
        if not cfg.video_list:
            raise SystemExit(
                "need -vl video names (or -vdata pointing at a directory "
                "of videos to discover them from)")
    return [run_one_video(per_video_config(cfg, name, itr), name,
                          args.device)
            for itr, name in enumerate(cfg.video_list)]


if __name__ == "__main__":
    main()
