"""Classic video-textures CLI (the port of avtex/cli/classic_main.py),
flag-compatible with the reference's (-m, -f, -s, -fs, -bs, -stride, -nvl,
-SF, -sigma, -t), plus ``-device``.

Usage:
  python -m avtex_torch.cli.classic_main -m 1 -vdata data/videos -vl clip
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("avtex_torch classic video textures")
    p.add_argument("-m", "--model_type", type=int, default=1,
                   help="(1) Classic (2) Classic+ (3) Classic++")
    p.add_argument("-vdata", default=None)
    p.add_argument("-adata", default=None)
    p.add_argument("-vl", "--video_list", nargs="+", required=True)
    p.add_argument("-f", "--feats", default="RGB",
                   choices=["RGB", "ResNet", "ResNet_VGGish"])
    p.add_argument("-s", "--slow", action="store_true",
                   help="kept for flag parity; tiling is automatic")
    p.add_argument("-fs", "--filter_size", type=int, default=40)
    p.add_argument("-bs", "--batch_size", type=int, default=64)
    p.add_argument("-stride", type=int, default=4)
    p.add_argument("-nvl", "--new_video_length", type=int, default=30)
    p.add_argument("-nintp", dest="interpolation", action="store_false")
    p.add_argument("-SF", type=int, default=3)
    p.add_argument("-sigma", type=float, default=None,
                   help="single sigma instead of the default sweep")
    p.add_argument("-t", "--threshold", type=float, default=0.08)
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-logdir", default="./logs")
    p.add_argument("-results_folder", default="results_classic")
    p.add_argument("-device", default=None,
                   help="torch device (default: cuda; 'cpu' to run there)")
    return p


def main(argv=None) -> None:
    from avtex_torch.classic.driver import run_classic
    from avtex_torch.config import ClassicConfig
    from avtex_torch.obs import Logger

    args = build_parser().parse_args(argv)
    sigmas = (args.sigma,) if args.sigma is not None else \
        ClassicConfig.sigmas
    cfg = ClassicConfig(
        model_type=args.model_type, vdata=args.vdata, adata=args.adata,
        video_list=args.video_list, feats=args.feats, slow=args.slow,
        filter_size=args.filter_size, batch_size=args.batch_size,
        stride=args.stride, new_video_length=args.new_video_length,
        interpolation=args.interpolation, SF=args.SF,
        threshold=args.threshold, sigmas=sigmas, seed=args.seed,
        results_folder=args.results_folder, logdir=args.logdir)

    for name in args.video_list:
        video_path = os.path.join(cfg.vdata or ".", f"{name}.mp4")
        audio_path = (os.path.join(cfg.adata, f"{name}.wav")
                      if cfg.adata else None)
        logger = Logger(cfg.logdir, f"{cfg.logname}_{name}")
        out = run_classic(cfg, video_path, audio_path,
                          out_dir=cfg.results_folder, logger=logger,
                          device=args.device)
        print(f"[avtex_torch] classic {name}: jump counts "
              f"{out['jump_counts']}")


if __name__ == "__main__":
    main()
