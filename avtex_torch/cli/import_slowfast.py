"""Check that a pretrained SlowFast checkpoint imports into the port (the
port of tools/import_slowfast.py).

It runs the import path on the file: the pyslowfast ``SLOWFAST_8x8_R50.pkl``
caffe2 artifact the reference loads, or any torch ``.pth`` / ``.pyth`` save
of the same architecture:

  1. ``load_slowfast_state``: the file -> pytorch-format numpy arrays;
  2. ``convert_slowfast``: the name map and the BN fold into
     ``SlowFastR50(norm="affine")``, every tensor shape-checked, unmapped
     names on either side raising;
  3. embeds a synthetic clip and prints the embedding's statistics.

``IMPORT OK`` and exit 0 mean that synthesis will load the file the same
way when it finds it (``$AVTEX_ENCODER_CKPT`` or
``pretrained/SLOWFAST_8x8_R50.pkl``); ``IMPORT FAILED: ...`` and exit 1
that it cannot. It runs on ``cuda`` (bf16) unless given ``--device cpu``
(float32).

Usage:
  python -m avtex_torch.cli.import_slowfast path/to/SLOWFAST_8x8_R50.pkl
  python -m avtex_torch.cli.import_slowfast ckpt.pkl --out converted.msgpack
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "avtex_torch import_slowfast",
        description="Check a pretrained SlowFast checkpoint's import.")
    p.add_argument("ckpt", help="SLOWFAST_8x8_R50.pkl (caffe2) or .pth")
    p.add_argument("--out", default=None,
                   help="write the converted parameters (avtex's msgpack "
                        "tree of a SlowFastR50)")
    p.add_argument("--layers", default="3,4,6,3",
                   help="bottlenecks per stage (non-default only for "
                        "reduced test checkpoints)")
    p.add_argument("--width", type=int, default=64,
                   help="stem width (non-default only for tests)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' to run there)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    layers = tuple(int(x) for x in args.layers.split(","))

    import numpy as np
    import torch

    from avtex_torch.checkpoints import convert_slowfast, load_slowfast_state
    from avtex_torch.device import resolve_device
    from avtex_torch.nn.slowfast import SlowFastR50, slowfast_pathways

    dev = resolve_device(args.device)
    print(f"[1/3] loading {args.ckpt}")
    try:
        state = load_slowfast_state(args.ckpt)
    except Exception as e:
        print(f"IMPORT FAILED: cannot read {args.ckpt} as a torch save or "
              f"caffe2 pkl ({type(e).__name__}: {e})", file=sys.stderr)
        return 1
    if not state:
        print(f"IMPORT FAILED: no tensors found in {args.ckpt}",
              file=sys.stderr)
        return 1
    n_bn = sum(1 for k in state if k.endswith("running_mean"))
    n_conv = sum(1 for k in state if k.endswith(".weight")
                 and k.replace(".weight", ".running_mean") not in state)
    print(f"      {len(state)} tensors ({n_conv} conv weights, "
          f"{n_bn} BN layers)")

    print("[2/3] converting into SlowFastR50(norm='affine')")
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    model = SlowFastR50(layers, args.width, dtype=dtype, norm="affine")
    try:
        params = convert_slowfast(state, model.state_dict(), layers=layers)
    except ValueError as e:
        print(f"IMPORT FAILED: {e}", file=sys.stderr)
        print("      (every conv/BN tensor must map by name and shape — "
              "is this a SlowFast-R50 8x8 checkpoint?)", file=sys.stderr)
        return 1
    model.load_state_dict(params)
    print(f"      all tensors mapped and shape-checked ({len(params)} "
          f"port parameters)")

    print("[3/3] embedding a synthetic clip")
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.random((1, 8, 64, 64, 3),
                                         dtype=np.float32)).to(dev)
    with torch.inference_mode():
        emb = model.to(dev).eval()(*slowfast_pathways(frames)).cpu().numpy()
    finite = bool(np.isfinite(emb).all())
    print(f"      embedding shape {emb.shape}  "
          f"norm {float(np.linalg.norm(emb)):.4f}  "
          f"mean {emb.mean():.5f}  std {emb.std():.5f}  finite={finite}")

    if args.out:
        from avtex_torch.convert import export_params
        from avtex_torch.train import _msgpack
        with open(args.out, "wb") as f:
            f.write(_msgpack.packb(export_params(params)))
        print(f"      wrote converted params -> {args.out}")

    if not finite or float(np.abs(emb).sum()) == 0:
        print("IMPORT FAILED: degenerate embedding", file=sys.stderr)
        return 1
    print("IMPORT OK — synthesis will load this checkpoint from "
          "pretrained/SLOWFAST_8x8_R50.pkl or $AVTEX_ENCODER_CKPT")
    return 0


if __name__ == "__main__":
    sys.exit(main())
