"""CLI for the audio-conditioning baselines (the port of
avtex/cli/baselines_main.py), flag-compatible with avtex's, plus
``-device``:

  python -m avtex_torch.cli.baselines_main nn -vdata d -vl clip -da song \
      -dadata a
  python -m avtex_torch.cli.baselines_main random -vdata d -vl clip
  python -m avtex_torch.cli.baselines_main random_segment -vdata d -vl clip
  python -m avtex_torch.cli.baselines_main shift -i results/tex.mp4

``nn`` computes the log-mel examples and the cosine matches on the device
(``cuda`` unless ``-device cpu``); the other modes run on the host.
Decoding and writing need OpenCV, as the port's other CLIs do.
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("avtex_torch audio baselines")
    p.add_argument("mode", choices=["nn", "random", "random_segment",
                                    "shift"])
    p.add_argument("-vdata", default=None)
    p.add_argument("-adata", default=None)
    p.add_argument("-dadata", default="audio/target")
    p.add_argument("-vl", "--video_list", nargs="+", default=None)
    p.add_argument("-da", "--driving_audio", nargs="+", default=None)
    p.add_argument("-tl", "--target_list", nargs="+", default=None,
                   help="target audios to overlay (random modes; reference "
                        "random_baseline.py -tl)")
    p.add_argument("-nvl", "--new_video_length", type=int, default=30)
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-i", "--input", default=None,
                   help="existing result video (shift mode)")
    p.add_argument("-results_folder", default="results_baselines")
    p.add_argument("-device", default=None,
                   help="torch device of nn mode (default: cuda; 'cpu' to "
                        "run there)")
    return p


def main(argv=None) -> None:
    from avtex_torch.audio import waveform_to_examples
    from avtex_torch.baselines import (audio_nearest_neighbour,
                                       random_segment_walk,
                                       random_sequential_walk, shift_audio)
    from avtex_torch.contrastive.segments import num_segments
    from avtex_torch.device import resolve_device
    from avtex_torch.media import (mux_audio_video, read_video, read_wav,
                                   save_texture_outputs)
    from avtex_torch.native.stitch import stitch_frames

    args = build_parser().parse_args(argv)
    out_dir = args.results_folder

    if args.mode == "shift":
        if not args.input:
            raise SystemExit("shift mode needs -i <video>")
        frames, fps = read_video(args.input)
        wav_path = os.path.splitext(args.input)[0] + ".wav"
        if not os.path.exists(wav_path):
            raise SystemExit(f"expected audio sidecar {wav_path}")
        audio, sr = read_wav(wav_path)
        # the reference caps the track at 60 s before shifting
        audio = audio[: sr * 60]
        shifted, secs = shift_audio(audio, sr, seed=args.seed)
        name = os.path.splitext(os.path.basename(args.input))[0]
        out = mux_audio_video(frames, shifted, sr,
                              os.path.join(out_dir, f"{name}_shift.mp4"), fps)
        print(f"[avtex_torch] shifted audio by {secs:.1f}s -> {out}")
        return

    for name in args.video_list or []:
        video_path = os.path.join(args.vdata or ".", f"{name}.mp4")
        frames, fps = read_video(video_path)
        W, S = math.ceil(fps / 2), math.ceil(fps / 5)
        L = num_segments(len(frames), W, S, "val")
        max_len = int(args.new_video_length * fps)

        audio = None
        sr = 22050
        if args.adata:
            a_path = os.path.join(args.adata, f"{name}.wav")
            if os.path.exists(a_path):
                audio, sr = read_wav(a_path)

        if args.mode == "nn":
            if not args.driving_audio:
                raise SystemExit("nn mode needs -da")
            if audio is None:
                raise SystemExit("nn mode needs -adata source audio")
            dev = resolve_device(args.device)
            src_eg = waveform_to_examples(audio, sr, device=dev)
            for da in args.driving_audio:
                d_wav, d_sr = read_wav(os.path.join(args.dadata, f"{da}.wav"))
                d_eg = waveform_to_examples(d_wav, d_sr, device=dev)
                frame_ids, segs = audio_nearest_neighbour(
                    d_eg, src_eg, W, S, max_len)
                # the driving wav trimmed to the emitted frame count
                # (apf = floor(sr / fps)), as the reference does
                apf = math.floor(d_sr / fps)
                save_texture_outputs(out_dir, f"{name}_{da}_nn",
                                     frames[frame_ids], fps,
                                     audio=d_wav[: len(frame_ids) * apf],
                                     sample_rate=d_sr)
                print(f"[avtex_torch] nn {name}+{da}: {len(segs)} matches")
        else:  # random / random_segment
            if args.mode == "random":
                ids = random_sequential_walk(L, W, S, max_len, args.seed)
                blocks = ""
            else:
                ids, segs = random_segment_walk(L, W, S, max_len, args.seed)
                blocks = f", {len(segs)} blocks"
            # a red position bar at column idx * width / len(source) in
            # every OUTPUT frame (the output index, not the source frame)
            out_frames = stitch_frames(frames[ids],
                                       np.arange(len(ids), dtype=np.int64),
                                       frames_bar=True,
                                       total_input_frames=len(frames))
            # a target audio (-tl) trimmed to the output length overlays
            # the texture; without -tl, the source-named wav
            overlay, overlay_sr, suffix = audio, sr, args.mode
            if args.target_list:
                tgt = args.target_list[(args.video_list or []).index(name)]
                overlay, overlay_sr = read_wav(
                    os.path.join(args.adata or ".", f"{tgt}.wav"))
                suffix = f"{tgt}_{args.mode}"
            if overlay is not None:
                overlay = overlay[: len(ids) * math.floor(overlay_sr / fps)]
            save_texture_outputs(out_dir, f"{name}_{suffix}", out_frames,
                                 fps, audio=overlay, sample_rate=overlay_sr)
            print(f"[avtex_torch] {args.mode} {name}: {len(ids)} frames"
                  f"{blocks}")


if __name__ == "__main__":
    main()
