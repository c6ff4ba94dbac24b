#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (avtex_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seconds 60]

Run from the repository root. It builds the kernels itself and imports
nothing of JAX or of the avtex package. Phases (a failing phase exits
non-zero, and no result line is printed):

1. device report: torch's device name and the line of
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``;
2. build: every CUDA source under avtex_torch/csrc, one nvcc each, in
   parallel;
3. fused_conv1x1 against its plain version on the card, at every shape
   the main path gives it (captured from a forward pass of the
   full-width encoder, scaled to the main path's batch) and at ragged
   edges; per shape the kernel's time and share of its bound, the plain
   version's, torch.matmul's (product only) and the unfused chain's
   (cuDNN 1x1 conv3d + Affine + residual + ReLU, what a conv outside the
   channel rule runs); kernel against chain at the shapes with
   min(K, N) < 128 is the channel rule's evidence;
4. the full-width SlowFast-R50 (norm="affine", bf16) with the kernel
   (fuse="all") against cuDNN 1x1 convs (fuse=False), and with the
   space-to-depth stems against plain ones, on 8 clips at 224^2: cosine
   similarity >= 0.999;
4b. both stems of that encoder on the main path's batch of 150 clips:
   the s2d forms (f = 4 and 8, each with both pools) against the plain
   conv stem within 2^-6 max|conv * scale|, the two pools bit-identical;
   ms of each form and the top device kernels, with cudnn.benchmark off
   and on;
5. the main path: TextureServer.from_frames on a synthetic 60 s, 30 fps,
   224^2 video (bench.py's moving gradients; L = 297 segments), both
   towers at batch 150 with seeded flax-style weights; the launch counter
   must read 64 per batch; the warm embed timed again with the channel
   rule at its other value (128 or 64), the rule's other evidence, with
   the s2d stems at their other value and with cudnn.benchmark on; the
   profile's stem share with s2d stems on and off; then three requests,
   the third repeating the first (identical indices), stitched with the
   crossfade;
5b. SuperSloMo at jumps: a SuperSloMo.ckpt written from seeded weights,
   found by the server, answers the 30 s request again: the same indices
   and frame count as with the crossfade, uint8 frames, the bf16 net's
   mid frames against the fp32 net's (mean |diff| <= 1 level, max <= 32);
   ms per jump, stitch s against the crossfade's, interp_load_s;
5c. the checkpoint round trip: the main path's parameters in avtex's tree
   through save_checkpoint -> restore_checkpoint -> convert_params into a
   new model, whose tables must be bit-identical; file size, restore s;
5d. audio-conditioned synthesis (model_type=2, driving audio): a 60 s
   source wav at 22050 Hz whose tones follow the video's brightness phase
   and a 30 s driving wav at 44100 Hz (the resampler's other ratio),
   written from a seed; the log-mel examples on the card against the CPU
   (max |diff| <= 1e-3) and their ms; full-width VGGish on the source
   examples in bf16 against fp32 (TF32 off) with the same weights, cosine
   per row >= 0.999, ms per batch of 64 and its share of the bound (1.63
   GFLOP an example at the bf16 peak); TextureServer.from_frames with
   Config(model_type=2) on the 60 s video and the source wav: 64 launches
   per batch, [297, 2304 + 12288] unit-norm tables, cosine >= 0.999
   against fuse=False, the warm embed beside phase 5's and the profile's
   VGGish share; 30 s requests with the driving wav at alpha 0.5 under
   -daf VGG and -daf Mel: [steps, L] finite rows, the audio-matched seed,
   the frame count of the driving clip's length, the driving waveform as
   the output track, the scorer built once and reused, a repeat with
   identical indices; audio_rows_s, walk_s and host-to-host s; a
   pytorch_vggish.pth from seeded weights under the reference's names
   (fc head included), found by a server whose VGGish features and -daf
   VGG rows must equal those of a VGGish loaded directly;
6. pairwise_l2 against its plain version on the card: the RGB rows of a
   60 s, 30 fps, 224^2 synthetic video (N = 1800, F = 150528), the same
   rows normalized, and ragged shapes (N = 1, F inside one slab, F shorter
   than one split, a ragged last split, grids that are not a whole number
   of waves); squared distances within 1e-5 (|x_i|^2 + |x_j|^2), an exact
   zero diagonal, an exactly symmetric output and two launches on the same
   rows bit-identical; the split plan (S, workspace, blocks per SM) and
   the Gram kernel's registers; kernel, plain and torch.cdist times, and
   each version's error against an fp64 Gram;
7. the classic path: run_classic_frames on that video with ClassicConfig()
   defaults (mode 1, RGB, fs 40, 5 sigmas, 900 steps), then one sigma in
   mode 2 and twice in mode 3, and one classic_transition_matrix call; the
   kernel launch count must equal the D1 calls; every P3_new finite,
   non-negative, with a survivor in every row; every walk transition (the
   walk on the device) on a nonzero entry of its row; the repeated run
   gives identical indices; P3 from the kernel's D1 against P3 from the
   plain version's D1; per sigma the device walk's and the fetch's
   seconds;
8. fused_stage: slow res2 (SFBottleneck_0/2/4) and res3 (_6/8/10/12) of
   the full-width encoder on their real inputs, captured by hooks from one
   forward of the main path's 150 clips (BT = 1200 slices), with weights
   from stage_weights_from_params(enc.state_dict()); 7 launches (one per
   block); every block against the plain version elementwise and each
   stage by relative Frobenius error; cosine per slice against the
   model's own blocks (fuse="all" and fuse=False); a repeat launch
   bit-identical; small and ragged shapes; kernel, wrapper, plain and
   model-chain times beside the bound; per block the launch plan
   (stage_fused.plan: tile, consumer warpgroups, weight slots, shared
   memory, CTAs and the occupancy query's CTAs per SM, padded share), the
   kernel's -Xptxas -v registers, ms, TFLOP/s and share of its bound;
9. training (no hand kernel: avtex trains through no Pallas kernel) on
   the same 60 s video (W = 15, S = 6: 296 train queries), bf16 with an
   fp32 master copy, GroupNorm, checkpointed blocks, augmentation, at
   -bs 8 -negs 8 (80 clips of 15 x 224^2 a step): (a) ResNet18, 5 steps,
   and (b) SlowFast-R50, 3 steps: finite losses, ms per step after a
   warm-up step, clips/s, peak memory; (c) 15 ResNet18 steps on one
   batch without augmentation: the last loss below the first; (d) peak
   memory of one ResNet18 step with and without checkpointing at -bs 2
   -negs 2 and at (a)'s batch; (e) a width-16 ResNet10 at 64 px in fp32
   (TF32 off), two steps on the card and on the CPU from the same
   parameters and draws: losses within 1e-4, the parameters' relative
   L2 error within 1e-4; (f) save_checkpoint after (a), restore_checkpoint
   into a new state (parameters and momentum bit-identical), the next
   step resumed against the uninterrupted one under deterministic
   algorithms (the same loss; parameters bit-identical or within 1e-3 of
   each tensor's largest, max-pool backward having no deterministic CUDA
   kernel), the file through convert_params into a norm="group"
   TextureServer whose tables are bit-identical to the in-memory
   model's, and a 10 s request; (g) model_type=2 on phase 5d's source
   wav, 2 steps: finite losses, the VGGish weights moved;
10. (a) the contrastive device walk (synthesize_indices) on phase 5's
   tables (L = 297, a 30 s request, threshold 0.5, seed segment 10),
   without and with phase 5d's -daf Mel rows, and on seeded unit-norm
   tables at L = 2048, without and with seeded rows: device-walk ms
   against host-walk ms (both from the tables), every choice a survivor
   of its step, a repeat with the same seed identical, the walk on the
   CPU from the card's logits and noise with the same choices and
   statistics within 1e-5, and the step loop captured in one CUDA graph
   (capture and replay ms; a measurement, not a path of the port);
   (c) -f ResNet and ResNet_VGGish features (random resnet18 at 112 px,
   VGGish on phase 5d's source wav) of phase 7's N = 1800 frames:
   pairwise_l2 normalized against its plain version at F = 512, 640 and
   12800 (phase 6's gates; ms, plain, torch.cdist, bound, split plan,
   device-time split), then run_classic_frames with each mode, one
   sigma: 2 launches, every step on a nonzero entry; (d) the seven new
   encoders (resnext50/101/152, densenet121/169, resnet18_2d/34_2d) at
   full width in bf16: one synchronised forward of 8 clips of 15 x 224^2
   (112^2 for the 2D archs) after a warm-up, ms and peak memory, finite
   unit-norm embeddings, card against CPU in fp32 (TF32 off) on one clip
   of 15 x 112^2 with cosine >= 0.9999; a TextureServer with -ea
   resnext50 (load, embed, a 30 s request walked on the host and on the
   device); one training step each of resnext50 and densenet121 after a
   warm-up step at -bs 8 -negs 8: finite losses, ms, peak memory; (e)
   the audio baselines through the library: audio_nearest_neighbour on
   phase 5d's wavs on the card (each match within 1e-4 of the best fp64
   cosine), the random walks and the shift;
11. the contrastive extras, on phase 5's server and phase 5d's wavs: (b)
   train_video_for_audio at avtex's defaults (resnet18, 112 px, batch 8,
   7 negatives: 64 clips a step) for 2 epochs of 37 steps (finite
   losses, s, peak memory), 30 steps on one repeated batch (the loss
   falls by 20%; warm step ms, clips/s), two steps at width 16, 64 px in
   fp32 on the card and the CPU from the same parameters (losses within
   1e-4); (a) -daf Contrastive through phase 5's server (VideoForAudio:
   resnet18 at 224^2, bf16), two 30 s requests with the driving wav (its
   291 examples set 873 frames: 144 steps): a [297, 128] unit-row table,
   [144, 297] finite rows, the scorer built
   once, the same indices, the table against an fp32 VideoForAudio on the
   same weights (cosine >= 0.999 per row), a -daf_resume file from (b)'s
   parameters loaded by a new server whose rows are bit-identical to the
   trained module's; scorer_s, audio_rows_s and host-to-host s; (c)
   segment_cams of phase 5's query tower over the 297 segments at 224^2
   ([297, 7, 7], finite; fused_conv1x1's launches counted; fuse="all"
   against fuse=False, cosine >= 0.999 per segment), cam_step_frames of
   (a)'s first request (two [144, 224, 224, 3] uint8 arrays) and the
   overlay on the card against its numpy run, bit for bit; cam_s; (d)
   AudioVisualFeatures (8 clips of 16 x 112^2, 1 s waveforms at 22050 Hz)
   and ClassicTemporal (resnet18, B = 2, N = 8, 112^2): card against CPU
   in fp32, cosine >= 0.99999, bf16 and fp32 forward ms;
12. pretrained encoder import, the native host runtime and the profiler
   (files under a temporary directory; $AVTEX_ENCODER_CKPT set only inside
   the phase): (a) a seeded SlowFast-R50 state under pyslowfast's names
   (running_var >= 0.5) written as the model zoo's caffe2 .pkl and as a
   .pyth; load_slowfast_state + convert_slowfast timed for each; each
   loaded through $AVTEX_ENCODER_CKPT into a norm="affine" TextureServer
   (no trained checkpoint) on the 60 s video, one 10 s request: the two
   formats' tables bit-identical, finite unit rows, both towers holding
   the file, the card's bf16 embeddings of 4 clips against the same file
   in an fp32 model on the CPU at cosine >= 0.999; fused_conv1x1's
   launches counted; (b) -ea resnet18 --norm affine from a seeded
   r3d18_KM_200ep.pth-style file (the same gates), and the classic
   -f ResNet with a resnet18-imagenet.pth-style file at N = 1800 (s,
   features bit-identical to the explicitly loaded net's); (c) the native
   runtime: a fresh g++ build (s), phase 5's 30 s request stitched with
   the native gather and crossfade and with the numpy plain versions,
   frames_bar off and on (byte-identical, ms each), and an AVI of 900
   synthetic JPEG byte strings and 30 s of PCM by the C++ and the Python
   muxer (byte-identical files, ms each); (d) trace(logdir) around one
   warm embed batch: the Chrome trace exists and names fused_conv1x1's
   kernel;
13. the parallel layer (avtex_torch.parallel) at world size 1: make_mesh()
   starts a one-process NCCL world (a FileStore in a temporary directory)
   and a (1, 1) data x model mesh, destroyed at the end of the phase; (a)
   sharded_embed_from_video of both towers on phase 5's model and video
   with phase 5's batch plan: tables bit-identical to phase 5's and
   fused_conv1x1's launches per embed equal to phase 5's, sharded and
   unsharded embed s; (b) TextureServer.from_frames(mesh=...) and a 10 s
   request: phase 5's indices for the same seed; (c) make_sharded_train_step
   against make_train_step at phase 9 (b)'s SlowFast-R50 configuration
   (norm="group", bf16 + fp32 master, -bs 8 -negs 8): a warm-up step, then
   a timed step from the same initial state, batch and draws: its loss
   within 1e-5, the parameters after it within 1e-4 relative L2; step ms
   and peak GiB of each; (e) the sharded embed of phase 5d's -m 2 model
   with its source examples: tables bit-identical to phase 5d's (or cosine
   >= 0.999 per row), unit rows, sharded and unsharded s; (d)
   classic_transition_matrix_sharded on phase 7's N = 1800 RGB rows, one
   sigma: P3_new and the D3 sweep count equal to the unsharded chain's on
   the plain D1 (the sharded row block's arithmetic); against
   classic_transition_matrix (the kernel's D1), P3 before the threshold
   within phase 7's 1e-2 of the row max, with P3_new's difference and both
   sweep counts printed, and the sweep count of the chain on an fp64 D1
   (the stopping sweep and the threshold's cut follow D1's rounding at
   near-duplicate frames); the time of each.

It ends with a ``{"parallel": ...}`` line (world size, backend and phase
13's times), a JSON line describing each kernel, the nvidia-smi line, and
``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

# NVIDIA H100 SXM data sheet (dense): bf16 tensor cores, HBM3 bandwidth.
PEAK_BF16_FLOP_S = 989e12
PEAK_BYTES_S = 3.35e12
# 32 eligible 1x1 convs per tower under the channel rule of 64, two
# towers: 11 with 64 <= min(K, N) < 128 (slow res2's seven, the fast res4
# projection, fast res5's three conv3) and the 21 of avtex's rule of 128.
LAUNCHES_PER_BATCH = 64
# Ragged edges of the tiling: M off the 128-row tile with over 4 x 132
# tiles, N-chunk tails (N = 200, 384), K off the 64-wide slab (24, 104)
# and long (1280), M below one 64-row half tile.
RAGGED_SHAPES = [
    (1000, 320, 128, False, True), (392 * 3, 1280, 2048, False, False),
    (777, 128, 512, True, True), (300, 104, 200, True, True),
    (129, 24, 200, False, True), (128 * 600 + 37, 128, 512, True, True),
    (128 * 300 + 77, 104, 384, True, False), (5000, 1280, 384, True, True),
    (37, 24, 384, True, True), (50, 320, 200, False, True),
]
# Kernel vs plain version: both round an fp32 sum to bf16 once, so they
# may land one bf16 ulp apart (2^-7 relative), plus slack for the order
# of the fp32 accumulation.
ULP_REL = 2.0 ** -7
ACC_ABS = 1e-3
# pairwise_l2: NVIDIA H100 SXM data sheet fp32 rate without tensor cores.
PEAK_FP32_FLOP_S = 67e12
# Kernel vs plain on squared distances, relative to |x_i|^2 + |x_j|^2: the
# scale at which the Gram form cancels (about 80 fp32 ulps of it).
SQ_TOL = 1e-5
# P3 from the kernel's D1 vs from the plain version's D1, as a share of the
# row max. P3 depends on D1 at near-duplicate frames, where the Gram form's
# D1 is rounding noise (the two versions differ there by ~1e2 against
# typical distances of ~2e4), and the value iteration adds each row's min
# -- such an entry -- to a whole column of D3: P3 moves by about
# dD3 / sigma3 ~ 1e-3 (phase 7 prints each version against an fp64 D1).
P3_RTOL = 1e-2
# s2d stem vs plain stem, both bf16: each conv output is an fp32 sum
# rounded to bf16 once (one ulp apart at most, 2^-7 relative), then the
# affine rounds twice; 2^-6 of the largest |conv * scale| covers that
# where the bias cancels.
STEM_TOL_REL = 2.0 ** -6
# SuperSloMo in bf16 vs the same weights in fp32, uint8 mid frames.
SLOMO_MEAN_TOL, SLOMO_MAX_TOL = 1.0, 32
# Log-mel on the card vs the CPU: cuFFT and pocketfft round differently,
# and log(x + 0.01) magnifies a relative error by x / (x + 0.01) < 1.
MEL_TOL = 1e-3
# VGGish bf16 vs fp32 with the same weights, and the -m 2 tables with
# fuse="all" vs fuse=False: cosine per row, as phase 4.
AUDIO_COS = 0.999
VGGISH_BATCH = 64
CLASSIC_SECONDS = 60  # phases 6-7 keep N = 1800 whatever --seconds says
# fused_stage: slow res2 (SFBottleneck_0/2/4, stride 1) and res3
# (_6/8/10/12, stride 2) of SlowFast-R50, one kernel launch per block.
STAGES = {"res2": ((0, 2, 4), 1), "res3": ((6, 8, 10, 12), 2)}
STAGE_LAUNCHES = 7
# Kernel vs plain version: both round to bf16 after conv1's and conv2's
# ReLU and at each block's output, summing in other orders, so a y1 or y2
# entry may land one bf16 ulp apart and move the block's output by about
# one ulp (2^-8 relative): elementwise 2e-2 |ref| + 2e-2 on every single
# block (avtex's tests/test_stage_fused.py:44). Through a stage's blocks
# such differences compound, so a whole stage is held to a relative
# Frobenius error <= 1e-2.
STAGE_RTOL = STAGE_ATOL = 2e-2
STAGE_FRO = 1e-2
# Kernel vs the model's own blocks, which round the projection to bf16
# before the residual add (fused_stage adds it in fp32) and, with
# fuse=False, run cuDNN convs: cosine per slice, as phase 4.
STAGE_COS = 0.999
# Phase 9: the training batch (the reference's default is -bs 32 -negs 20,
# cut here for the phase's time), the card-against-CPU gates (fp32, TF32
# off: the two sum convolutions in other orders) and the resumed step's
# gate where it is not bit-identical (max-pool backward has no
# deterministic CUDA kernel: its atomics sum overlapping windows in any
# order).
TRAIN_BS, TRAIN_NEGS = 8, 8
CPU_LOSS_TOL = CPU_PARAM_TOL = 1e-4
RESUME_TOL = 1e-3
# (e)'s network: at width 8 and 32 px ResNet10's res5 is one voxel, and
# GroupNorm over its two-value groups makes even the forward ill-posed in
# fp32 (two CPU backends part by 1.5e-3 in the first loss); at width 16,
# 64 px and LR 1e-3 they agree within 4e-6 (loss) and 2.3e-6 (relative L2
# of the parameters). GroupNorm biases' gradients come out of
# cancellation, so single tensors part by up to 1e-2: the gate is on all
# parameters together.
CPU_WIDTH, CPU_SIZE, CPU_LR = 16, 64, 1e-3
# Phase 10: the device walk's statistics (entropy, pos_prob) on the card
# against the CPU on the same logits and noise (sums in other orders), and
# the new encoders' fp32 embeddings on the card against the CPU (TF32 off;
# cuDNN and oneDNN sum convolutions in other orders).
WALK_RTOL = 1e-5
ENC_COS = 0.9999
NEW_ENCODERS = ("resnext50", "resnext101", "resnext152", "densenet121",
                "densenet169", "resnet18_2d", "resnet34_2d")
# Phase 11: the -daf Contrastive head (VideoForAudio: resnet18 at 224^2,
# as avtex picks it under SlowFast) in bf16 against fp32 on the same
# weights, and phase 5's CAMs with fuse="all" against fuse=False: cosine
# per table row and per segment, as phase 4. Its trainer at avtex's
# defaults; the repeated batch's loss must fall by 20% within 30 steps.
# Card against CPU: AudioVisualFeatures and ClassicTemporal in fp32 (TF32
# off), and two trainer steps at width 16, 64 px, fp32 and LR 1e-6: at
# avtex's 1e-3 Adam moves each weight of the 12288-wide layer by ~10% of
# its scale a step, and an entry whose gradient is near rounding noise
# moves by +-LR either way, so two backends part by 4e-4 in the second
# loss already (tests/test_torch_retrieval.py).
VFA_COS = CAM_COS = 0.999
OVERFIT_STEPS, OVERFIT_DROP = 30, 0.2
VFA_CPU_WIDTH, VFA_CPU_SIZE, VFA_CPU_LR = 16, 64, 1e-6
SIDE_COS = 0.99999
# Phase 12: a pretrained encoder file's bf16 embeddings on the card against
# the same file in an fp32 model on the CPU (TF32 off), cosine per clip;
# the number of clips compared.
IMPORT_COS = 0.999
IMPORT_CLIPS = 4
# Phase 13 (c): the DP+TP train step at world size 1 against the unsharded
# step from the same state, batch and draws. The loss comes from the same
# forward arithmetic; the parameters after the step part only where
# cuDNN's weight gradients and max-pool's backward (atomics) sum in
# another order, the gate on all parameters together. (From states that
# already part so, the next losses part by ~5e-5.)
PAR_LOSS_TOL = 1e-5
PAR_PARAM_TOL = 1e-4
# device-time kinds of a training step's kernels, by name
TRAIN_KINDS = (("conv", ("conv", "xmma", "cudnn", "wgrad", "dgrad", "fprop",
                         "sm90_", "sm80_")),
               ("group norm", ("group_norm", "groupnorm")),
               ("max pool", ("max_pool",)),
               ("matmul", ("gemm", "cutlass")),
               ("optimizer", ("multi_tensor", "foreach")),
               ("elementwise and copies", ("elementwise", "vectorized",
                                           "copy", "reduce", "unrolled",
                                           "cat", "index", "where")))


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_registers(log: str) -> dict:
    """{kernel: registers} from nvcc's ``-Xptxas -v`` report."""
    regs, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = int(m.group(1))
    return regs


def demangled(name: str) -> str:
    """``pairwise_gram_kernel<1>`` or ``fused_block_kernel<128,1>`` from a
    mangled name (a length-prefixed identifier ending in ``kernel``, then
    its integer template arguments)."""
    for m in re.finditer(r"(?=(\d+)[A-Za-z_])", name):
        start = m.start() + len(m.group(1))
        ident = name[start:start + int(m.group(1))]
        if ident.endswith("kernel"):
            t = re.match(r"I((?:L[a-z]+\d+E)+)E", name[start + len(ident):])
            args = re.findall(r"\d+", t.group(1)) if t else []
            return ident + (f"<{','.join(args)}>" if args else "")
    return name


def dev_ms(ev) -> float:
    """Device milliseconds of a ``torch.profiler`` event average."""
    return getattr(ev, "self_device_time_total",
                   getattr(ev, "self_cuda_time_total", 0)) / 1e3


def kernel_device_ms(fn) -> dict:
    """{kernel name: device ms} of one warm call of ``fn``. The call is
    the profiler's second step: its first step would drop the window's
    first kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    cuda = torch.autograd.DeviceType.CUDA
    out = {}

    def ready(prof):
        out.update({e.key: dev_ms(e) for e in prof.key_averages()
                    if getattr(e, "device_type", None) == cuda
                    and dev_ms(e) > 0})

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=ready) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return out


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for the plain version's fp32 product, and the library
    defaults back afterwards, so the main path runs as a user's would."""
    import torch
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def bound_times(M: int, K: int, N: int, residual: bool):
    """(bytes ms, operations ms) of the fused call: the bytes it must move
    (each input read once, the output written once) over the HBM rate, and
    its 2MKN operations over the bf16 tensor-core peak. The larger bounds
    the call."""
    nbytes = 2 * (M * K + N * K + M * N + (M * N if residual else 0)) + 8 * N
    return (nbytes / PEAK_BYTES_S * 1e3,
            2 * M * K * N / PEAK_BF16_FLOP_S * 1e3)


def pairwise_bound_times(n: int, f: int):
    """(bytes ms, operations ms) of one pairwise_l2 call: the rows read
    once and D written once over the HBM rate, and the N(N+1)/2 distinct
    row products (D is symmetric; the norms are its diagonal) at 2F
    operations each over the fp32 peak."""
    return (4 * (n * f + n * n) / PEAK_BYTES_S * 1e3,
            n * (n + 1) * f / PEAK_FP32_FLOP_S * 1e3)


def block_flops(bt, h, w, cin, f, cout, stride, proj) -> int:
    """Operations of one bottleneck: conv1 at the input resolution, conv2,
    conv3 and the projection at the output's, 2 per product term."""
    ho, wo = h // stride, w // stride
    return 2 * bt * (h * w * cin * f + ho * wo * (
        9 * f * f + f * cout + (cin * cout if proj else 0)))


def stage_bound_times(bt: int, h: int, w: int, cin: int, f: int, cout: int,
                      n_blocks: int, stride: int):
    """(bytes ms, operations ms, handoff bytes ms) of one slow stage: the
    stage input read once, its output written once and every weight read
    once over the HBM rate; conv1 at the input resolution and conv2, conv3
    and the block-0 projection at the output's, 2 operations a product
    term, over the bf16 tensor-core peak. The third time is what one
    launch per block adds: each inner block output written and read."""
    ho, wo = h // stride, w // stride
    flops, wbytes, c = 0, 0, cin
    for i in range(n_blocks):
        proj = i == 0
        flops += block_flops(bt, h, w, c, f, cout, stride, proj) if proj \
            else block_flops(bt, ho, wo, c, f, cout, 1, proj)
        wbytes += 2 * (c * f + 9 * f * f + f * cout
                       + (c * cout if proj else 0))
        wbytes += 4 * 2 * (2 * f + cout + (cout if proj else 0))
        c = cout
    nbytes = 2 * bt * (h * w * cin + ho * wo * cout) + wbytes
    handoff = 2 * 2 * bt * ho * wo * cout * (n_blocks - 1)
    return (nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_BF16_FLOP_S * 1e3,
            handoff / PEAK_BYTES_S * 1e3)


def synthetic_video(seconds: int, fps: int = 30, res: int = 224):
    """bench.py's structured video: moving sin/cos gradients, uint8 RGB."""
    yy, xx = np.mgrid[0:res, 0:res]
    base = np.sin(xx / 17.0)[None] + np.cos(yy / 13.0)[None]
    phase = np.sin(np.arange(fps * seconds) / 9.0)
    video = np.clip(127 + 80 * base * phase[:, None, None], 0, 255)
    return video[..., None].repeat(3, -1).astype(np.uint8)


def capture_kernel_calls(enc, slow, fast):
    """(rows, K, N, residual, relu) of every fused_conv1x1 call that one
    forward pass of ``enc`` makes."""
    import torch
    import avtex_torch.nn.slowfast as sfmod
    calls = []
    real = sfmod.fused_conv1x1

    def recording(x, weight, scale, bias, residual=None, relu=True):
        calls.append((x.shape[0], x.shape[1], weight.shape[0],
                      residual is not None, bool(relu)))
        return real(x, weight, scale, bias, residual=residual, relu=relu)

    sfmod.fused_conv1x1 = recording
    try:
        with torch.inference_mode():
            enc(slow, fast)
    finally:
        sfmod.fused_conv1x1 = real
    return calls


def clip_dims(rows: int):
    """(T, H, W) of one clip's activation with ``rows`` = T H W rows: the
    slow pathway has T = 8, the fast one T = 32, and H = W."""
    for t in (8, 32):
        side = int(round((rows / t) ** 0.5))
        if t * side * side == rows:
            return t, side, side
    raise ValueError(f"{rows} rows per clip is no T x H x H activation")


def unfused_chain(x, w, scale, bias, r, relu, dims):
    """What a 1x1 conv outside the kernel's rule runs
    (``SFBottleneck._fused``'s cuDNN branch): conv3d on the channels-last
    activation, Affine, the residual add, ReLU."""
    import torch
    from avtex_torch.nn.resnet3d import Affine
    t, h, wd = dims
    m, k = x.shape
    n = w.shape[0]
    aff = Affine(n).to(x.device)
    aff.scale.data, aff.bias.data = scale, bias
    z = x.view(m // (t * h * wd), t, h, wd, k).permute(0, 4, 1, 2, 3)
    res = (None if r is None else
           r.view(m // (t * h * wd), t, h, wd, n).permute(0, 4, 1, 2, 3))
    wt = w.view(n, k, 1, 1, 1)

    def run():
        with torch.inference_mode():
            y = aff(torch.nn.functional.conv3d(z, wt))
            if res is not None:
                y = y + res
            return torch.relu(y) if relu else y
    return run


def check_kernel_shape(M, K, N, residual, relu, timed, seed, dims=None):
    """The kernel against its plain version at one shape; with ``timed``,
    the times of the kernel, the plain version, torch.matmul and (given the
    clip ``dims``) the unfused chain, beside the bound."""
    import torch
    from avtex_torch.ops import fused_conv1x1, fused_conv1x1_reference
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(N, K, generator=g, device=dev) * K ** -0.5).to(
        torch.bfloat16)
    scale = torch.rand(N, generator=g, device=dev) + 0.5
    bias = torch.randn(N, generator=g, device=dev) * 0.1
    r = (torch.randn(M, N, generator=g, device=dev).to(torch.bfloat16)
         if residual else None)
    got = fused_conv1x1(x, w, scale, bias, r, relu)
    torch.cuda.synchronize()
    with fp32_exact():
        want = fused_conv1x1_reference(x, w, scale, bias, r, relu)
    got32, want32 = got.float(), want.float()
    diff = (got32 - want32).abs()
    tol = ULP_REL * torch.maximum(got32.abs(), want32.abs()) + ACC_ABS
    res = {"M": M, "K": K, "N": N, "residual": residual, "relu": relu,
           "max_abs_err": float(diff.max()),
           "max_rel_err": float((diff / want32.abs().clamp_min(1e-2)).max()),
           "within_tol": bool((diff <= tol).all())}
    del got, want, got32, want32, diff, tol
    if timed:
        res["ms"] = time_ms(lambda: fused_conv1x1(x, w, scale, bias, r,
                                                  relu), reps=10)
        with fp32_exact():
            res["plain_ms"] = time_ms(lambda: fused_conv1x1_reference(
                x, w, scale, bias, r, relu), reps=3, warmup=1)
        res["matmul_ms"] = time_ms(lambda: torch.matmul(x, w.t()), reps=10)
        if dims is not None:
            res["chain_ms"] = time_ms(unfused_chain(x, w, scale, bias, r,
                                                    relu, dims), reps=10)
        t_bytes, t_ops = bound_times(M, K, N, residual)
        res.update(bytes_ms=t_bytes, ops_ms=t_ops,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   share=max(t_bytes, t_ops) / res["ms"])
    return res


def shape_line(r) -> str:
    return (f"M={r['M']:>8} K={r['K']:>5} N={r['N']:>5} "
            f"res={int(r['residual'])} relu={int(r['relu'])}: err "
            f"{r['max_abs_err']:.3g} (rel {r['max_rel_err']:.3g}) ms "
            f"{r['ms']:.4f} = {100 * r['share']:.1f}% of bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']}); plain "
            f"{r['plain_ms']:.4f}, matmul {r['matmul_ms']:.4f}, unfused "
            f"chain {r['chain_ms']:.4f}")


def check_pairwise(x, normalize: bool, timed: bool):
    """pairwise_l2 against its plain version on rows ``x`` (on the card):
    the largest |Dk^2 - Dp^2| / (sq_i + sq_j), the exact zero diagonal,
    exact symmetry, a second launch bit-identical to the first, the split
    plan, and each version's error against an fp64 Gram (diagnostic)."""
    import torch
    from avtex_torch.ops import pairwise
    got = pairwise.pairwise_l2(x, normalize=normalize)
    repeat = bool(torch.equal(pairwise.pairwise_l2(x, normalize=normalize),
                              got))
    torch.cuda.synchronize()
    with fp32_exact():
        want = pairwise.pairwise_l2_reference(x, normalize=normalize)
        rows = pairwise._rows(x, normalize)
        sq32 = (rows * rows).sum(1)
        one = (sq32[:, None] + sq32[None, :] - 2.0 * (rows @ rows.t()))
    rows = rows.double()
    sq = (rows * rows).sum(1)
    scale = (sq[:, None] + sq[None, :]).clamp_min(1e-30)
    true = (sq[:, None] + sq[None, :] - 2.0 * (rows @ rows.t())).clamp_min(0)
    true.fill_diagonal_(0.0)
    one = one.double().clamp_min(0)
    one.fill_diagonal_(0.0)
    del rows

    def ratio(a2, b2):
        return float(((a2 - b2).abs() / scale).max())

    got2, want2 = got.double() ** 2, want.double() ** 2
    res = {"N": x.shape[0], "F": x.shape[1], "normalize": normalize,
           "max_abs_err": float((got - want).abs().max()),
           "sq_ratio": ratio(got2, want2),
           "kernel_vs_fp64": ratio(got2, true),
           "plain_vs_fp64": ratio(want2, true),
           "one_product_vs_fp64": ratio(one, true),
           "diag_zero": bool((got.diagonal() == 0).all()),
           "symmetric": bool(torch.equal(got, got.t())), "repeat": repeat,
           **pairwise.plan(x.shape[0], x.shape[1], x.device)}
    res["ok"] = (res["sq_ratio"] <= SQ_TOL and res["diag_zero"]
                 and res["symmetric"] and repeat
                 and got.shape == want.shape)
    del got, want, got2, want2, true, one, scale
    if timed:
        n, f = x.shape
        res["ms"] = time_ms(lambda: pairwise.pairwise_l2(x, normalize),
                            reps=5)
        split = kernel_device_ms(lambda: pairwise.pairwise_l2(x, normalize))
        res["gram_ms"] = sum(v for k, v in split.items() if "gram" in k)
        res["epilogue_ms"] = sum(v for k, v in split.items()
                                 if "epilogue" in k)
        res["other_device_ms"] = (sum(split.values()) - res["gram_ms"]
                                  - res["epilogue_ms"])
        with fp32_exact():
            res["plain_ms"] = time_ms(lambda: pairwise.pairwise_l2_reference(
                x, normalize), reps=3, warmup=1)
            res["library_ms"] = time_ms(lambda: torch.cdist(
                x, x, compute_mode="use_mm_for_euclid_dist"), reps=3,
                warmup=1)
        t_bytes, t_ops = pairwise_bound_times(n, f)
        res.update(bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   full_square_ms=2 * n * n * f / PEAK_FP32_FLOP_S * 1e3)
    return res


def check_walk(p3: np.ndarray, walk: np.ndarray, advance: int) -> bool:
    """Every transition lands on a nonzero entry of the row it was sampled
    from (mode 2 samples from min(chosen + stride, N-1))."""
    n = len(p3)
    row = min(int(walk[0]) + advance, n - 1) if advance else int(walk[0])
    for nxt in walk[1:]:
        if not p3[row, int(nxt)] > 0:
            return False
        row = min(int(nxt) + advance, n - 1) if advance else int(nxt)
    return True


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=int, default=60,
                    help="length of the synthetic video (>= 20)")
    args = ap.parse_args()
    if args.seconds < 20:
        ap.error("--seconds must be at least 20")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 1
    import avtex_torch.nn.slowfast as sfmod
    from avtex_torch.config import Config
    from avtex_torch.data.preprocess import preprocess_clip
    from avtex_torch.nn.slowfast import SlowFastR50, slowfast_pathways
    from avtex_torch.ops import _build, launch_counts, reset_launch_counts
    from avtex_torch.synth import TextureServer
    from avtex_torch.synth.embeddings import precompute_embeddings_from_video
    from avtex_torch.synth.pipeline import init_params_for_synthesis

    torch.backends.cudnn.benchmark = False  # the library default, pinned
    t_start = time.perf_counter()

    # ---- 1. device report ------------------------------------------------ #
    smi = nvidia_smi_line()
    log(f"[1] device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(smi)

    # ---- 2. build --------------------------------------------------------- #
    t0 = time.perf_counter()
    report = _build.build_all(verbose=True)
    log(f"[2] build: {time.perf_counter() - t0:.2f} s for "
        f"{len(report)} source(s)")
    for name, rep in report.items():
        for line in rep["log"].splitlines():
            # (C7519: ptxas notes each warpgroup.arrive it adds, many)
            if (("registers" in line or "spill" in line or "smem" in line
                 or "C7512" in line) and "C7519" not in line):
                log(f"    {name}: {line.strip()}")

    # ---- 3. kernel vs plain version -------------------------------------- #
    fps, res = 30, 224
    cfg = Config(enc_arch="slowfast", norm="affine", mini_batchsize=150,
                 seed=0).derive_geometry(fps)
    W, S = cfg.window, cfg.stride
    video = synthetic_video(args.seconds, fps, res)
    L = (len(video) - W) // S
    n_batches = -(-L // cfg.mini_batchsize)
    batch = min(cfg.mini_batchsize, ((-(-L // n_batches) + 7) // 8) * 8)
    n_batches = -(-L // batch)

    enc = SlowFastR50(norm="affine", fuse="all")
    state = init_params_for_synthesis(cfg, enc)
    enc.load_state_dict(state)
    enc = enc.cuda().eval()
    video_dev = torch.from_numpy(video).cuda()
    idx = (torch.arange(8, device="cuda")[:, None] * (L // 8) * S
           + torch.arange(W, device="cuda")[None])
    clips = slowfast_pathways(preprocess_clip(video_dev[idx], res, True))
    per_clip = capture_kernel_calls(enc, clips[0][:1], clips[1][:1])
    if len(per_clip) != LAUNCHES_PER_BATCH // 2:
        raise AssertionError(f"one tower launches the kernel "
                             f"{len(per_clip)} times, expected "
                             f"{LAUNCHES_PER_BATCH // 2}")
    shapes = {}
    for call in per_clip:
        shapes[call] = shapes.get(call, 0) + 1
    log(f"[3] kernel vs plain at the main path's batch {batch} "
        f"({len(shapes)} shapes, {len(per_clip)} launches per tower); "
        f"tolerance {ULP_REL:g}*|out| + {ACC_ABS:g}")
    rows = []
    for i, ((m1, K, N, resid, relu), count) in enumerate(shapes.items()):
        r = check_kernel_shape(m1 * batch, K, N, resid, relu, True, i,
                               clip_dims(m1))
        r["per_tower"] = count
        rows.append(r)
        log(f"    {shape_line(r)} x{count}")
    main_rows = list(rows)
    wide = [r for r in main_rows if min(r["K"], r["N"]) >= 128]
    for label, sel in (("main path", main_rows),
                       ("its calls with min(K, N) >= 128", wide)):
        log(f"    {label}, one tower forward "
            f"({sum(r['per_tower'] for r in sel)} calls): kernel "
            f"{sum(r['ms'] * r['per_tower'] for r in sel):.4f} ms, bound "
            f"{sum(r['bound_ms'] * r['per_tower'] for r in sel):.4f} ms, "
            f"unfused chain "
            f"{sum(r['chain_ms'] * r['per_tower'] for r in sel):.4f} ms")
    narrow = [r for r in main_rows if min(r["K"], r["N"]) < 128]
    log(f"    channel rule {sfmod.KERNEL_MIN_CHANNELS}: at its "
        f"{len(narrow)} shapes with min(K, N) < 128 the kernel beats the "
        f"unfused chain at {sum(r['ms'] < r['chain_ms'] for r in narrow)}; "
        f"per tower forward kernel "
        f"{sum(r['ms'] * r['per_tower'] for r in narrow):.4f} ms vs chain "
        f"{sum(r['chain_ms'] * r['per_tower'] for r in narrow):.4f} ms")
    for j, (M, K, N, resid, relu) in enumerate(RAGGED_SHAPES):
        r = check_kernel_shape(M, K, N, resid, relu, False, 100 + j)
        rows.append(r)
        log(f"    ragged M={M} K={K} N={N} res={int(resid)} "
            f"relu={int(relu)}: err {r['max_abs_err']:.3g}")
    bad = [r for r in rows if not r["within_tol"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")

    # ---- 4. encoder with and without the kernel -------------------------- #
    plain = SlowFastR50(norm="affine", fuse=False)
    plain.load_state_dict(state)
    plain = plain.cuda().eval()
    with torch.inference_mode():
        a, b = enc(*clips), plain(*clips)
        enc.s2d_stem = not enc.s2d_stem
        c = enc(*clips)
        enc.s2d_stem = not enc.s2d_stem
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
    cos_s2d = torch.nn.functional.cosine_similarity(a, c, dim=-1)
    log(f"[4] encoder fuse='all' vs fuse=False on 8 clips: cosine min "
        f"{float(cos.min()):.6f}, feature shape {tuple(a.shape)}; "
        f"s2d_stem={enc.s2d_stem} vs {not enc.s2d_stem}: cosine min "
        f"{float(cos_s2d.min()):.6f}")
    if a.shape != (8, 2304) or not torch.isfinite(a).all() \
            or float(cos.min()) < 0.999:
        raise AssertionError("encoder with the kernel disagrees with cuDNN")
    if not torch.isfinite(c).all() or float(cos_s2d.min()) < 0.999:
        raise AssertionError("encoder with s2d stems disagrees with plain")
    del plain, a, b, c, clips, video_dev
    torch.cuda.empty_cache()

    # ---- 4b. the stems: s2d against plain ------------------------------- #
    stem_phase(enc, video, W, S, batch, res)
    del enc
    torch.cuda.empty_cache()

    # ---- 5. the main path ------------------------------------------------ #
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    server = TextureServer.from_frames(cfg, video, float(fps),
                                       device="cuda")
    load_s = time.perf_counter() - t0
    launches = launch_counts()["fused_conv1x1"]
    log(f"[5] TextureServer.from_frames: {load_s:.2f} s (init + first "
        f"embed), L={server.L}, {n_batches} batches of {batch}, "
        f"kernel launches {launches}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; library "
        f"defaults: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    if launches != LAUNCHES_PER_BATCH * n_batches:
        raise AssertionError(f"kernel launched {launches} times, expected "
                             f"{LAUNCHES_PER_BATCH * n_batches}")
    for name, tab in (("query", server.q_table), ("target", server.t_table)):
        norms = torch.linalg.vector_norm(tab, dim=-1)
        if (tuple(tab.shape) != (L, 2304) or not torch.isfinite(tab).all()
                or float((norms - 1).abs().max()) > 1e-3):
            raise AssertionError(f"{name} table is wrong: {tuple(tab.shape)}")

    def embed():
        out = precompute_embeddings_from_video(
            server.model, server.video, W, S, L, img_size=res,
            batch_size=cfg.mini_batchsize)
        torch.cuda.synchronize()
        return out

    embed_times = []
    for _ in range(2):
        t0 = time.perf_counter()
        embed()
        embed_times.append(time.perf_counter() - t0)
    embed_s = min(embed_times)
    log(f"    warm embed (both towers): {embed_s:.3f} s "
        f"(runs {', '.join(f'{t:.3f}' for t in embed_times)}), "
        f"{2 * L / embed_s:.1f} clips/s")
    encoders = [server.model.q_embedder.video_encoder,
                server.model.t_embedder.video_encoder]
    s2d = encoders[0].s2d_stem
    profile_embed(embed, embed_s, label=f"s2d_stem={s2d}")

    # The channel rule's evidence: the same warm embed with the rule at its
    # other value, then once more as it is, each the best of its runs.
    rule = sfmod.KERNEL_MIN_CHANNELS
    alt = 64 if rule == 128 else 128
    alt_times = []
    sfmod.KERNEL_MIN_CHANNELS = alt
    try:
        reset_launch_counts()
        for _ in range(2):
            t0 = time.perf_counter()
            embed()
            alt_times.append(time.perf_counter() - t0)
        alt_launches = launch_counts()["fused_conv1x1"] // 2
    finally:
        sfmod.KERNEL_MIN_CHANNELS = rule
    # the s2d stems' evidence: the warm embed with them at their other
    # value, then the benchmark-tuned cuDNN algorithms; each best of two
    alt_s2d_times = []
    for enc_ in encoders:
        enc_.s2d_stem = not s2d
    try:
        reset_launch_counts()
        for _ in range(2):
            t0 = time.perf_counter()
            embed()
            alt_s2d_times.append(time.perf_counter() - t0)
        alt_s2d_launches = launch_counts()["fused_conv1x1"]
        profile_embed(embed, min(alt_s2d_times),
                      label=f"s2d_stem={not s2d}", detail=False)
    finally:
        for enc_ in encoders:
            enc_.s2d_stem = s2d
    bench_times = []
    torch.backends.cudnn.benchmark = True
    try:
        for _ in range(3):
            t0 = time.perf_counter()
            embed()
            bench_times.append(time.perf_counter() - t0)
    finally:
        torch.backends.cudnn.benchmark = False
    t0 = time.perf_counter()
    embed()
    embed_times.append(time.perf_counter() - t0)
    log(f"    s2d_stem={s2d} (as shipped): warm embed "
        f"{min(embed_times):.3f} s; s2d_stem={not s2d}: "
        f"{min(alt_s2d_times):.3f} s (runs "
        f"{', '.join(f'{t:.3f}' for t in alt_s2d_times)}; kernel launches "
        f"{alt_s2d_launches // 2} per embed); cudnn.benchmark=True: "
        f"{min(bench_times[1:]):.3f} s (runs, the first tuning: "
        f"{', '.join(f'{t:.3f}' for t in bench_times)})")
    if alt_s2d_launches // 2 != LAUNCHES_PER_BATCH * n_batches:
        raise AssertionError(f"with s2d_stem={not s2d} the kernel launched "
                             f"{alt_s2d_launches // 2} times per embed")
    log(f"    channel rule {rule} (as shipped, {launches // n_batches // 2} "
        f"launches per tower forward): warm embed "
        f"{min(embed_times):.3f} s (runs "
        f"{', '.join(f'{t:.3f}' for t in embed_times)}); rule {alt} "
        f"({alt_launches // n_batches // 2} launches per tower forward): "
        f"{min(alt_times):.3f} s (runs "
        f"{', '.join(f'{t:.3f}' for t in alt_times)})")

    requests = [dict(seconds=10, seed=1),
                dict(seconds=30, threshold=0.2, seed=2),
                dict(seconds=10, seed=1)]
    outs = []
    for req in requests:
        out = server.synthesize(**req)
        frames, intp = out["frames"], out["frames_intp"]
        if (frames.dtype != np.uint8 or frames.shape[1:] != (res, res, 3)
                or len(frames) < req["seconds"] * fps or intp is None):
            raise AssertionError(f"bad texture for {req}")
        outs.append(out)
        t = out["timings"]
        log(f"    request {req}: {len(out['result'].indices)} steps, "
            f"{int(out['result'].jumps[1:].sum())} jumps, {len(frames)} "
            f"frames ({len(intp)} interpolated), walk {t['walk_s']:.4f} s, "
            f"stitch {t['stitch_s']:.4f} s")
    if not np.array_equal(outs[0]["result"].indices,
                          outs[2]["result"].indices):
        raise AssertionError("a repeated request gave other indices")
    tables = (server.q_table, server.t_table)  # phase 10 walks on them
    ref_indices = outs[0]["result"].indices  # phase 13 (b) serves it again
    slomo_phase(server, requests[1], outs[1], fps)
    checkpoint_phase(server, cfg, embed)

    def per_tower(key):
        return sum(r[key] * r["per_tower"] for r in main_rows)

    kernels = [{
        "name": "fused_conv1x1", "route": "cuda",
        "source": "avtex_torch/csrc/fused_conv1x1.cu",
        "replaces": "avtex/ops/fused_matmul.py:192",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_tower("ms"), "plain_ms": per_tower("plain_ms"),
        "bound_ms": per_tower("bound_ms"),
        "bound_by": ("bytes" if per_tower("bytes_ms") >= per_tower("ops_ms")
                     else "operations"),
        "library_ms": None, "matmul_ms": per_tower("matmul_ms"),
        "chain_ms": per_tower("chain_ms"),
        "per": f"one tower forward at batch {batch} "
               f"({LAUNCHES_PER_BATCH // 2} launches)",
    }]
    del outs  # phase 11 serves -daf Contrastive and CAMs from `server`
    torch.cuda.empty_cache()
    kernels[0]["launches_audio_path"], audio = audio_phase(
        cfg, video, fps, n_batches, min(embed_times))
    torch.cuda.empty_cache()

    kernels.append(classic_phases(report))
    kernels.append(stage_phase(cfg, video, state, res, report))
    torch.cuda.empty_cache()
    train_phase(video, fps)
    torch.cuda.empty_cache()
    slice12_phase(tables, audio, video, fps, kernels[1])
    torch.cuda.empty_cache()
    contrastive_phase(server, audio, video, fps, kernels[0])
    torch.cuda.empty_cache()
    import_phase(server, video, fps, kernels[0])
    torch.cuda.empty_cache()
    parallel = parallel_phase(cfg, server, video, fps, n_batches,
                              audio.pop("m2"), ref_indices)
    kernels[0]["launches_sharded_embed"] = parallel["launches"]
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"parallel": parallel}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def train_phase(video: np.ndarray, fps: int) -> dict:
    """Phase 9: contrastive training on the card (module docstring).
    Returns the phase's numbers."""
    import tempfile
    import torch
    from avtex_torch.audio import waveform_to_examples
    from avtex_torch.config import Config
    from avtex_torch.contrastive.model import ContrastiveTextures
    from avtex_torch.convert import convert_opt_state, convert_params
    from avtex_torch.data.pipeline import SegmentBatches
    from avtex_torch.media import read_wav, write_wav
    from avtex_torch.synth import TextureServer
    from avtex_torch.synth.pipeline import flax_style_init
    from avtex_torch.train import (create_state, make_train_step,
                                   restore_checkpoint, save_checkpoint)
    from avtex_torch.train.loop import step_generator

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    torch.cuda.empty_cache()
    out = {}

    def config(arch="resnet18", bs=TRAIN_BS, negs=TRAIN_NEGS, **kw):
        return Config(enc_arch=arch, batch_size=bs, n_negs=negs, seed=0,
                      **kw).derive_geometry(fps)

    def batches(cfg, n, audio=None):
        data = SegmentBatches(video, cfg.window, cfg.train_stride,
                              n_negs=cfg.n_negs, batch_size=cfg.batch_size,
                              audio_examples=audio, seed=cfg.seed,
                              drop_last=True)
        it = data.epoch(0)
        return data, [next(it) for _ in range(n)]

    def build(cfg, n_batches, remat=True, dtype=torch.bfloat16, params=None,
              device="cuda", **kw):
        model = ContrastiveTextures(cfg.enc_arch, cfg.model_type, cfg.temp,
                                    dtype=dtype, norm="group", remat=remat,
                                    **kw).to(device)
        state = create_state(model, cfg, n_batches, params)
        step = make_train_step(model, cfg.img_size,
                               cfg.enc_arch == "slowfast", cfg.augment)
        return state, step

    def run(state, step, bats, first_step=0):
        """Steps over ``bats``: losses, and ms of each (synchronised)."""
        losses, ms = [], []
        for k, batch in enumerate(bats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch, step_generator(0, first_step + k))
            losses.append(float(m["loss"]))  # waits for the step
            ms.append((time.perf_counter() - t0) * 1e3)
        return losses, ms

    def finite(losses, label):
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{label}: a loss is not finite: {losses}")

    def timed(label, cfg, n_steps, **kw):
        """(a)/(b): ``n_steps`` steps, the first a warm-up; ms per step,
        clips/s and peak memory; then one profiled step."""
        data, bats = batches(cfg, n_steps + 2)
        torch.cuda.reset_peak_memory_stats()
        state, step = build(cfg, len(data), **kw)
        losses, ms = run(state, step, bats[:n_steps])
        finite(losses, label)
        clips = cfg.batch_size * (2 + cfg.n_negs)
        warm = float(np.mean(ms[1:]))
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"    ({label}) {cfg.enc_arch}, -bs {cfg.batch_size} -negs "
            f"{cfg.n_negs} ({clips} clips of {cfg.window}x{cfg.img_size}^2 "
            f"a step), bf16, fp32 master, remat, augmentation: {n_steps} "
            f"steps, losses {', '.join(f'{x:.4f}' for x in losses)}; "
            f"first step {ms[0]:.1f} ms, then {warm:.1f} ms per step "
            f"(runs {', '.join(f'{x:.1f}' for x in ms[1:])}), "
            f"{clips / warm * 1e3:.1f} clips/s, peak {peak:.2f} GiB "
            f"({smi})")
        out[label] = {"arch": cfg.enc_arch, "step_ms": warm,
                      "first_step_ms": ms[0], "clips_per_s": clips / warm * 1e3,
                      "peak_gib": peak, "losses": losses}
        # where a step's device time goes: two more steps, the second
        # profiled (kernel_device_ms)
        gen = iter(range(n_steps, n_steps + 2))
        kms = kernel_device_ms(lambda: step(
            state, bats[n_steps], step_generator(0, next(gen))))
        total = sum(kms.values())
        shares = {}
        for name, t in kms.items():
            kind = next((k for k, pats in TRAIN_KINDS
                         if any(p in name.lower() for p in pats)), "other")
            shares[kind] = shares.get(kind, 0.0) + t
        top = sorted(kms.items(), key=lambda kv: -kv[1])[:6]
        log(f"        one profiled step: device time {total:.1f} ms of "
            f"{warm:.1f} ms ({100 * (1 - total / warm):.1f}% idle); "
            + ", ".join(f"{k} {100 * v / total:.1f}%" for k, v in
                        sorted(shares.items(), key=lambda kv: -kv[1]))
            + "; top kernels: " + "; ".join(
                f"{demangled(k)[:60]} {v:.1f} ms" for k, v in top))
        out[label].update(device_ms=total, shares={
            k: v / total for k, v in shares.items()})
        return state, step, data, bats

    log(f"[9] training: the {len(video) / fps:.0f} s video at "
        f"{video.shape[1]}^2, W = {config().window}, S = "
        f"{config().train_stride} ({smi})")

    # (a) ResNet18 at full width, then (f) on the same state
    cfg_a = config()
    state_a, step_a, data_a, bats_a = timed("a", cfg_a, 5)
    log(f"    {data_a.n_train} train queries, {len(data_a)} steps an "
        f"epoch at -bs {cfg_a.batch_size}")
    if data_a.n_train != 296:
        raise AssertionError(f"{data_a.n_train} train queries, expected 296")

    # (f) checkpoint, resume, serve
    t_f = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    saved_step = state_a.step
    path = save_checkpoint(tmp.name, "smoke", state_a.params_tree(), 1,
                           cfg_a.enc_arch, out["a"]["losses"][-1], True,
                           opt_state=state_a.opt_state_tree(),
                           step=state_a.step)
    serve_cfg = Config(enc_arch="resnet18", norm="group", seed=0)
    trained = {k: v.detach().clone()
               for k, v in state_a.model.state_dict().items()}
    in_memory = TextureServer.from_frames(serve_cfg, video, float(fps),
                                          params=trained, device="cuda")
    want_tables = (in_memory.q_table.clone(), in_memory.t_table.clone())
    del in_memory, trained
    torch.cuda.empty_cache()
    payload = restore_checkpoint(path)
    state_r, step_r = build(cfg_a, len(data_a))
    state_r.load_params(convert_params(payload["state"], state_r.model))
    momentum, count = convert_opt_state(payload["opt_state"], state_r.model)
    state_r.load_momentum(momentum)
    state_r.step = int(payload["step"])
    mom_a = state_a.momentum()
    restored_exact = count == state_a.step and all(
        torch.equal(state_r.params[n], p) and torch.equal(
            state_r.optimizer.state[state_r.params[n]]["momentum_buffer"],
            mom_a[n]) for n, p in state_a.params.items())
    if not restored_exact:
        raise AssertionError("the restored parameters or momentum differ")
    served = TextureServer.from_frames(
        serve_cfg, video, float(fps),
        params=convert_params(payload["state"],
                              ContrastiveTextures("resnet18")),
        device="cuda")
    same_tables = (torch.equal(served.q_table, want_tables[0])
                   and torch.equal(served.t_table, want_tables[1]))
    req = served.synthesize(seconds=10, seed=1)
    frames = req["frames"]
    if (not same_tables or frames.dtype != np.uint8
            or frames.shape[1:] != video.shape[1:]
            or len(frames) < 10 * fps):
        raise AssertionError(f"trained model served wrong: tables equal "
                             f"{same_tables}, frames {frames.shape}")
    del served
    torch.cuda.empty_cache()
    # the next step from the file and from memory, deterministic kernels
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        loss_u, _ = run(state_a, step_a, bats_a[5:6], first_step=5)
        loss_r, _ = run(state_r, step_r, bats_a[5:6], first_step=5)
    finally:
        torch.use_deterministic_algorithms(False)
    bit_identical = loss_u == loss_r and all(
        torch.equal(state_r.params[n], p) for n, p in state_a.params.items())
    param_err = max(float((state_r.params[n] - p).detach().abs().max())
                    / max(float(p.detach().abs().max()), 1e-30)
                    for n, p in state_a.params.items())
    log(f"    (f) save_checkpoint after (a) ({os.path.getsize(path) / 2**20:.1f}"
        f" MiB, step {saved_step}) -> restore_checkpoint: parameters and "
        f"momentum bit-identical; TextureServer.from_frames(norm='group') "
        f"from the file: [{len(want_tables[0])}, {want_tables[0].shape[1]}] "
        f"tables bit-identical to the in-memory model's; 10 s request "
        f"{len(req['result'].indices)} steps, {len(frames)} frames; the "
        f"next step resumed vs uninterrupted (deterministic algorithms): "
        f"loss {loss_r[0]:.6f} vs {loss_u[0]:.6f}, bit-identical "
        f"{bit_identical}, parameters within {param_err:.3g} of each "
        f"tensor's largest; {time.perf_counter() - t_f:.1f} s ({smi})")
    if loss_r != loss_u or param_err > RESUME_TOL:
        raise AssertionError("the resumed step differs from the "
                             "uninterrupted one")
    out["f"] = {"bit_identical": bit_identical, "param_err": param_err,
                "ckpt_mib": os.path.getsize(path) / 2**20}
    tmp.cleanup()
    del state_a, step_a, state_r, step_r, bats_a
    torch.cuda.empty_cache()

    # (b) SlowFast-R50
    timed("b", config("slowfast"), 3)
    torch.cuda.empty_cache()

    # (c) overfit one fixed batch, no augmentation
    cfg_c = config(augment=False)
    data_c, [batch_c] = batches(cfg_c, 1)
    state_c, step_c = build(cfg_c, len(data_c))
    losses_c, ms_c = run(state_c, step_c, [batch_c] * 15)
    finite(losses_c, "c")
    log(f"    (c) overfit one batch of (a)'s size, no augmentation: loss "
        f"{losses_c[0]:.4f} -> {losses_c[-1]:.4f} in 15 steps "
        f"({', '.join(f'{x:.3f}' for x in losses_c)}); "
        f"{np.mean(ms_c[1:]):.1f} ms per step ({smi})")
    if not losses_c[-1] < losses_c[0]:
        raise AssertionError("the overfit loss did not fall")
    out["c"] = {"first": losses_c[0], "last": losses_c[-1]}
    del state_c, step_c
    torch.cuda.empty_cache()

    # (d) the memory evidence for remat=True
    cfg_d = config(bs=2, negs=2)
    data_d, [batch_d] = batches(cfg_d, 1)
    peaks = {}
    for remat in (True, False):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        state_d, step_d = build(cfg_d, len(data_d), remat=remat)
        loss_d, ms_d = run(state_d, step_d, [batch_d])
        finite(loss_d, "d")
        peaks[remat] = (torch.cuda.max_memory_allocated() - base) / 2**30
        del state_d, step_d
    # and (a)'s batch without remat, beside (a)'s peak with it
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    data_full, [batch_full] = batches(cfg_a, 1)
    state_d, step_d = build(cfg_a, len(data_full), remat=False)
    loss_full, ms_full = run(state_d, step_d, [batch_full])
    finite(loss_full, "d")
    peak_full = torch.cuda.max_memory_allocated() / 2**30
    del state_d, step_d
    log(f"    (d) one ResNet18 step at -bs 2 -negs 2 (8 clips): peak "
        f"{peaks[True]:.2f} GiB with remat, {peaks[False]:.2f} GiB without "
        f"({peaks[False] / peaks[True]:.2f}x); at (a)'s -bs "
        f"{cfg_a.batch_size} -negs {cfg_a.n_negs} without remat: peak {peak_full:.2f} GiB against (a)'s "
        f"{out['a']['peak_gib']:.2f} GiB with it, {ms_full[0]:.1f} ms for "
        f"its first step ({smi})")
    out["d"] = {"remat_gib": peaks[True], "no_remat_gib": peaks[False],
                "full_no_remat_gib": peak_full}

    # (e) the card against the CPU, fp32
    cfg_e = config("resnet10", bs=2, negs=2, img_size=CPU_SIZE,
                   compute_dtype="float32", lr=CPU_LR)
    data_e, bats_e = batches(cfg_e, 2)
    params_e = flax_style_init(
        ContrastiveTextures("resnet10", width=CPU_WIDTH), 0)
    runs = {}
    with fp32_exact(), torch.backends.mkldnn.flags(enabled=False):
        for dev in ("cpu", "cuda"):
            st, sp = build(cfg_e, len(data_e), dtype=torch.float32,
                           params=params_e, device=dev, width=CPU_WIDTH)
            losses, _ = run(st, sp, bats_e)
            runs[dev] = (losses, {n: p.detach().cpu()
                                  for n, p in st.params.items()})
    (loss_c, par_c), (loss_g, par_g) = runs["cpu"], runs["cuda"]
    loss_err = max(abs(a - b) for a, b in zip(loss_c, loss_g))
    par_err = float(torch.sqrt(sum(((par_g[n] - p) ** 2).sum()
                                   for n, p in par_c.items()))
                    / torch.sqrt(sum((p ** 2).sum() for p in par_c.values())))
    worst = max(par_c, key=lambda n: float((par_g[n] - par_c[n]).norm()
                                           / par_c[n].norm()))
    worst_err = float((par_g[worst] - par_c[worst]).norm()
                      / par_c[worst].norm())
    log(f"    (e) resnet10 width {CPU_WIDTH} at {CPU_SIZE}^2, fp32, TF32 "
        f"off, LR {CPU_LR:g}, two steps with augmentation from the same "
        f"parameters and batches: losses card {loss_g} vs CPU {loss_c}, "
        f"max |diff| {loss_err:.3g} (<= {CPU_LOSS_TOL:g}); parameters' "
        f"relative L2 error {par_err:.3g} (<= {CPU_PARAM_TOL:g}); the "
        f"worst tensor {worst} at {worst_err:.3g} ({smi})")
    if loss_err > CPU_LOSS_TOL or par_err > CPU_PARAM_TOL:
        raise AssertionError("training on the card disagrees with the CPU")
    out["e"] = {"loss_err": loss_err, "param_err": par_err,
                "worst_tensor_err": worst_err}

    # (g) model_type=2 with phase 5d's source wav
    with tempfile.TemporaryDirectory() as wav_dir:
        wave, sr = read_wav(write_wav(
            os.path.join(wav_dir, "source.wav"),
            tone_track(len(video) / fps, 22050, fps, 0, 0), 22050))
    examples = waveform_to_examples(wave, sr, device="cuda").cpu().numpy()
    cfg_g = config(model_type=2)
    data_g, bats_g = batches(cfg_g, 2, audio=examples)
    state_g, step_g = build(cfg_g, len(data_g))
    vgg0 = state_g.params["audio_encoder.Conv_0.weight"].clone()
    losses_g, ms_g = run(state_g, step_g, bats_g)
    finite(losses_g, "g")
    moved = float((state_g.params["audio_encoder.Conv_0.weight"]
                   - vgg0).abs().max())
    log(f"    (g) -m 2, ResNet18 + VGGish on {len(examples)} examples of "
        f"the source wav: losses {', '.join(f'{x:.4f}' for x in losses_g)}, "
        f"ms {', '.join(f'{x:.1f}' for x in ms_g)}; VGGish Conv_0 moved by "
        f"{moved:.3g} ({smi})")
    if not moved > 0:
        raise AssertionError("the VGGish weights did not move")
    out["g"] = {"losses": losses_g, "vggish_moved": moved}
    del state_g, step_g
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"    phase 9: {out['seconds']:.1f} s ({smi})")
    log("[9] summary " + json.dumps(out))
    return out


def classic_phases(build_report: dict) -> dict:
    """Phases 6 and 7; returns pairwise_l2's entry of the kernels line."""
    import dataclasses

    import torch
    import avtex_torch.classic.driver as classic_driver
    from avtex_torch.classic import (classic_transition_matrix, compute_d1,
                                     compute_d2, compute_d3, rgb_features)
    from avtex_torch.config import ClassicConfig
    from avtex_torch.ops import launch_counts, reset_launch_counts
    from avtex_torch.ops.pairwise import pairwise_l2_reference

    fps = 30
    video = synthetic_video(CLASSIC_SECONDS, fps)
    feats, _ = rgb_features(video, "cuda")
    n, f = feats.shape

    # ---- 6. pairwise_l2 vs plain version -------------------------------- #
    regs = {k: v for k, v in ptxas_registers(
        build_report["pairwise_l2"]["log"]).items() if "pairwise" in k}
    gram_regs = max((v for k, v in regs.items() if "gram" in k),
                    default=None)
    log(f"[6] pairwise_l2 vs plain at N={n} F={f} (RGB rows of the "
        f"{CLASSIC_SECONDS} s video), normalized, and ragged shapes; "
        f"tolerance |Dk^2 - Dp^2| <= {SQ_TOL:g} (|x_i|^2 + |x_j|^2); "
        f"diagonal exactly 0, output exactly symmetric, repeat launches "
        f"bit-identical; registers "
        + (", ".join(f"{demangled(k)} {v}" for k, v in regs.items())
           or "not reported (cached build)"))
    main = check_pairwise(feats, False, True)
    log(f"    split plan at N={n}, F={f}: S={main['splits']} splits x "
        f"{main['tiles']} tiles = {main['blocks']} blocks of the Gram "
        f"kernel, {main['blocks_per_sm']} per SM on {main['sms']} SMs "
        f"({main['blocks'] / (main['blocks_per_sm'] * main['sms']):.3g} "
        f"waves); workspace {main['workspace_bytes'] / 1e6:.1f} MB")
    checks = [main, check_pairwise(feats, True, True)]
    g = torch.Generator(device="cuda").manual_seed(6)
    # N = 1; F inside one slab (3); F shorter than one split (1001, and
    # 500 at the path's N); a ragged last split (12289); grids that are
    # not a whole number of waves (N = 129, 777)
    for rn, rf in [(rn, rf) for rn in (1, 129, 777)
                   for rf in (3, 1001, 12289, 12292)] + [(n, 500)]:
        x = torch.randint(0, 256, (rn, rf), generator=g,
                          device="cuda").float()
        checks.append(check_pairwise(x, False, False))
    for r in checks:
        waves = r["blocks"] / (r["blocks_per_sm"] * r["sms"])
        last = r["F"] - r["F"] // 16 * 16
        line = (f"    N={r['N']:>5} F={r['F']:>6} norm={int(r['normalize'])}"
                f" S={r['splits']} ({r['blocks']} blocks, {waves:.3g} "
                f"waves{', last slab ' + str(last) + ' wide' if last else ''})"
                f": sq ratio {r['sq_ratio']:.3g} (kernel vs fp64 "
                f"{r['kernel_vs_fp64']:.3g}, plain vs fp64 "
                f"{r['plain_vs_fp64']:.3g}, one fp32 product vs fp64 "
                f"{r['one_product_vs_fp64']:.3g}), max |Dk-Dp| "
                f"{r['max_abs_err']:.4g}, diagonal 0 {r['diag_zero']}, "
                f"symmetric {r['symmetric']}, repeat identical "
                f"{r['repeat']}")
        if "ms" in r:
            line += (f"; ms {r['ms']:.3f} plain {r['plain_ms']:.3f} "
                     f"cdist {r['library_ms']:.3f} bound {r['bound_ms']:.3f}"
                     f" ({r['bound_by']}; the full square "
                     f"{r['full_square_ms']:.3f}); device time of one call: "
                     f"Gram kernel {r['gram_ms']:.3f}, epilogue kernel "
                     f"{r['epilogue_ms']:.3f}, the wrapper's other kernels "
                     f"(row norms) {r['other_device_ms']:.3f}")
        log(line)
    bad = [r for r in checks if not r["ok"]]
    if bad:
        raise AssertionError(f"pairwise_l2 disagrees with its plain "
                             f"version: {bad}")

    # ---- 7. the classic path -------------------------------------------- #
    cfg = ClassicConfig()
    s0 = cfg.sigmas[0]
    runs = [("mode 1", cfg),
            ("mode 2", dataclasses.replace(cfg, model_type=2,
                                           sigmas=(s0,))),
            ("mode 3", dataclasses.replace(cfg, model_type=3,
                                           sigmas=(s0,))),
            ("mode 3 again", dataclasses.replace(cfg, model_type=3,
                                                 sigmas=(s0,)))]
    d1_calls = 0
    real_compute_d1 = classic_driver.compute_d1

    def counting_compute_d1(*a, **k):
        nonlocal d1_calls
        d1_calls += 1
        return real_compute_d1(*a, **k)

    torch.cuda.reset_peak_memory_stats()
    classic_driver.compute_d1 = counting_compute_d1
    reset_launch_counts()
    try:
        results = {}
        for label, rcfg in runs:
            t0 = time.perf_counter()
            results[label] = classic_driver.run_classic_frames(
                rcfg, video, float(fps), out_dir=None, device="cuda")
            results[label]["wall_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fused = classic_transition_matrix(
            feats, s0, filter_size=cfg.filter_size, stride=1, p=cfg.q_p,
            alpha=cfg.q_alpha, eps=cfg.q_eps,
            thresholding=cfg.threshold).cpu().numpy()
        fused_s = time.perf_counter() - t0
        launches = launch_counts()["pairwise_l2"]
    finally:
        classic_driver.compute_d1 = real_compute_d1
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[7] classic path: {d1_calls} compute_d1 calls + 1 "
        f"classic_transition_matrix call, pairwise_l2 launches {launches}, "
        f"peak device memory {peak:.2f} GiB; P3 walked on the device (the "
        f"fetch: the walk and the sigmas; PR 10's host walk took 11-27 ms "
        f"a sigma after a fetch of P3)")
    problems = []
    if launches != d1_calls + 1:
        problems.append(f"{launches} launches for {d1_calls + 1} D1 calls")
    for label, rcfg in runs:
        out = results[label]
        log(f"    {label}: {out['wall_s']:.2f} s for {len(rcfg.sigmas)} "
            f"sigma(s)")
        adv = rcfg.stride if rcfg.model_type == 2 else 0
        for sigma, e in out["sigma_results"].items():
            t, p3 = e["timings"], e["p3_new"].cpu().numpy()
            log(f"      sigma {sigma}: N={len(p3)} D1 {t['d1_s']:.4f} s, "
                f"D2 {t['d2_s']:.4f} s, D3 {t['d3_s']:.4f} s "
                f"({e['sweeps']} sweeps), device walk {t['walk_s']:.4f} "
                f"s, fetch {t['fetch_s']:.4f} s, bars {t['bars_s']:.4f} "
                f"s, interp "
                f"{t['interp_s']:.4f} s; {len(e['walk']) - 1} steps, "
                f"{e['jump_count']} jumps, {len(e['frames'])} frames"
                + (f" ({len(e['frames_intp'])} interpolated)"
                   if e["frames_intp"] is not None else "")
                + f", survivors per row {int((p3 > 0).sum(1).min())}.."
                  f"{int((p3 > 0).sum(1).max())}")
            if not (np.isfinite(p3).all() and (p3 >= 0).all()
                    and (p3.max(axis=1) > 0).all()):
                problems.append(f"{label} sigma {sigma}: bad P3_new")
            if not check_walk(p3, e["walk"], adv):
                problems.append(f"{label} sigma {sigma}: a transition to a "
                                f"zero entry")
            if (e["frames"].dtype != np.uint8
                    or e["frames"].shape != (len(e["frame_ids"]),)
                    + video.shape[1:]
                    or (rcfg.model_type == 1) != (e["frames_intp"]
                                                  is not None)):
                problems.append(f"{label} sigma {sigma}: bad texture")
    again = [e["walk"] for r in ("mode 3", "mode 3 again")
             for e in results[r]["sigma_results"].values()]
    if not np.array_equal(*again):
        problems.append("a repeated run gave other indices")
    staged = results["mode 1"]["sigma_results"][s0]["p3_new"].cpu().numpy()
    if not np.array_equal(fused, staged):
        problems.append("classic_transition_matrix differs from the "
                        "staged P3_new of run_classic_frames")
    log(f"    classic_transition_matrix: {fused_s:.2f} s, equal to the "
        f"staged P3_new: {np.array_equal(fused, staged)}")

    # P3 from the kernel's D1 against P3 from the plain version's D1, and
    # each against P3 from an fp64 D1.
    def p3_from(d1):
        d2, _, _ = compute_d2(d1, s0, cfg.filter_size, 1)
        _, p3, _, _ = compute_d3(d2, s0, p=cfg.q_p, alpha=cfg.q_alpha,
                                 eps=cfg.q_eps, thresholding=cfg.threshold)
        return p3.double()

    rows = feats.double()
    sq = (rows * rows).sum(1)
    d1_true = (sq[:, None] + sq[None, :] - 2.0 * (rows @ rows.t())
               ).clamp_min(0)
    d1_true.fill_diagonal_(0.0)
    del rows
    p3_true = p3_from(d1_true.sqrt().float())
    del d1_true
    p3_kernel = p3_from(compute_d1(feats, s0)[0])
    with fp32_exact():
        p3_plain = p3_from(pairwise_l2_reference(feats))

    def p3_diff(a, b):
        return float(((a - b).abs() / b.amax(1, keepdim=True)).max())

    p3_rel = p3_diff(p3_kernel, p3_plain)
    log(f"    P3 from D1, max |dP3| / row max: kernel vs plain {p3_rel:.3g} "
        f"(tolerance {P3_RTOL:g}); kernel vs fp64 "
        f"{p3_diff(p3_kernel, p3_true):.3g}; plain vs fp64 "
        f"{p3_diff(p3_plain, p3_true):.3g}")
    if p3_rel > P3_RTOL:
        problems.append(f"P3 from the kernel's D1 differs from P3 from the "
                        f"plain version's by {p3_rel:.3g} of the row max")
    log("    " + nvidia_smi_line())
    if problems:
        raise AssertionError("classic path: " + "; ".join(problems))

    r = main
    return {"name": "pairwise_l2", "route": "cuda",
            "source": "avtex_torch/csrc/pairwise_l2.cu",
            "replaces": "avtex/ops/pairwise.py:74", "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "splits": r["splits"], "registers": gram_regs,
            "gram_ms": r["gram_ms"], "epilogue_ms": r["epilogue_ms"],
            "blocks_per_sm": r["blocks_per_sm"],
            "workspace_mb": r["workspace_bytes"] / 1e6,
            "max_sq_ratio": max(c["sq_ratio"] for c in checks),
            "per": f"one call (a launch pair) at N={n}, F={f}"}


def check_stage(x, blocks, stride: int, label: str) -> dict:
    """fused_stage's kernel against its plain version on the card: every
    block alone on the plain chain's input (elementwise gate), then the
    whole stage (relative Frobenius gate). The kernel launches here are
    comparisons; the caller reads the main path's count before them."""
    import torch
    from avtex_torch.ops import stage_fused as sf
    h, worst_block, max_abs = x, 0.0, 0.0
    ok = True
    for i, blk in enumerate(blocks):
        s = stride if i == 0 else 1
        got = sf.launch_block(h.contiguous(), sf.pack_block(blk, x.device),
                              s)
        torch.cuda.synchronize()
        with fp32_exact():
            want = sf._block_reference(h, blk, s)
        diff = (got.float() - want.float()).abs()
        tol = STAGE_RTOL * want.float().abs() + STAGE_ATOL
        ok = ok and bool((diff <= tol).all()) and got.shape == want.shape
        worst_block = max(worst_block, float((diff / tol).max()))
        max_abs = max(max_abs, float(diff.max()))
        del got, diff, tol
        h = want
    got = sf.fused_stage(x, blocks, stride)
    torch.cuda.synchronize()
    fro = float(torch.linalg.vector_norm(got.float() - h.float())
                / torch.linalg.vector_norm(h.float()))
    max_abs = max(max_abs, float((got.float() - h.float()).abs().max()))
    ok = ok and fro <= STAGE_FRO and bool(torch.isfinite(got).all())
    log(f"    {label}: x {tuple(x.shape)} -> {tuple(got.shape)}, "
        f"{len(blocks)} block(s): worst block err / tol {worst_block:.3g}, "
        f"stage rel Frobenius {fro:.3g}, max |kernel - plain| "
        f"{max_abs:.4g}; plain output mean |y| "
        f"{float(h.float().abs().mean()):.4g}, share > 0 "
        f"{float((h > 0).float().mean()):.3f}")
    return {"label": label, "ok": ok, "fro": fro, "max_abs_err": max_abs,
            "worst_block_ratio": worst_block}


def random_stage(cin, f, cout, n_blocks, seed):
    """Seeded blocks on the card whose activations stay O(1)."""
    import torch
    from avtex_torch.ops.stage_fused import BlockWeights
    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk(*shape):
        fan_in = shape[-2] * (9 if len(shape) == 4 else 1)
        return torch.randn(*shape, generator=g, device="cuda") * fan_in ** -.5

    def aff(n):
        return (torch.rand(n, generator=g, device="cuda") + 0.5,
                torch.randn(n, generator=g, device="cuda") * 0.1)

    blocks, c = [], cin
    for i in range(n_blocks):
        (s1, b1), (s2, b2), (s3, b3) = aff(f), aff(f), aff(cout)
        sp, bp = aff(cout) if i == 0 else (None, None)
        blocks.append(BlockWeights(
            mk(c, f), s1, b1, mk(3, 3, f, f), s2, b2, mk(f, cout), s3, b3,
            mk(c, cout) if i == 0 else None, sp, bp))
        c = cout
    return blocks


def block_bound_times(bt, h, w, cin, f, cout, stride, proj):
    """(bytes ms, operations ms) of one bottleneck launch: its input read
    once, its output written once and its weights read once over the HBM
    rate; its operations over the bf16 tensor-core peak."""
    ho, wo = h // stride, w // stride
    wbytes = 2 * (cin * f + 9 * f * f + f * cout + (cin * cout if proj
                                                     else 0))
    nbytes = 2 * bt * (h * w * cin + ho * wo * cout) + wbytes
    return (nbytes / PEAK_BYTES_S * 1e3,
            block_flops(bt, h, w, cin, f, cout, stride, proj)
            / PEAK_BF16_FLOP_S * 1e3)


def stage_phase(cfg, video: np.ndarray, state: dict, res: int,
                build_report: dict) -> dict:
    """Phase 8; returns fused_stage's entry of the kernels line."""
    import torch
    from avtex_torch.data.preprocess import preprocess_clip
    from avtex_torch.nn.slowfast import SlowFastR50, slowfast_pathways
    from avtex_torch.ops import launch_counts, reset_launch_counts
    from avtex_torch.ops import stage_fused as sf

    t_phase = time.perf_counter()
    encs = {}
    for fuse in ("all", False):
        m = SlowFastR50(norm="affine", fuse=fuse)
        m.load_state_dict(state)
        encs[fuse] = m.cuda().eval()
    n_clips = cfg.mini_batchsize
    W, S = cfg.window, cfg.stride
    video_dev = torch.from_numpy(video).cuda()
    idx = (torch.arange(n_clips, device="cuda")[:, None] * S
           + torch.arange(W, device="cuda")[None])
    caps = {}

    def grab(name):
        def hook(mod, args):
            caps[name] = args[0]
        return hook

    hooks = [getattr(encs["all"], f"SFBottleneck_{ids[0]}")
             .register_forward_pre_hook(grab(name))
             for name, (ids, _) in STAGES.items()]
    with torch.inference_mode():
        clips = slowfast_pathways(preprocess_clip(video_dev[idx], res, True))
        encs["all"](*clips)
    for hk in hooks:
        hk.remove()
    del clips, video_dev
    torch.cuda.empty_cache()

    sd = encs["all"].state_dict()
    xs, blocks = {}, {}
    for name, (ids, _) in STAGES.items():
        c = caps[name]
        rows = c.permute(0, 2, 3, 4, 1)  # channels_last_3d: a free view
        if not rows.is_contiguous():
            raise AssertionError(f"{name} input is not channels-last")
        xs[name] = rows.reshape(-1, c.shape[3], c.shape[4], c.shape[1])
        blocks[name] = sf.stage_weights_from_params(sd, ids)
    regs = {demangled(k): v for k, v in ptxas_registers(
        build_report["fused_stage"]["log"]).items()}
    log(f"[8] fused_stage on slow res2 and res3 of the full-width encoder, "
        f"inputs captured from one forward of {n_clips} clips: "
        + ", ".join(f"{k} {tuple(v.shape)}" for k, v in xs.items())
        + f"; gates: block err <= {STAGE_RTOL:g}|ref| + {STAGE_ATOL:g}, "
          f"stage rel Frobenius <= {STAGE_FRO:g}, cosine vs the model's "
          f"blocks >= {STAGE_COS:g} per slice, a repeat launch "
          f"bit-identical; kernel registers (-Xptxas -v, at entry; "
          f"setmaxnreg gives the consumers more) "
        + (", ".join(f"{k} {v}" for k, v in sorted(regs.items()))
           or "not reported (cached build)"))

    # the path: both stages through the wrapper, counts read around it
    with torch.inference_mode():
        reset_launch_counts()
        outs = {name: sf.fused_stage(xs[name], blocks[name], stride)
                for name, (_, stride) in STAGES.items()}
        torch.cuda.synchronize()
        launches = launch_counts()["fused_stage"]
    log(f"    fused_stage launches on the path: {launches} (expected "
        f"{STAGE_LAUNCHES}: one per block)")
    problems = []
    if launches != STAGE_LAUNCHES:
        problems.append(f"{launches} launches, expected {STAGE_LAUNCHES}")

    checks, rows_out = [], {}
    with torch.inference_mode():
        for name, (ids, stride) in STAGES.items():
            x, out = xs[name], outs[name]
            repeat = bool(torch.equal(sf.fused_stage(x, blocks[name], stride),
                                      out))
            log(f"    {name}: a repeat launch bit-identical: {repeat}")
            if not repeat:
                problems.append(f"{name}: a repeat launch differs")
            checks.append(check_stage(x, blocks[name], stride,
                                      f"{name} at BT={x.shape[0]}"))
            c = caps[name]

            def chain(enc, c=c, ids=ids):  # the model's own blocks
                y = c
                for i in ids:
                    y = getattr(enc, f"SFBottleneck_{i}")(y)
                return y

            cos = {}
            for fuse, enc in encs.items():
                y = chain(enc).permute(0, 2, 3, 4, 1).reshape(out.shape)
                cos[fuse] = float(torch.nn.functional.cosine_similarity(
                    out.float().reshape(out.shape[0], -1),
                    y.float().reshape(out.shape[0], -1), dim=1).min())
                del y
            log(f"    {name} vs the model's blocks: cosine min "
                f"{cos['all']:.6f} (fuse='all'), {cos[False]:.6f} "
                f"(fuse=False, cuDNN)")
            if min(cos.values()) < STAGE_COS:
                problems.append(f"{name}: cosine {cos} vs the model")

            packed = [sf.pack_block(b, x.device) for b in blocks[name]]

            def kernel_only(x=x, packed=packed, stride=stride):
                y = x
                for i, p in enumerate(packed):
                    y = sf.launch_block(y, p, stride if i == 0 else 1)
                return y

            bt, h, w, cin = x.shape
            f, cout = blocks[name][0].w1.shape[1], out.shape[-1]
            t_bytes, t_ops, t_hand = stage_bound_times(
                bt, h, w, cin, f, cout, len(ids), stride)
            ins = [x]
            for i, p in enumerate(packed[:-1]):
                ins.append(sf.launch_block(ins[-1], p, stride if i == 0
                                           else 1))
            block_ms, block_tflops, plans = [], [], []
            for i, xi in enumerate(ins):
                st = stride if i == 0 else 1
                pl = sf.plan(*xi.shape[1:], f, cout, st, proj=i == 0,
                             bt=xi.shape[0])
                seen = sf.kernel_plan_check(pl, f, x.device)
                ms = time_ms(lambda: sf.launch_block(xi, packed[i], st, pl),
                             reps=5)
                b_bytes, b_ops = block_bound_times(*xi.shape, f, cout, st,
                                                   i == 0)
                kname = (f"fused_block_kernel<{64 if f <= 64 else 128},"
                         f"{pl['warpgroups']}>")
                block_ms.append(ms)
                block_tflops.append(block_flops(*xi.shape, f, cout, st,
                                                i == 0) / ms / 1e9)
                plans.append({
                    "block": f"{name}.{i}", "tile": list(pl["tile"]),
                    "warpgroups": pl["warpgroups"],
                    "b_stages": pl["b_stages"],
                    "smem_bytes": pl["smem_bytes"], "ctas": pl["ctas"],
                    "ctas_per_sm": seen["ctas_per_sm"],
                    "padded_share": pl["padded_share"], "kernel": kname,
                    "registers": regs.get(kname), "ms": ms,
                    "tflop_s": block_tflops[-1],
                    "bound_ms": max(b_bytes, b_ops)})
                log(f"      block {i}: plan tile {pl['tile'][0]}x"
                    f"{pl['tile'][1]}, {pl['warpgroups']} consumer "
                    f"warpgroup(s), {pl['b_stages']} weight slots, "
                    f"{pl['smem_bytes']} B shared memory, {pl['ctas']} CTAs "
                    f"({seen['ctas_per_sm']} per SM by the occupancy query), "
                    f"padded share {pl['padded_share']:.3f}; {kname} "
                    f"{regs.get(kname, '?')} registers; {ms:.3f} ms, "
                    f"{block_tflops[-1]:.0f} TFLOP/s, "
                    f"{100 * max(b_bytes, b_ops) / ms:.1f}% of its bound "
                    f"{max(b_bytes, b_ops):.3f} ms")
                if seen != {"smem_bytes": pl["smem_bytes"],
                            "ctas_per_sm": pl["ctas_per_sm"]}:
                    problems.append(f"{name} block {i}: the kernel sees "
                                    f"{seen} for plan {pl}")
            del ins
            r = {"ms": time_ms(kernel_only, reps=5),
                 "wrapper_ms": time_ms(
                     lambda: sf.fused_stage(x, blocks[name], stride),
                     reps=5),
                 "chain_fuse_all_ms": time_ms(lambda: chain(encs["all"]),
                                              reps=5),
                 "chain_cudnn_ms": time_ms(lambda: chain(encs[False]),
                                           reps=5),
                 "bytes_ms": t_bytes, "ops_ms": t_ops,
                 "handoff_ms": t_hand, "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "launches": len(ids), "block_ms": block_ms,
                 "block_tflop_s": block_tflops, "plans": plans}
            with fp32_exact():
                r["plain_ms"] = time_ms(lambda: sf.stage_reference(
                    x, blocks[name], stride), reps=2, warmup=1)
            rows_out[name] = r
            log(f"    {name} times: kernel {r['ms']:.3f} ms ({len(ids)} "
                f"launches), wrapper {r['wrapper_ms']:.3f}, plain "
                f"{r['plain_ms']:.3f}, model chain fuse='all' "
                f"{r['chain_fuse_all_ms']:.3f}, fuse=False "
                f"{r['chain_cudnn_ms']:.3f}; bound {r['bound_ms']:.3f} "
                f"({r['bound_by']}; bytes {t_bytes:.3f}, operations "
                f"{t_ops:.3f}, block handoffs +{t_hand:.3f}); per block "
                + ", ".join(f"{ms:.3f} ms ({tf:.0f} TFLOP/s)"
                            for ms, tf in zip(block_ms, block_tflops)))
        del outs, caps, xs
        torch.cuda.empty_cache()

        # small and ragged shapes: avtex's test shapes at stride 1 and 2,
        # odd H and W, an odd BT, the path's channel counts at small BT
        for j, (bt, h, w, cin, f, cout, nb, stride) in enumerate([
                (6, 16, 16, 24, 16, 64, 2, 1), (6, 16, 16, 24, 16, 64, 2, 2),
                (3, 15, 13, 24, 16, 64, 2, 1), (7, 56, 56, 80, 64, 256, 3, 1),
                (5, 56, 56, 320, 128, 512, 4, 2)]):
            g = torch.Generator(device="cuda").manual_seed(800 + j)
            x = torch.randn(bt, h, w, cin, generator=g, device="cuda").to(
                torch.bfloat16)
            checks.append(check_stage(
                x, random_stage(cin, f, cout, nb, 810 + j), stride,
                f"random BT={bt} {h}x{w} {cin}->{f}->{cout} stride {stride}"))
    problems += [f"{c['label']} disagrees with the plain version"
                 for c in checks if not c["ok"]]
    log(f"    phase 8: {time.perf_counter() - t_phase:.1f} s; "
        + nvidia_smi_line())
    if problems:
        raise AssertionError("fused_stage: " + "; ".join(problems))

    def total(key):
        return sum(r[key] for r in rows_out.values())

    plans = [pl for r in rows_out.values() for pl in r.pop("plans")]

    return {"name": "fused_stage", "route": "cuda",
            "source": "avtex_torch/csrc/fused_stage.cu",
            "replaces": "avtex/ops/stage_fused.py:293", "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": ("bytes" if total("bytes_ms") >= total("ops_ms")
                         else "operations"),
            "library_ms": None, "wrapper_ms": total("wrapper_ms"),
            "chain_fuse_all_ms": total("chain_fuse_all_ms"),
            "chain_cudnn_ms": total("chain_cudnn_ms"),
            "max_stage_fro": max(c["fro"] for c in checks),
            "registers": regs or None, "plan": plans,
            "per": f"slow res2 + res3 at BT={n_clips * 8} "
                   f"({STAGE_LAUNCHES} launches)",
            "stages": rows_out}


def stem_phase(enc, video: np.ndarray, W: int, S: int, batch: int,
               res: int) -> None:
    """Phase 4b: both stems of ``enc`` on the main path's first batch,
    s2d forms against the plain stem, timed with cudnn.benchmark off and
    on. Scale and bias are seeded and non-uniform, so a channel in the
    wrong phase shows."""
    import torch
    from avtex_torch.data.preprocess import preprocess_clip
    from avtex_torch.nn.slowfast import slowfast_pathways
    from avtex_torch.ops import s2d_stem as st

    t_phase = time.perf_counter()
    video_dev = torch.from_numpy(video).cuda()
    idx = (torch.arange(batch, device="cuda")[:, None] * S
           + torch.arange(W, device="cuda")[None])
    g = torch.Generator().manual_seed(7)
    sd = enc.state_dict()
    with torch.inference_mode():
        slow, fast = (p.to(torch.bfloat16) for p in slowfast_pathways(
            preprocess_clip(video_dev[idx], res, True)))
        del video_dev
        for name, x, w in (("slow", slow, sd["Conv_0.weight"]),
                           ("fast", fast, sd["fast_stem_kernel"])):
            o = w.shape[0]
            sc = (1 + 0.25 * torch.randn(o, generator=g)).cuda()
            bi = (0.25 * torch.randn(o, generator=g)).cuda()
            conv = st.stem_conv_plain(x, w)
            tol = STEM_TOL_REL * float((conv.float() * sc).abs().amax())
            del conv
            plain = st.stem_pooled_plain(x, w, sc, bi)
            forms = {"plain": lambda x=x, w=w, sc=sc, bi=bi:
                     st.stem_pooled_plain(x, w, sc, bi)}
            for f in (4, 8):
                if st.stem_factor(o, res, res, f) != f:
                    log(f"[4b] {name} stem (O={o}): f={f} falls back to 4, "
                        f"as avtex's")
                    continue
                outs = {pool: st.fast_stem_s2d_pooled(x, w, sc, bi, f=f,
                                                      pool=pool)
                        for pool in st.POOLS}
                same = torch.equal(outs["shuffle"], outs["phase"])
                err = float((outs["shuffle"].float() - plain.float()
                             ).abs().max())
                log(f"[4b] {name} stem x {tuple(x.shape)} -> "
                    f"{tuple(plain.shape)}: s2d f={f} vs plain max err "
                    f"{err:.4g} (tol {tol:.4g}); pools bit-identical: "
                    f"{same}")
                if not same or err > tol or plain.shape != outs[
                        "shuffle"].shape:
                    raise AssertionError(f"{name} stem s2d f={f} disagrees")
                for pool in st.POOLS:
                    forms[f"s2d f={f} {pool}"] = (
                        lambda x=x, w=w, sc=sc, bi=bi, f=f, pool=pool:
                        st.fast_stem_s2d_pooled(x, w, sc, bi, f=f,
                                                pool=pool))
                del outs
            del plain
            for bench in (False, True):
                torch.backends.cudnn.benchmark = bench
                try:
                    for label, fn in forms.items():
                        ms = time_ms(fn, reps=5)
                        top = sorted(kernel_device_ms(fn).items(),
                                     key=lambda kv: -kv[1])[:2]
                        log(f"    {name} {label:18s} cudnn.benchmark="
                            f"{int(bench)}: {ms:8.3f} ms; top kernels "
                            + "; ".join(f"{v:.2f} ms {k[:70]}"
                                        for k, v in top))
                finally:
                    torch.backends.cudnn.benchmark = False
    log(f"    phase 4b: {time.perf_counter() - t_phase:.1f} s")


def slomo_phase(server, request: dict, crossfaded: dict, fps: int) -> None:
    """Phase 5b: the ``request`` again with SuperSloMo at its jumps, from
    a checkpoint written from seeded weights that the server finds."""
    import os
    import tempfile
    import torch
    from avtex_torch.checkpoints import (maybe_make_slomo_interp_fn,
                                         save_slomo_checkpoint)
    from avtex_torch.synth.interp import init_slomo
    from avtex_torch.synth.stitcher import walk_frame_ids

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = save_slomo_checkpoint(
            init_slomo(seed=0, dtype=torch.float32, device="cpu"),
            os.path.join(tmp, "SuperSloMo.ckpt"))
        os.environ["AVTEX_SLOMO_CKPT"] = path
        try:
            out = server.synthesize(**request)
        finally:
            del os.environ["AVTEX_SLOMO_CKPT"]
        fp32 = maybe_make_slomo_interp_fn(path, device="cuda",
                                          dtype=torch.float32)
    bf16 = server._interp_fn
    t = out["timings"]
    frames, intp = out["frames"], out["frames_intp"]
    ref = crossfaded["frames_intp"]
    same_idx = np.array_equal(out["result"].indices,
                              crossfaded["result"].indices)
    log(f"[5b] SuperSloMo request {request}: interp_load_s "
        f"{t.get('interp_load_s', float('nan')):.3f} s, stitch "
        f"{t['stitch_s']:.3f} s (crossfade {crossfaded['timings']['stitch_s']:.3f}"
        f" s), {out['jump_count']} jumps, {len(intp)} interpolated frames "
        f"(crossfade {len(ref)}), same indices {same_idx}")
    if (bf16 is None or "interp_load_s" not in t or not same_idx
            or intp.dtype != np.uint8 or len(intp) != len(ref)
            or frames.shape != crossfaded["frames"].shape):
        raise AssertionError("the SuperSloMo request went wrong")
    if np.array_equal(intp, ref):
        raise AssertionError("SuperSloMo frames equal the crossfade's")

    # the jumps' frame pairs, as the stitcher passes them
    ids, jump_at = walk_frame_ids(out["result"].indices, server.W, server.S)
    video = server.video_full
    pairs = [(video[ids[k - 1]], video[ids[k]]) for k in jump_at if k > 0]
    n_mid = server.cfg.SF - 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a, b in pairs:
        bf16(a, b, n_mid)
    jump_ms = (time.perf_counter() - t0) * 1e3 / max(len(pairs), 1)
    jump_dev_ms = sum(kernel_device_ms(
        lambda: bf16(*pairs[0], n_mid)).values())
    diffs = [np.abs(bf16(a, b, n_mid).astype(np.int32)
                    - fp32(a, b, n_mid).astype(np.int32))
             for a, b in pairs[:8]]
    mean_d = float(np.mean([d.mean() for d in diffs]))
    max_d = int(max(d.max() for d in diffs))
    log(f"    {len(pairs)} jumps: {jump_ms:.2f} ms per jump ({n_mid} mid "
        f"frames at {video.shape[1]}x{video.shape[2]}, host to host; "
        f"{jump_dev_ms:.2f} ms of it device time, copies included); "
        f"bf16 vs fp32 net on {len(diffs)} jumps: mean |diff| "
        f"{mean_d:.3f}, max {max_d} levels (tol {SLOMO_MEAN_TOL:g}, "
        f"{SLOMO_MAX_TOL}); phase 5b {time.perf_counter() - t_phase:.1f} s")
    if mean_d > SLOMO_MEAN_TOL or max_d > SLOMO_MAX_TOL:
        raise AssertionError("SuperSloMo bf16 disagrees with fp32")


def checkpoint_phase(server, cfg, embed) -> None:
    """Phase 5c: the main path's parameters through avtex's checkpoint
    file and back into a new model, whose tables must be bit-identical."""
    import os
    import tempfile
    import torch
    from avtex_torch.contrastive.model import ContrastiveTextures
    from avtex_torch.convert import convert_params, export_params
    from avtex_torch.synth.embeddings import precompute_embeddings_from_video
    from avtex_torch.train import restore_checkpoint, save_checkpoint

    ref_q, ref_t = embed()
    with tempfile.TemporaryDirectory() as tmp:
        path = save_checkpoint(tmp, "smoke", export_params(
            server.model.state_dict()), epoch=0, arch="slowfast",
            best_loss=0.0, is_best=True)
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        payload = restore_checkpoint(path)
        restore_s = time.perf_counter() - t0
    model = ContrastiveTextures(arch="slowfast", temp=cfg.temp,
                                norm=cfg.norm)
    model.load_state_dict(convert_params(payload["state"], model))
    model = model.cuda().eval()
    q, t = precompute_embeddings_from_video(
        model, server.video, server.W, server.S, server.L,
        img_size=cfg.img_size, batch_size=cfg.mini_batchsize)
    same = torch.equal(q, ref_q) and torch.equal(t, ref_t)
    log(f"[5c] checkpoint round trip: {size / 2**20:.1f} MiB, restore "
        f"{restore_s:.3f} s; tables bit-identical: {same}")
    if not same:
        raise AssertionError("restored model's tables differ")


def tone_track(seconds: float, sr: int, fps: int, start_frame: int,
               seed: int) -> np.ndarray:
    """A tone whose pitch follows ``synthetic_video``'s brightness phase
    sin(frame / 9), from ``start_frame`` on, plus seeded noise."""
    g = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f = 300 + 250 * np.sin((start_frame + t * fps) / 9.0)
    x = 0.4 * np.sin(2 * np.pi * np.cumsum(f) / sr) \
        + 0.03 * g.standard_normal(len(t))
    return x.astype(np.float32)


def vggish_flops(frames: int = 100, bands: int = 64) -> int:
    """Operations of one VGGish example: 2 x 9 x C_in x C_out per output
    pixel of each 3x3 conv (the pools and ReLUs are not counted)."""
    from avtex_torch.nn.vggish import WIDTHS
    flops, cin, h, w = 0, 1, frames, bands
    for widths in WIDTHS:
        for c in widths:
            flops += 2 * 9 * cin * c * h * w
            cin = c
        h, w = h // 2, w // 2
    return flops


def audio_phase(cfg, video: np.ndarray, fps: int, n_batches: int,
                m1_embed_s: float):
    """Phase 5d: audio-conditioned synthesis at full width. Returns the
    fused_conv1x1 launches of the model_type=2 server's first embed, and
    for phase 10 the -daf Mel rows of the 30 s request and both waves."""
    import dataclasses
    import os
    import tempfile
    import torch
    from avtex_torch.audio import (log_mel_spectrogram, params as aparams,
                                   resample_to_16k, waveform_to_examples)
    from avtex_torch.checkpoints import vggish_reference_state
    from avtex_torch.contrastive.model import ContrastiveTextures
    from avtex_torch.media import read_wav, write_wav
    from avtex_torch.nn.vggish import VGGish
    from avtex_torch.ops import launch_counts, reset_launch_counts
    from avtex_torch.synth import TextureServer
    from avtex_torch.synth.embeddings import (
        precompute_embeddings_from_video, vggish_audio_features)
    from avtex_torch.synth.engine import (driving_audio_logits,
                                          num_synthesis_steps)
    from avtex_torch.synth.pipeline import flax_style_init

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    seconds = len(video) / fps
    src_path = write_wav(os.path.join(tmp.name, "source.wav"),
                         tone_track(seconds, 22050, fps, 0, 0), 22050)
    # the driving clip follows the video's phase from frame 600 on
    drv_path = write_wav(os.path.join(tmp.name, "driving.wav"),
                         tone_track(30.0, 44100, fps, 600, 1), 44100)
    src_wave, src_sr = read_wav(src_path)
    drv_wave, drv_sr = read_wav(drv_path)

    # ---- the log-mel frontend on the card and on the CPU --------------- #
    host_ms = []  # the first call includes loading cuFFT and its plan
    for _ in range(2):
        t0 = time.perf_counter()
        ex_gpu = waveform_to_examples(src_wave, src_sr, device="cuda")
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    ex_cpu = waveform_to_examples(src_wave, src_sr, device="cpu")
    mel_err = float((ex_gpu.cpu() - ex_cpu).abs().max())
    wave16 = torch.from_numpy(resample_to_16k(src_wave, src_sr)).cuda()
    dev_ms_mel = time_ms(lambda: log_mel_spectrogram(wave16), reps=20)
    log(f"[5d] audio: {nvidia_smi_line()}; source {seconds:.0f} s at {src_sr} Hz "
        f"-> {tuple(ex_gpu.shape)} log-mel examples; card vs CPU max "
        f"|diff| {mel_err:.3g} (tol {MEL_TOL:g}); waveform_to_examples "
        f"{host_ms[1]:.2f} ms host to host (resample on the host; the "
        f"process's first call {host_ms[0]:.2f} ms), the "
        f"spectrogram {dev_ms_mel:.3f} ms on the device "
        f"({len(wave16) / aparams.SAMPLE_RATE:.0f} s of 16 kHz audio); "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    if tuple(ex_gpu.shape) != tuple(ex_cpu.shape) or mel_err > MEL_TOL \
            or ex_gpu.shape[1:] != (100, 64):
        raise AssertionError("log-mel on the card disagrees with the CPU")

    # ---- VGGish bf16 against fp32 -------------------------------------- #
    state = flax_style_init(VGGish(torch.float32), 0)
    nets = {}
    for dt in (torch.bfloat16, torch.float32):
        nets[dt] = VGGish(dt)
        nets[dt].load_state_dict(state)
        nets[dt] = nets[dt].cuda().eval()
    feats_bf16 = vggish_audio_features(nets[torch.bfloat16], ex_gpu)
    with fp32_exact():
        feats_fp32 = vggish_audio_features(nets[torch.float32], ex_gpu)
    cos = torch.nn.functional.cosine_similarity(feats_bf16, feats_fp32,
                                                dim=-1)
    batch = ex_gpu[:VGGISH_BATCH].contiguous()
    with torch.inference_mode():
        ms_bf16 = time_ms(lambda: nets[torch.bfloat16](batch), reps=20)
        with fp32_exact():
            ms_fp32 = time_ms(lambda: nets[torch.float32](batch), reps=5)
    flops = vggish_flops() * VGGISH_BATCH
    bound = flops / PEAK_BF16_FLOP_S * 1e3
    log(f"    VGGish full width on {len(ex_gpu)} examples: bf16 vs fp32 "
        f"cosine min {float(cos.min()):.6f} (tol {AUDIO_COS}); a batch of "
        f"{VGGISH_BATCH}: bf16 {ms_bf16:.3f} ms, "
        f"{flops / ms_bf16 / 1e9:.1f} TFLOP/s, {100 * bound / ms_bf16:.1f}% "
        f"of its {bound:.3f} ms bound ({vggish_flops() / 1e9:.3f} GFLOP an "
        f"example at {PEAK_BF16_FLOP_S / 1e12:.0f} TFLOP/s); fp32 "
        f"(no TF32) {ms_fp32:.3f} ms")
    if feats_bf16.shape != (len(ex_gpu), 12288) \
            or not torch.isfinite(feats_bf16).all() \
            or float(cos.min()) < AUDIO_COS:
        raise AssertionError("VGGish bf16 disagrees with fp32")
    del nets, feats_bf16, feats_fp32

    # ---- the model_type=2 server --------------------------------------- #
    cfg2 = dataclasses.replace(cfg, model_type=2)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    server = TextureServer.from_frames(cfg2, video, float(fps),
                                       audio_path=src_path, device="cuda")
    load_s = time.perf_counter() - t0
    launches = launch_counts()["fused_conv1x1"]
    L, W, S = server.L, server.W, server.S
    log(f"    TextureServer.from_frames(model_type=2): {load_s:.2f} s, "
        f"L={L}, {len(server.audio_examples)} source examples, kernel "
        f"launches {launches}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches != LAUNCHES_PER_BATCH * n_batches:
        raise AssertionError(f"kernel launched {launches} times, expected "
                             f"{LAUNCHES_PER_BATCH * n_batches}")
    for name, tab in (("query", server.q_table), ("target", server.t_table)):
        norms = torch.linalg.vector_norm(tab, dim=-1)
        if (tuple(tab.shape) != (L, 2304 + 12288)
                or not torch.isfinite(tab).all()
                or float((norms - 1).abs().max()) > 1e-3):
            raise AssertionError(f"model_type=2 {name} table is wrong: "
                                 f"{tuple(tab.shape)}")

    def embed():
        out = precompute_embeddings_from_video(
            server.model, server.video, W, S, L, server.audio_examples,
            img_size=cfg.img_size, batch_size=cfg.mini_batchsize)
        torch.cuda.synchronize()
        return out

    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        embed()
        times.append(time.perf_counter() - t0)
    log(f"    warm embed (both towers, VGGish included): {min(times):.3f} s "
        f"(runs {', '.join(f'{t:.3f}' for t in times)}) against "
        f"model_type=1's {m1_embed_s:.3f} s (phase 5, this run)")
    profile_embed(embed, min(times), label="model_type=2", detail=False)

    plain = ContrastiveTextures(arch="slowfast", model_type=2, temp=cfg.temp,
                                norm=cfg.norm, fuse=False)
    plain.load_state_dict(server.model.state_dict())
    plain = plain.cuda().eval()
    pq, pt = precompute_embeddings_from_video(
        plain, server.video, W, S, L, server.audio_examples,
        img_size=cfg.img_size, batch_size=cfg.mini_batchsize)
    cos_q = torch.nn.functional.cosine_similarity(server.q_table, pq, dim=-1)
    cos_t = torch.nn.functional.cosine_similarity(server.t_table, pt, dim=-1)
    low = min(float(cos_q.min()), float(cos_t.min()))
    log(f"    tables fuse='all' vs fuse=False: cosine min {low:.6f}")
    if low < AUDIO_COS:
        raise AssertionError("model_type=2 tables with the kernel disagree "
                             "with cuDNN")
    del plain, pq, pt

    # ---- driving-audio requests ---------------------------------------- #
    drv_eg = waveform_to_examples(drv_wave, drv_sr, device="cuda")
    max_length = min(30 * fps, int(len(drv_eg) / 10 * fps))
    steps = num_synthesis_steps(max_length, W, S)
    src_np = server.audio_examples.reshape(len(server.audio_examples), -1)
    src_np = src_np[:L].double().cpu().numpy()
    d0 = drv_eg[0].reshape(-1).double().cpu().numpy()
    sims = (src_np @ d0) / (np.linalg.norm(src_np, axis=1)
                            * np.linalg.norm(d0))
    request = dict(seconds=30, alpha=0.5, seed=1, driving_audio=drv_path)
    for daf in ("VGG", "Mel"):
        server.cfg = dataclasses.replace(server.cfg, da_feats=daf)
        outs = []
        for _ in range(2):
            t0 = time.perf_counter()
            out = server.synthesize(**request)
            outs.append((out, time.perf_counter() - t0))
        (a, a_s), (b, b_s) = outs
        rows, sid = server._scorer()(drv_eg, steps)
        r = a["result"]
        tm = a["timings"]
        log(f"    -daf {daf} request {dict(request, driving_audio='30 s')}:"
            f" {len(r.indices)} steps, seed {r.seed_id} (cosine "
            f"{sims[r.seed_id]:.6f}, best {sims.max():.6f}), "
            f"{int(r.jumps[1:].sum())} jumps, {len(a['frames'])} frames; "
            f"scorer built in {tm.get('scorer_s', float('nan')):.3f} s, "
            f"audio_rows_s {tm['audio_rows_s']:.4f} s (the repeat: "
            f"{b['timings']['audio_rows_s']:.4f} s), walk_s "
            f"{tm['walk_s']:.4f} s, stitch {tm['stitch_s']:.4f} s, host to "
            f"host {a_s:.3f} s (the repeat {b_s:.3f} s)")
        if (tuple(rows.shape) != (steps, L) or not torch.isfinite(rows).all()
                or len(r.indices) != steps or sid != r.seed_id
                or sims[r.seed_id] < sims.max() - 1e-5):
            raise AssertionError(f"-daf {daf}: bad rows or seed")
        if len(a["frames"]) != W + (steps - 1) * S:
            raise AssertionError(f"-daf {daf}: {len(a['frames'])} frames "
                                 f"for {steps} steps")
        if a["sample_rate"] != drv_sr or not np.array_equal(a["audio"],
                                                            drv_wave):
            raise AssertionError(f"-daf {daf}: output audio is not the "
                                 "driving waveform")
        if "scorer_s" not in tm or "scorer_s" in b["timings"] \
                or len(server._scorers) != (1 if daf == "VGG" else 2):
            raise AssertionError(f"-daf {daf}: the scorer was not built "
                                 "once and reused")
        if not np.array_equal(r.indices, b["result"].indices):
            raise AssertionError(f"-daf {daf}: a repeated request gave "
                                 "other indices")
    extras = {"mel_rows": rows, "source": (src_wave, src_sr),
              "driving": (drv_wave, drv_sr),
              "m2": {"model": server.model, "examples": server.audio_examples,
                     "tables": (server.q_table, server.t_table)}}
    del server
    torch.cuda.empty_cache()

    # ---- the VGGish checkpoint graft ----------------------------------- #
    vg = VGGish(torch.float32)
    vg.load_state_dict(flax_style_init(vg, 7))
    ref = vggish_reference_state(vg)
    g = torch.Generator().manual_seed(8)
    for i, (o, k) in enumerate(((4096, 12288), (4096, 4096), (128, 4096))):
        ref[f"embeddings.{2 * i}.weight"] = torch.randn(o, k, generator=g)
        ref[f"embeddings.{2 * i}.bias"] = torch.randn(o, generator=g)
    ckpt = os.path.join(tmp.name, "pytorch_vggish.pth")
    torch.save(ref, ckpt)
    size = os.path.getsize(ckpt)
    os.environ["AVTEX_VGGISH_CKPT"] = ckpt
    try:
        short = video[:10 * fps]  # the graft needs no full-length table
        t0 = time.perf_counter()
        server = TextureServer.from_frames(
            dataclasses.replace(cfg2, da_feats="VGG"), short, float(fps),
            audio_path=src_path, device="cuda")
        out = server.synthesize(**request)
        graft_s = time.perf_counter() - t0
    finally:
        del os.environ["AVTEX_VGGISH_CKPT"]
    direct = VGGish()
    direct.load_state_dict(vg.state_dict())
    direct = direct.cuda().eval()
    ex = server.audio_examples
    with torch.inference_mode():
        same_w = all(torch.equal(v, direct.state_dict()[k]) for k, v in
                     server.model.audio_encoder.state_dict().items())
        f_model = server.model.audio_encoder(ex)
        f_direct = direct(ex)
    steps2 = len(out["result"].indices)
    rows, _ = server._scorer()(drv_eg, steps2)
    seg = torch.from_numpy(np.minimum(np.arange(server.L), len(ex) - 1))
    ids = torch.from_numpy(np.minimum(np.arange(steps2), len(drv_eg) - 1))
    want = driving_audio_logits(
        vggish_audio_features(direct, ex)[seg.cuda()],
        vggish_audio_features(direct, drv_eg)[ids.cuda()], cfg.temp)
    log(f"    pytorch_vggish.pth ({size / 2**20:.1f} MiB, fc head "
        f"included): the server's VGGish weights equal the file's "
        f"{same_w}; features max |diff| against a VGGish loaded directly "
        f"{float((f_model - f_direct).abs().max()):.3g}, -daf VGG rows "
        f"{float((rows - want).abs().max()):.3g}; server + request "
        f"{graft_s:.2f} s; phase 5d {time.perf_counter() - t_phase:.1f} s")
    if not (same_w and torch.equal(f_model, f_direct)
            and torch.equal(rows, want)):
        raise AssertionError("the grafted VGGish differs from the file's")
    del server, direct
    tmp.cleanup()
    return launches, extras


def profile_embed(embed, wall_s: float, label: str = "",
                  detail: bool = True) -> None:
    """Device time of one warm embed by kernel and by op (torch.profiler);
    the busy share is kernel time over the unprofiled wall time, the stem
    share the device time inside the encoder's stems range over all
    kernel time. ``detail=False`` prints the totals only."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from avtex_torch.nn.slowfast import STEMS_RANGE
    from avtex_torch.nn.vggish import VGGISH_RANGE
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        embed()

    cuda = torch.autograd.DeviceType.CUDA
    ranges = (STEMS_RANGE, VGGISH_RANGE)
    # (a named range may also show as a device-side annotation: not a
    # kernel)
    kernels = [(dev_ms(e), e.count, e.key) for e in prof.key_averages()
               if getattr(e, "device_type", None) == cuda and dev_ms(e) > 0
               and e.key not in ranges]
    total = sum(k[0] for k in kernels)
    if not total:
        log("    profiler: no device time recorded")
        return
    fused = sum(k[0] for k in kernels if "fused_conv1x1" in k[2])
    # a host-side range's device time: its kernels' time
    in_range = {r: sum(getattr(e, "device_time_total",
                               getattr(e, "cuda_time_total", 0)) / 1e3
                       for e in prof.key_averages() if e.key == r
                       and getattr(e, "device_type", None) != cuda)
                for r in ranges}
    stems, vggish = in_range[STEMS_RANGE], in_range[VGGISH_RANGE]
    log(f"    profiled warm embed ({label}): kernels {total:.1f} ms on the "
        f"device = {100 * total / (wall_s * 1e3):.1f}% of the unprofiled "
        f"wall {wall_s * 1e3:.1f} ms; fused_conv1x1 {fused:.1f} ms "
        f"({100 * fused / total:.1f}%); stems {stems:.1f} ms "
        f"({100 * stems / total:.1f}%)"
        + (f"; VGGish {vggish:.1f} ms ({100 * vggish / total:.1f}%)"
           if vggish else ""))
    if not detail:
        return
    for ms, count, key in sorted(kernels, reverse=True)[:8]:
        log(f"      kernel {ms:9.2f} ms {100 * ms / total:5.1f}% "
            f"x{count:<4} {key[:80]}")
    ops = [(dev_ms(e), e.count, e.key, e.input_shapes)
           for e in prof.key_averages(group_by_input_shape=True)
           if getattr(e, "device_type", None) != cuda and dev_ms(e) > 0]
    for ms, count, key, shapes in sorted(ops, reverse=True)[:12]:
        log(f"      op {ms:9.2f} ms {100 * ms / total:5.1f}% x{count:<4} "
            f"{key} {str(shapes[:2])[:90]}")



# ---- phase 10 ------------------------------------------------------------ #

def survivors_ok(logits: np.ndarray, rows, result, threshold: float,
                 alpha: float = 0.5) -> bool:
    """Every chosen id of a contrastive walk is a candidate of its step
    and survives ``p >= max - threshold * max`` (recomputed in float64;
    1e-6 of |max| slack for the fp32 rounding)."""
    L = len(logits)
    prev = result.seed_id
    for s, nxt in enumerate(result.indices):
        cand = np.ones(L, bool)
        cand[prev] = prev == L - 1
        p = np.where(cand, logits[prev], 0.0)
        p = p / p.sum()
        if rows is not None:
            a = np.where(cand, rows[s], 0.0)
            p = alpha * p + (1 - alpha) * a / a.sum()
        mx = p[cand].max()
        if not (cand[nxt] and p[nxt] >= mx - threshold * mx
                - 1e-6 * abs(mx)):
            return False
        prev = int(nxt)
    return True


def walk_phase(label: str, q, t, steps: int, rows, threshold: float,
               seed_id: int, temp: float = 0.1) -> dict:
    """Phase 10 (a): the contrastive device walk on tables ``q``, ``t``
    against the host walk, its gates, and the step loop captured in a CUDA
    graph (a measurement: the walk runs eagerly)."""
    import torch
    from avtex_torch.synth.engine import (candidate_rows, candidate_scores,
                                          synthesize_indices,
                                          synthesize_indices_host,
                                          walk_logits, walk_steps)
    L = q.shape[0]
    kw = dict(threshold=threshold, alpha=0.5, seed_id=seed_id)

    def best(fn, reps=3):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times)

    dev_ms_ = best(lambda: synthesize_indices(q, t, steps, temp,
                                              audio_logits=rows, seed=1,
                                              **kw))
    rows_host = None if rows is None else rows.cpu()
    host_ms = best(lambda: synthesize_indices_host(
        q, t, steps, temp, audio_logits=rows_host,
        rng=np.random.default_rng(1), **kw))
    with fp32_exact():
        logits = torch.matmul(q.float(), t.float().t()) / temp
    gen = torch.Generator(device="cuda").manual_seed(1)
    noise = torch.rand((steps, L), generator=gen, device="cuda")
    card = walk_logits(logits, steps, audio_logits=rows, seed=1, **kw)
    given = walk_logits(logits, steps, audio_logits=rows, noise=noise, **kw)
    again = walk_logits(logits, steps, audio_logits=rows, seed=1, **kw)
    cpu = walk_logits(logits.cpu(), steps, audio_logits=rows_host,
                      noise=noise.cpu(), **kw)
    ok_surv = survivors_ok(logits.double().cpu().numpy(),
                           None if rows is None else
                           rows.double().cpu().numpy(), card, threshold)
    same_cpu = (np.array_equal(card.indices, cpu.indices)
                and np.array_equal(card.nonzero_counts, cpu.nonzero_counts)
                and np.array_equal(card.greedy_ids, cpu.greedy_ids))
    stat_err = max(
        float(np.max(np.abs(card.entropies - cpu.entropies)
                     / np.maximum(np.abs(cpu.entropies), 1e-30))),
        float(np.max(np.abs(card.pos_prob - cpu.pos_prob)
                     / np.maximum(np.abs(cpu.pos_prob), 1e-30))))
    ok = (ok_surv and same_cpu and stat_err <= WALK_RTOL
          and np.array_equal(card.indices, again.indices)
          and np.array_equal(card.indices, given.indices)
          and len(card.indices) == steps)

    # the step loop in one CUDA graph: capture once, replay
    graph = {}
    try:
        cand = candidate_rows(L, logits.device)
        video_p = candidate_scores(logits, cand,
                                   None if rows is None else 0.5)
        q0 = torch.tensor(seed_id, dtype=torch.int64, device="cuda")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            walk_steps(video_p, cand, noise, q0, threshold, rows, 0.5)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(g):
            out = walk_steps(video_p, cand, noise, q0, threshold, rows, 0.5)
        torch.cuda.synchronize()
        graph["capture_ms"] = (time.perf_counter() - t0) * 1e3
        graph["replay_ms"] = best(lambda: (g.replay(),
                                           torch.cuda.synchronize()))
        graph["same"] = bool(np.array_equal(out.cpu().numpy(),
                                            given.indices))
        del g
    except Exception as e:  # a measurement, not a path of the port
        graph["error"] = f"{type(e).__name__}: {e}"
    log(f"    (a) {label}: L={L}, {steps} steps, threshold {threshold}, "
        f"seed segment {seed_id}"
        + (", -daf Mel rows" if rows is not None else "")
        + f": device walk {dev_ms_:.2f} ms against the host walk "
        f"{host_ms:.2f} ms (both from the tables, host to host, best of "
        f"3); {int(card.jumps[1:].sum())} jumps; every choice a survivor "
        f"{ok_surv}; a repeat identical "
        f"{np.array_equal(card.indices, again.indices)}; the CPU on the "
        f"card's logits and noise: same choices {same_cpu}, statistics "
        f"within {stat_err:.3g} (tol {WALK_RTOL:g}); the loop in a CUDA "
        f"graph: "
        + (f"capture {graph['capture_ms']:.2f} ms, replay "
           f"{graph['replay_ms']:.2f} ms, same choices {graph['same']}"
           if "error" not in graph else graph["error"]))
    if not ok:
        raise AssertionError(f"device walk {label} failed its gates")
    return {"L": L, "steps": steps, "device_ms": dev_ms_,
            "host_ms": host_ms, **graph}


def encoder_phase(video: np.ndarray, fps: int) -> dict:
    """Phase 10 (d): the seven new encoders at full width."""
    import torch
    from avtex_torch.config import Config
    from avtex_torch.contrastive.model import (ContrastiveTextures,
                                               SegmentEmbedder)
    from avtex_torch.data.pipeline import SegmentBatches
    from avtex_torch.data.preprocess import preprocess_clip
    from avtex_torch.synth import TextureServer
    from avtex_torch.synth.pipeline import flax_style_init
    from avtex_torch.train import create_state, make_train_step
    from avtex_torch.train.loop import step_generator

    out = {}
    W, S = 15, 6
    L = (len(video) - W) // S
    idx = (np.arange(8)[:, None] * (L // 8) * S + np.arange(W)[None])
    video_dev = torch.from_numpy(video).cuda()
    log(f"    (d) the seven new encoders, bf16, norm='group', seeded "
        f"flax-style weights, one synchronised forward of 8 clips of "
        f"{W} frames (224^2; the 2D archs 112^2) after a warm-up; card vs "
        f"CPU in fp32 (TF32 off) on one clip of {W} x 112^2, cosine >= "
        f"{ENC_COS}")
    for arch in NEW_ENCODERS:
        size = 112 if arch.endswith("_2d") else 224
        emb = SegmentEmbedder(arch, dtype=torch.float32)
        state = flax_style_init(emb, 0)
        bf = SegmentEmbedder(arch, dtype=torch.bfloat16)
        bf.load_state_dict(state)
        bf = bf.cuda().eval()
        clips = preprocess_clip(video_dev[torch.from_numpy(idx).cuda()],
                                size)
        with torch.inference_mode():
            bf(clips)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            y = bf(clips)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        norms = torch.linalg.vector_norm(y.float(), dim=-1)
        del bf, clips
        emb.load_state_dict(state)
        small = preprocess_clip(torch.from_numpy(video[:W][None]), 112)
        with torch.inference_mode():
            want = emb.eval()(small)
            gpu = emb.cuda()
            with fp32_exact():
                got = gpu(small.cuda()).cpu()
        cos = float(torch.nn.functional.cosine_similarity(got, want,
                                                          dim=-1).min())
        del emb, gpu
        torch.cuda.empty_cache()
        log(f"      {arch}: feat_dim {y.shape[1]}, {ms:.1f} ms a forward "
            f"of 8 clips, peak {peak:.2f} GiB; |emb| - 1 max "
            f"{float((norms - 1).abs().max()):.2g}; card vs CPU cosine "
            f"{cos:.7f}")
        if (y.shape[0] != 8 or not torch.isfinite(y).all()
                or float((norms - 1).abs().max()) > 1e-3 or cos < ENC_COS):
            raise AssertionError(f"encoder {arch} failed its gates")
        out[arch] = {"ms": ms, "peak_gib": peak, "cos_cpu": cos}
    del video_dev

    # a server and a request with -ea resnext50
    cfg = Config(enc_arch="resnext50", mini_batchsize=64, seed=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = TextureServer.from_frames(cfg, video, float(fps),
                                       device="cuda")
    load_s = time.perf_counter() - t0
    reqs = {}
    for dev_walk in (False, True):
        o = server.synthesize(seconds=30, seed=1, walk_on_device=dev_walk)
        reqs[dev_walk] = o
    norms = torch.linalg.vector_norm(server.q_table, dim=-1)
    log(f"      TextureServer -ea resnext50: load {load_s:.2f} s (init + "
        f"both tables, {server.L} segments at batch 64), embed "
        f"{server.embed_s:.2f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; a 30 s "
        f"request: host walk {reqs[False]['timings']['walk_s'] * 1e3:.2f} "
        f"ms, device walk {reqs[True]['timings']['walk_s'] * 1e3:.2f} ms, "
        f"stitch {reqs[False]['timings']['stitch_s']:.3f} s, "
        f"{len(reqs[False]['frames'])} frames")
    if (tuple(server.q_table.shape) != (server.L, 2048)
            or float((norms - 1).abs().max()) > 1e-3
            or any(len(o["frames"]) < 30 * fps for o in reqs.values())):
        raise AssertionError("the resnext50 server failed its gates")
    out["server_resnext50"] = {"load_s": load_s, "embed_s": server.embed_s}
    del server, reqs
    torch.cuda.empty_cache()

    # one training step each, after a warm-up step
    for arch in ("resnext50", "densenet121"):
        tcfg = Config(enc_arch=arch, batch_size=TRAIN_BS, n_negs=TRAIN_NEGS,
                      seed=0).derive_geometry(fps)
        data = SegmentBatches(video, tcfg.window, tcfg.train_stride,
                              n_negs=tcfg.n_negs, batch_size=tcfg.batch_size,
                              seed=0, drop_last=True)
        it = data.epoch(0)
        torch.cuda.reset_peak_memory_stats()
        model = ContrastiveTextures(arch, 1, tcfg.temp, norm="group",
                                    remat=True).cuda()
        state = create_state(model, tcfg, len(data))
        step = make_train_step(model, tcfg.img_size, False, tcfg.augment)
        losses, ms = [], []
        for k in range(2):
            batch = next(it)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch, step_generator(0, k))
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        clips = TRAIN_BS * (2 + TRAIN_NEGS)
        log(f"      training {arch} at -bs {TRAIN_BS} -negs {TRAIN_NEGS} "
            f"({clips} clips of {tcfg.window} x {tcfg.img_size}^2), bf16, "
            f"fp32 master, remat where the arch has it: losses "
            f"{', '.join(f'{x:.4f}' for x in losses)}; the first step "
            f"{ms[0]:.0f} ms, the second {ms[1]:.0f} ms, peak {peak:.2f} GiB")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"training {arch}: a loss is not finite")
        out[f"train_{arch}"] = {"step_ms": ms[1], "peak_gib": peak}
        del model, state, step
        torch.cuda.empty_cache()
    return out


def slice12_phase(tables: tuple, audio: dict, video: np.ndarray,
                  fps: int, pairwise_entry: dict) -> None:
    """Phase 10: the device walks, the classic ResNet features, the seven
    new encoders and the audio baselines (module docstring)."""
    import dataclasses
    import torch
    from avtex_torch.audio import waveform_to_examples
    from avtex_torch.baselines import (audio_nearest_neighbour,
                                       random_segment_walk,
                                       random_sequential_walk, shift_audio)
    from avtex_torch.classic import frame_features, run_classic_frames
    from avtex_torch.config import ClassicConfig
    from avtex_torch.ops import launch_counts, reset_launch_counts
    from avtex_torch.synth.engine import num_synthesis_steps

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"[10] the device walks, classic ResNet features, the seven new "
        f"encoders, the audio baselines ({smi})")

    # ---- (a) the contrastive device walk ------------------------------- #
    q, t = tables
    steps = num_synthesis_steps(30 * fps, 15, 6)
    walks = [walk_phase("phase 5's tables, a 30 s request", q, t, steps,
                        None, 0.5, 10)]
    rows = audio["mel_rows"]
    walks.append(walk_phase("phase 5's tables, phase 5d's 30 s driving "
                            "clip", q, t, len(rows), rows, 0.5, 10))
    g = torch.Generator(device="cuda").manual_seed(10)
    big = torch.randn((2, 2048, 2304), generator=g, device="cuda").abs()
    big = big / torch.linalg.vector_norm(big, dim=-1, keepdim=True)
    walks.append(walk_phase("seeded unit-norm tables", big[0], big[1],
                            steps, None, 0.5, 10))
    brows = torch.rand((steps, 2048), generator=g, device="cuda") / 0.1
    walks.append(walk_phase("seeded unit-norm tables with seeded rows",
                            big[0], big[1], steps, brows, 0.5, 10))
    pairwise_entry["device_walk"] = walks
    del big, brows

    # ---- (c) the classic ResNet features ------------------------------- #
    cvideo = synthetic_video(CLASSIC_SECONDS, fps)
    src_wave, src_sr = audio["source"]
    ex = waveform_to_examples(src_wave, src_sr, device="cuda")
    feats = {}
    for mode in ("ResNet", "ResNet_VGGish"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats[mode], _ = frame_features(mode, cvideo, "cuda", ex, 40, 4)
        torch.cuda.synchronize()
        log(f"    (c) -f {mode}: features {tuple(feats[mode].shape)} of "
            f"the {len(cvideo)} frames in {time.perf_counter() - t0:.3f} s "
            f"(random resnet18 at 112 px"
            + (", VGGish on the source wav)" if mode != "ResNet" else ")"))
    checks = []
    for f_label, x in (("ResNet", feats["ResNet"]),
                       ("F = 640 (ResNet + 128 VGGish columns)",
                        feats["ResNet_VGGish"][:, :640].contiguous()),
                       ("ResNet_VGGish", feats["ResNet_VGGish"])):
        r = check_pairwise(x, True, True)
        checks.append(r)
        log(f"      pairwise_l2 normalized at N={r['N']} F={r['F']} "
            f"({f_label}): S={r['splits']} ({r['blocks']} blocks, "
            f"{r['blocks_per_sm']} per SM), sq ratio {r['sq_ratio']:.3g} "
            f"(tol {SQ_TOL:g}; kernel vs fp64 {r['kernel_vs_fp64']:.3g}, "
            f"plain vs fp64 {r['plain_vs_fp64']:.3g}), diagonal 0 "
            f"{r['diag_zero']}, symmetric {r['symmetric']}, repeat "
            f"{r['repeat']}; ms {r['ms']:.4f} plain {r['plain_ms']:.4f} "
            f"cdist {r['library_ms']:.4f} bound {r['bound_ms']:.4f} "
            f"({r['bound_by']}); device time: Gram {r['gram_ms']:.4f}, "
            f"epilogue {r['epilogue_ms']:.4f}, row norms "
            f"{r['other_device_ms']:.4f}")
    if not all(r["ok"] for r in checks):
        raise AssertionError("pairwise_l2 disagrees with its plain version "
                             "on the ResNet features")
    r512 = checks[0]
    pairwise_entry["f512"] = {k: r512[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "splits",
        "gram_ms", "epilogue_ms", "other_device_ms", "max_abs_err")}
    pairwise_entry["f12800"] = {k: checks[2][k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "splits")}
    pairwise_entry["max_sq_ratio"] = max(pairwise_entry["max_sq_ratio"],
                                         *(c["sq_ratio"] for c in checks))
    del feats
    base = dataclasses.replace(ClassicConfig(), sigmas=(4.45,))
    reset_launch_counts()
    results = {}
    for mode in ("ResNet", "ResNet_VGGish"):
        t0 = time.perf_counter()
        results[mode] = run_classic_frames(
            dataclasses.replace(base, feats=mode), cvideo, float(fps),
            audio=src_wave, sample_rate=src_sr, device="cuda")
        results[mode]["wall_s"] = time.perf_counter() - t0
    launches = launch_counts()["pairwise_l2"]
    pairwise_entry["launches_resnet_path"] = launches
    for mode, res in results.items():
        (e,) = res["sigma_results"].values()
        tm, p3 = e["timings"], e["p3_new"].cpu().numpy()
        good = check_walk(p3, e["walk"], 0)
        log(f"      run_classic_frames -f {mode}, one sigma: "
            f"{res['wall_s']:.2f} s; D1 {tm['d1_s']:.4f} s, D3 "
            f"{tm['d3_s']:.4f} s, walk {tm['walk_s']:.4f} s, fetch "
            f"{tm['fetch_s']:.4f} s; {e['jump_count']} jumps; every step "
            f"on a nonzero entry {good}")
        if not (good and np.isfinite(p3).all()
                and (p3.max(axis=1) > 0).all()):
            raise AssertionError(f"-f {mode}: bad P3 or walk")
    log(f"      pairwise_l2 launches on the two runs: {launches}")
    if launches != 2:
        raise AssertionError(f"{launches} pairwise_l2 launches for 2 D1 "
                             "calls")
    del results, cvideo
    torch.cuda.empty_cache()

    # ---- (d) the seven new encoders ------------------------------------ #
    pairwise_entry["encoders"] = encoder_phase(video, fps)

    # ---- (e) the audio baselines --------------------------------------- #
    drv_wave, drv_sr = audio["driving"]
    W, S = 15, 6
    L = (len(video) - W) // S
    t0 = time.perf_counter()
    src_eg = waveform_to_examples(src_wave, src_sr, device="cuda")
    drv_eg = waveform_to_examples(drv_wave, drv_sr, device="cuda")
    ids, segs = audio_nearest_neighbour(drv_eg, src_eg, W, S, 30 * fps)
    nn_s = time.perf_counter() - t0
    s64 = src_eg.reshape(len(src_eg), -1).double().cpu()
    d64 = drv_eg.reshape(len(drv_eg), -1).double().cpu()
    sims = (d64 / d64.norm(dim=1, keepdim=True)) @ (
        s64 / s64.norm(dim=1, keepdim=True)).t()
    got = sims[torch.arange(len(segs)) % len(d64),
               torch.from_numpy(segs)]
    gap = float((sims.amax(1)[torch.arange(len(segs)) % len(d64)]
                 - got).max())
    t0 = time.perf_counter()
    seq = random_sequential_walk(L, W, S, 30 * fps, 0)
    rseq, rsegs = random_segment_walk(L, W, S, 30 * fps, 0)
    shifted, secs = shift_audio(src_wave, src_sr, seed=0)
    rand_s = time.perf_counter() - t0
    log(f"    (e) audio_nearest_neighbour on phase 5d's wavs ("
        f"{len(drv_eg)} driving, {len(src_eg)} source examples, on the "
        f"card): {len(segs)} matches, {len(ids)} frames (largest id "
        f"{int(ids.max())}: avtex matches every source example, not only "
        f"the {L} segments) in {nn_s:.3f} s (log-mel included); each "
        f"match within {gap:.2g} of the best "
        f"fp64 cosine; random: {len(seq)} frames, random_segment: "
        f"{len(rseq)} frames ({len(rsegs)} blocks), shift {secs:.0f} s: "
        f"{rand_s * 1e3:.2f} ms together")
    if (gap > 1e-4 or len(ids) < 30 * fps or segs.max() >= len(src_eg)
            or len(seq) < 30 * fps or rseq.max() >= len(video)
            or len(shifted) != len(src_wave)):
        raise AssertionError("audio baselines failed their gates")
    log(f"    phase 10: {time.perf_counter() - t_phase:.1f} s")

def contrastive_phase(server, audio: dict, video: np.ndarray, fps: int,
                      kernel_entry: dict) -> None:
    """Phase 11: -daf Contrastive, its trainer, CAMs, AudioVisualFeatures
    and ClassicTemporal (module docstring). ``server`` is phase 5's;
    adds fused_conv1x1's launches on the CAM path to ``kernel_entry``."""
    import tempfile
    import torch
    from avtex_torch.media import write_wav

    t_phase = time.perf_counter()
    log(f"[11] the contrastive extras ({nvidia_smi_line()})")
    with tempfile.TemporaryDirectory() as tmp:
        drv_path = write_wav(os.path.join(tmp, "driving.wav"),
                             *audio["driving"])
        trained = retrieval_train_phase(server, audio, video)
        first = daf_contrastive_phase(server, video, fps, drv_path, trained,
                                      tmp)
    del trained
    torch.cuda.empty_cache()
    kernel_entry["launches_cam_path"] = cam_phase(server, first)
    torch.cuda.empty_cache()
    side_modules_phase(video)
    log(f"    phase 11: {time.perf_counter() - t_phase:.1f} s")


def retrieval_train_phase(server, audio: dict, video: np.ndarray):
    """Phase 11 (b): train_video_for_audio at avtex's defaults; a repeated
    batch overfit; card against CPU at a small width. Returns the trained
    module and its fp32 master parameters for (a)."""
    import torch
    from avtex_torch.audio import waveform_to_examples
    from avtex_torch.contrastive.audio_retrieval import VideoForAudio
    from avtex_torch.contrastive.retrieval_train import (
        create_retrieval_state, retrieval_batches, retrieval_step,
        train_video_for_audio)
    from avtex_torch.synth.pipeline import flax_style_init

    W, S, L = server.W, server.S, server.L
    examples = waveform_to_examples(*audio["source"], device="cuda")
    bs, negs, epochs = 8, 7, 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, params, history = train_video_for_audio(
        video, examples.cpu().numpy(), W, S, epochs=epochs, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = epochs * (L // bs)
    log(f"    (b) train_video_for_audio at avtex's defaults (resnet18, "
        f"112 px, batch {bs}, {negs} negatives: {bs * (1 + negs)} clips a "
        f"step), {epochs} epochs of {L // bs} steps on the {len(video)}-"
        f"frame video and {len(examples)} source examples: {train_s:.2f} s "
        f"(init and upload included), epoch losses {history}, peak "
        f"{peak:.2f} GiB")
    if len(history) != epochs or not np.isfinite(history).all():
        raise AssertionError(f"retrieval training losses {history}")

    # one batch again and again: the loss must fall; warm steps timed
    ov = VideoForAudio("resnet18")
    state = create_retrieval_state(ov.cuda().train(), 1e-3,
                                   flax_style_init(ov, 1))
    ids, t_ids = next(retrieval_batches(L, bs, negs,
                                        np.random.default_rng(0)))
    video_dev = torch.from_numpy(video).cuda()
    a = examples[torch.from_numpy(np.minimum(ids, len(examples) - 1)).cuda()]
    v = video_dev[torch.from_numpy(t_ids * S).cuda()[..., None]
                  + torch.arange(W, device="cuda")]
    losses, step_s = [], []
    for _ in range(OVERFIT_STEPS):
        t0 = time.perf_counter()
        losses.append(float(retrieval_step(state, a, v, 112)))
        step_s.append(time.perf_counter() - t0)
    step_ms = float(np.median(step_s[2:])) * 1e3
    log(f"      a repeated batch, {OVERFIT_STEPS} steps: loss "
        f"{losses[0]:.4f} -> lowest {min(losses[1:]):.4f}, last "
        f"{losses[-1]:.4f}; a warm step {step_ms:.1f} ms host to host "
        f"(median of {len(step_s) - 2}), {bs * (1 + negs) / step_ms * 1e3:.0f}"
        f" clips/s")
    if not (np.isfinite(losses).all()
            and min(losses[1:]) <= (1 - OVERFIT_DROP) * losses[0]):
        raise AssertionError(f"the repeated batch's loss did not fall by "
                             f"{OVERFIT_DROP:.0%}: {losses}")
    del ov, state, video_dev, a, v

    # the card against the CPU, fp32, a small width
    frames = synthetic_video(3, 30, VFA_CPU_SIZE)
    small_l = (len(frames) - W) // S
    ex = examples[:small_l].cpu()
    init = flax_style_init(VideoForAudio("resnet18", dtype=torch.float32,
                                         width=VFA_CPU_WIDTH), 2)
    batches = [b for _, b in zip(range(2), retrieval_batches(
        small_l, 2, 2, np.random.default_rng(1)))]
    runs = {}
    with fp32_exact():
        for dev in ("cpu", "cuda"):
            m = VideoForAudio("resnet18", dtype=torch.float32,
                              width=VFA_CPU_WIDTH).to(dev).train()
            st = create_retrieval_state(
                m, VFA_CPU_LR, {k: t.clone() for k, t in init.items()})
            vid, aud = torch.from_numpy(frames).to(dev), ex.to(dev)
            runs[dev] = [float(retrieval_step(
                st, aud[torch.from_numpy(np.minimum(i, len(ex) - 1)).to(
                    dev)], vid[torch.from_numpy(t * S).to(dev)[..., None]
                               + torch.arange(W, device=dev)],
                VFA_CPU_SIZE)) for i, t in batches]
    err = max(abs(x - y) for x, y in zip(runs["cpu"], runs["cuda"]))
    log(f"      card vs CPU, width {VFA_CPU_WIDTH} at {VFA_CPU_SIZE}^2, "
        f"fp32, TF32 off, LR {VFA_CPU_LR:g}, two steps from the same "
        f"parameters and batches: losses card {runs['cuda']} vs CPU "
        f"{runs['cpu']}, max |diff| {err:.3g} (<= {CPU_LOSS_TOL:g})")
    if err > CPU_LOSS_TOL:
        raise AssertionError("retrieval training on the card disagrees "
                             "with the CPU")
    return model, params, history


def daf_contrastive_phase(server, video: np.ndarray, fps: int,
                          drv_path: str, trained, tmp: str):
    """Phase 11 (a): -daf Contrastive through phase 5's server, two 30 s
    requests; bf16 against fp32; a -daf_resume file from (b). Returns the
    first request's result."""
    import dataclasses
    import torch
    from avtex_torch.audio import waveform_to_examples
    from avtex_torch.contrastive.audio_retrieval import (
        VideoForAudio, embed_video_table, video_for_audio_logits)
    from avtex_torch.convert import export_params
    from avtex_torch.media import read_wav
    from avtex_torch.synth import TextureServer
    from avtex_torch.train import save_checkpoint

    server.cfg = dataclasses.replace(server.cfg, da_feats="Contrastive")
    cfg, W, S, L = server.cfg, server.W, server.S, server.L
    outs = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = server.synthesize(seconds=30, seed=5, driving_audio=drv_path)
        out["host_s"] = time.perf_counter() - t0
        outs.append(out)
    scorer = server._scorer()
    table = scorer.video_table
    wave, sr = read_wav(drv_path)  # what the server read
    drv_eg = waveform_to_examples(wave, sr * server.sub, device="cuda")
    steps = len(outs[0]["result"].indices)
    rows, seed = scorer(drv_eg, steps)
    norms = torch.linalg.vector_norm(table, dim=-1)
    for i, out in enumerate(outs):
        t = out["timings"]
        log(f"    (a) -daf Contrastive request {i + 1} (30 s, {steps} "
            f"steps, seed segment {out['result'].seed_id}): "
            + (f"scorer_s {t['scorer_s']:.3f} s, " if "scorer_s" in t
               else "scorer reused, ")
            + f"audio_rows_s {t['audio_rows_s']:.3f} s, walk "
            f"{t['walk_s']:.4f} s, stitch {t['stitch_s']:.3f} s, host to "
            f"host {out['host_s']:.3f} s, {len(out['frames'])} frames")
    if not (tuple(table.shape) == (L, 128) and torch.isfinite(table).all()
            and float((norms - 1).abs().max()) <= 1e-3):
        raise AssertionError(f"bad -daf Contrastive table "
                             f"{tuple(table.shape)}")
    # phase 5's server has no source wav: no audio-matched seed
    if not (tuple(rows.shape) == (steps, L) and steps > 0
            and torch.isfinite(rows).all() and seed is None):
        raise AssertionError(f"bad -daf Contrastive rows {tuple(rows.shape)}")
    if "scorer_s" not in outs[0]["timings"] or \
            "scorer_s" in outs[1]["timings"]:
        raise AssertionError("the Contrastive scorer was not built once")
    if not np.array_equal(outs[0]["result"].indices,
                          outs[1]["result"].indices):
        raise AssertionError("a repeated -daf Contrastive request gave "
                             "other indices")

    # the same weights in fp32
    vfa32 = VideoForAudio("resnet18", dtype=torch.float32)
    vfa32.load_state_dict({k: t.float() for k, t in
                           scorer.vfa.state_dict().items()})
    with fp32_exact():
        t32 = embed_video_table(vfa32.cuda().eval(), server.video, W, S, L,
                                cfg.img_size, cfg.mini_batchsize)
    cos = torch.nn.functional.cosine_similarity(table, t32, dim=-1)
    log(f"      the [{L}, 128] table: unit rows (max |norm - 1| "
        f"{float((norms - 1).abs().max()):.2g}); bf16 vs fp32 on the same "
        f"weights, cosine min {float(cos.min()):.6f} (>= {VFA_COS}); rows "
        f"[{steps}, {L}] finite")
    if float(cos.min()) < VFA_COS:
        raise AssertionError("the bf16 Contrastive table disagrees with fp32")
    del vfa32, t32

    # a -daf_resume file from (b)'s parameters, into a new server
    model_b, params_b, history = trained
    path = save_checkpoint(tmp, "video_for_audio", export_params(params_b),
                           len(history), "resnet18", min(history), True)
    ids = torch.from_numpy(np.minimum(np.arange(steps),
                                      len(drv_eg) - 1)).cuda()
    mem = video_for_audio_logits(
        model_b.eval(), drv_eg[ids],
        embed_video_table(model_b, server.video, W, S, L, cfg.img_size,
                          cfg.mini_batchsize), cfg.temp)
    resumed = TextureServer.from_frames(
        dataclasses.replace(cfg, daf_resume=[path]), video, float(fps),
        server.model.state_dict(), device="cuda")
    out = resumed.synthesize(seconds=30, seed=5, driving_audio=drv_path)
    got, _ = resumed._scorer()(drv_eg, steps)
    log(f"      -daf_resume from (b)'s parameters "
        f"({os.path.getsize(path) / 2 ** 20:.1f} MiB): rows bit-identical "
        f"to the in-memory module's {torch.equal(got, mem)}; "
        f"{len(out['result'].indices)} steps")
    if not torch.equal(got, mem):
        raise AssertionError("the -daf_resume rows differ from the trained "
                             "module's")
    del resumed
    return outs[0]["result"]


def cam_phase(server, result) -> int:
    """Phase 11 (c): segment_cams of phase 5's query tower over every
    segment, fuse="all" against fuse=False, the overlays of (a)'s first
    request. Returns fused_conv1x1's launches on the CAM pass."""
    import torch
    from avtex_torch.contrastive.model import ContrastiveTextures
    from avtex_torch.obs import overlay_cam
    from avtex_torch.ops import launch_counts, reset_launch_counts
    from avtex_torch.synth.cam import cam_step_frames, segment_cams

    W, S, L, size = server.W, server.S, server.L, server.cfg.img_size
    batch = 16
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    cams = segment_cams(server.model, server.video, W, S, L, tower="query",
                        img_size=size, batch_size=batch)
    torch.cuda.synchronize()
    cam_s = time.perf_counter() - t0
    launches = launch_counts()["fused_conv1x1"]
    want = LAUNCHES_PER_BATCH // 2 * -(-L // batch)
    plain = ContrastiveTextures("slowfast", norm="affine", fuse=False)
    plain.load_state_dict(server.model.state_dict())
    cams_plain = segment_cams(plain.cuda().eval(), server.video, W, S, L,
                              img_size=size, batch_size=batch)
    cos = torch.nn.functional.cosine_similarity(
        cams.flatten(1), cams_plain.flatten(1), dim=-1)
    q_ids = np.concatenate([[result.seed_id], result.indices[:-1]])
    t0 = time.perf_counter()
    q_frames, p_frames = cam_step_frames(server.video, cams, q_ids, W, S)
    overlay_s = time.perf_counter() - t0
    few = q_ids[:4]
    centre = np.minimum(few * S + W // 2, len(server.video) - 1)
    on_card = overlay_cam(torch.from_numpy(server.video[centre]).cuda(),
                          cams[torch.from_numpy(few).cuda()]).cpu().numpy()
    on_host = overlay_cam(server.video[centre], cams[
        torch.from_numpy(few).cuda()].cpu().numpy())
    log(f"    (c) segment_cams of phase 5's query tower, {L} segments at "
        f"{size}^2 in batches of {batch}: {tuple(cams.shape)} in "
        f"{cam_s:.3f} s, fused_conv1x1 launches {launches} (expected "
        f"{want}); fuse='all' vs fuse=False cosine min "
        f"{float(cos.min()):.6f} (>= {CAM_COS}); cam_step_frames of (a)'s "
        f"first request: {q_frames.shape} and {p_frames.shape} "
        f"{q_frames.dtype} in {overlay_s:.3f} s; overlays on the card "
        f"equal the numpy run's on {len(few)} frames "
        f"{np.array_equal(on_card, on_host)}")
    side = -(-size // 32)  # SlowFast's stride: 7 at 224^2
    if not (tuple(cams.shape) == (L, side, side)
            and torch.isfinite(cams).all()):
        raise AssertionError(f"bad CAMs {tuple(cams.shape)}")
    if launches != want:
        raise AssertionError(f"{launches} fused_conv1x1 launches on the CAM "
                             f"pass, expected {want}")
    if float(cos.min()) < CAM_COS:
        raise AssertionError("CAMs with the kernel disagree with cuDNN")
    steps = len(result.indices)
    for f in (q_frames, p_frames):
        if f.dtype != np.uint8 or f.shape != (steps, size, size, 3):
            raise AssertionError(f"bad CAM frames {f.shape} {f.dtype}")
    if not np.array_equal(on_card, on_host):
        raise AssertionError("the overlay on the card differs from numpy's")
    return launches


def side_modules_phase(video: np.ndarray) -> None:
    """Phase 11 (d): AudioVisualFeatures and ClassicTemporal, card against
    CPU in fp32, and their bf16 forward ms."""
    import torch
    from avtex_torch.contrastive.av_features import AudioVisualFeatures
    from avtex_torch.contrastive.classic_temporal import ClassicTemporal
    from avtex_torch.data.preprocess import preprocess_clip
    from avtex_torch.synth.pipeline import flax_style_init

    g = torch.Generator().manual_seed(11)
    clip = torch.randn((8, 16, 112, 112, 3), generator=g)
    wav = 0.3 * torch.randn((8, 22050), generator=g)
    W, S = 15, 6
    L = (len(video) - W) // S
    ids = np.arange(18) * (L // 18) * S
    clips = preprocess_clip(torch.from_numpy(
        video[ids[:, None] + np.arange(W)[None]]), 112)
    q, t = clips[:2], clips[2:].reshape((2, 8) + clips.shape[1:])
    for name, make, args in (
            ("AudioVisualFeatures (emb 128; 8 clips of 16 x 112^2, 1 s "
             "waveforms at 22050 Hz)", AudioVisualFeatures, (clip, wav)),
            ("ClassicTemporal (resnet18; B = 2, N = 8 clips of 15 x 112^2)",
             lambda dtype: ClassicTemporal("resnet18", dtype=dtype),
             (q, t))):
        m32 = make(dtype=torch.float32)
        state = flax_style_init(m32, 0)
        m32.load_state_dict(state)
        with torch.inference_mode():
            want = m32.eval()(*args)
            with fp32_exact():
                got = m32.cuda()(*(a.cuda() for a in args)).cpu()
        cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
        bf = make(dtype=torch.bfloat16)
        bf.load_state_dict(state)
        bf = bf.cuda().eval()
        dev_args = [a.cuda() for a in args]
        with torch.inference_mode():
            ms = time_ms(lambda: bf(*dev_args), reps=10)
            with fp32_exact():
                ms32 = time_ms(lambda: m32(*dev_args), reps=5)
        log(f"    (d) {name}: output {tuple(got.shape)}, card vs CPU fp32 "
            f"cosine min {float(cos.min()):.7f} (>= {SIDE_COS}); forward "
            f"bf16 {ms:.2f} ms, fp32 {ms32:.2f} ms")
        if not (torch.isfinite(got).all() and float(cos.min()) >= SIDE_COS):
            raise AssertionError(f"{name}: the card disagrees with the CPU")
        del m32, bf, dev_args


def import_phase(server, video: np.ndarray, fps: int, kernel_entry: dict
                 ) -> None:
    """Phase 12: pretrained encoder import, the native host runtime and
    the profiler (module docstring)."""
    import tempfile
    import torch

    t_phase = time.perf_counter()
    log(f"[12] pretrained encoder import, the native runtime, the profiler "
        f"({nvidia_smi_line()})")
    saved = os.environ.pop("AVTEX_ENCODER_CKPT", None)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            kernel_entry["launches_pretrained_path"] = slowfast_import_phase(
                video, fps, tmp)
            torch.cuda.empty_cache()
            bn_import_phase(video, fps, tmp)
    finally:
        os.environ.pop("AVTEX_ENCODER_CKPT", None)
        if saved is not None:
            os.environ["AVTEX_ENCODER_CKPT"] = saved
    torch.cuda.empty_cache()
    native_phase(server)
    profiler_phase(server)
    log(f"    phase 12: {time.perf_counter() - t_phase:.1f} s")


def check_imported_server(label: str, cfg, video: np.ndarray, fps: int,
                          path: str, want_state: dict):
    """A norm="affine" server loading ``path`` through $AVTEX_ENCODER_CKPT
    with no trained checkpoint; one 10 s request; unit rows; both towers
    hold ``want_state`` (the encoder's converted state); the card's bf16
    embeddings of IMPORT_CLIPS clips against the same file loaded into an
    fp32 model on the CPU. Returns (server, fused_conv1x1 launches)."""
    import dataclasses
    import torch
    from avtex_torch.native.stitch import crossfade
    from avtex_torch.ops import launch_counts, reset_launch_counts
    from avtex_torch.synth import TextureServer
    from avtex_torch.synth.embeddings import precompute_embeddings_from_video
    from avtex_torch.synth.pipeline import build_model

    os.environ["AVTEX_ENCODER_CKPT"] = path
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    server = TextureServer.from_frames(cfg, video, float(fps),
                                       device="cuda", interp_fn=crossfade)
    load_s = time.perf_counter() - t0
    launches = launch_counts()["fused_conv1x1"]
    out = server.synthesize(seconds=10, seed=1)
    state = server.model.state_dict()
    held = all(torch.equal(state[f"{tower}.video_encoder.{k}"],
                           v.to(state[f"{tower}.video_encoder.{k}"].device,
                                state[f"{tower}.video_encoder.{k}"].dtype))
               for tower in ("q_embedder", "t_embedder")
               for k, v in want_state.items())
    model32 = build_model(dataclasses.replace(
        cfg, compute_dtype="float32").derive_geometry(fps), None, "cpu")
    with torch.inference_mode(), fp32_exact():
        q32, _ = precompute_embeddings_from_video(
            model32, server.video, server.W, server.S, IMPORT_CLIPS,
            img_size=cfg.img_size, batch_size=IMPORT_CLIPS)
    cos = torch.nn.functional.cosine_similarity(
        server.q_table[:IMPORT_CLIPS].float().cpu(), q32, dim=-1)
    rows_ok = True
    for tab in (server.q_table, server.t_table):
        norms = torch.linalg.vector_norm(tab.float(), dim=-1)
        rows_ok &= bool(torch.isfinite(tab).all()
                        and float((norms - 1).abs().max()) <= 1e-3)
    log(f"        {label}: TextureServer.from_frames {load_s:.2f} s (init, "
        f"the file's import into both towers, first embed), tables "
        f"{tuple(server.q_table.shape)}, unit rows {rows_ok}, both towers "
        f"hold the file {held}, fused_conv1x1 launches {launches}; a 10 s "
        f"request {len(out['result'].indices)} steps, walk "
        f"{out['timings']['walk_s']:.4f} s, stitch "
        f"{out['timings']['stitch_s']:.3f} s; bf16 card vs fp32 CPU on "
        f"{IMPORT_CLIPS} clips: cosine min {float(cos.min()):.6f} "
        f"(>= {IMPORT_COS})")
    if not (rows_ok and held and len(out["frames"]) >= 10 * fps):
        raise AssertionError(f"{label}: the loaded server is wrong")
    if float(cos.min()) < IMPORT_COS:
        raise AssertionError(f"{label}: the card disagrees with the CPU")
    return server, launches


def slowfast_import_phase(video: np.ndarray, fps: int, tmp: str) -> int:
    """Phase 12 (a). Returns fused_conv1x1's launches of one loaded
    server's embed."""
    import pickle
    import torch
    from avtex_torch.checkpoints import (convert_slowfast,
                                         load_slowfast_state,
                                         slowfast_c2_blobs,
                                         slowfast_reference_state)
    from avtex_torch.config import Config
    from avtex_torch.nn.slowfast import SlowFastR50

    t0 = time.perf_counter()
    state = slowfast_reference_state(seed=12)
    paths = {"pkl": os.path.join(tmp, "SLOWFAST_8x8_R50.pkl"),
             "pyth": os.path.join(tmp, "SLOWFAST_8x8_R50.pyth")}
    with open(paths["pkl"], "wb") as f:
        pickle.dump({"blobs": slowfast_c2_blobs(state)}, f, protocol=2)
    torch.save({"model_state": {k: torch.from_numpy(v)
                                for k, v in state.items()}}, paths["pyth"])
    write_s = time.perf_counter() - t0
    slots = SlowFastR50(norm="affine").state_dict()
    converted, read_ms = {}, {}
    for fmt, path in paths.items():
        t0 = time.perf_counter()
        converted[fmt] = convert_slowfast(load_slowfast_state(path), slots)
        read_ms[fmt] = (time.perf_counter() - t0) * 1e3
    same_state = all(torch.equal(converted["pkl"][k], converted["pyth"][k])
                     for k in slots)
    log(f"    (a) SlowFast-R50: a seeded state under pyslowfast's names, "
        f"{len(state)} tensors, {sum(v.size for v in state.values())} "
        f"values, written as a caffe2 .pkl "
        f"({os.path.getsize(paths['pkl']) / 2**20:.1f} MiB) and a .pyth "
        f"({os.path.getsize(paths['pyth']) / 2**20:.1f} MiB) in "
        f"{write_s:.2f} s; load_slowfast_state + convert_slowfast: .pkl "
        f"{read_ms['pkl']:.1f} ms, .pyth {read_ms['pyth']:.1f} ms; the two "
        f"conversions equal {same_state}")
    if not same_state:
        raise AssertionError("the .pkl and .pyth conversions differ")
    cfg = Config(enc_arch="slowfast", norm="affine", mini_batchsize=150,
                 seed=0)
    servers, launches = {}, 0
    for fmt, path in paths.items():
        servers[fmt], launches = check_imported_server(
            f"slowfast from the .{fmt}", cfg, video, fps, path,
            converted[fmt])
        servers[fmt] = (servers[fmt].q_table, servers[fmt].t_table)
        torch.cuda.empty_cache()
    same = all(torch.equal(a, b) for a, b in zip(servers["pkl"],
                                                 servers["pyth"]))
    log(f"        the two formats' tables bit-identical: {same}")
    if not same:
        raise AssertionError("the .pkl and .pyth servers' tables differ")
    return launches


def bn_import_phase(video: np.ndarray, fps: int, tmp: str) -> None:
    """Phase 12 (b): -ea resnet18 --norm affine from an r3d18-style file;
    the classic -f ResNet from a resnet18-imagenet.pth-style file."""
    import torch
    from avtex_torch.checkpoints import (convert_bn_folded, load_torch_state,
                                         maybe_load_encoder,
                                         resnet_reference_state)
    from avtex_torch.classic import frame_features
    from avtex_torch.classic.features import resnet_features
    from avtex_torch.config import Config
    from avtex_torch.nn.resnet2d import resnet2d18
    from avtex_torch.nn.resnet3d import resnet3d18
    from avtex_torch.synth.pipeline import flax_style_init

    enc = resnet3d18(norm="affine")
    path = os.path.join(tmp, "r3d18_KM_200ep.pth")
    torch.save({"state_dict": {
        k: torch.from_numpy(v) for k, v in resnet_reference_state(
            enc, (2, 2, 2, 2), seed=13).items()}}, path)
    want = convert_bn_folded(
        {k: v for k, v in load_torch_state(path).items()
         if not k.startswith("fc.")}, enc, enc.state_dict(),
        torch.zeros((1, 15, 32, 32, 3)))
    log(f"    (b) resnet18 (3D) from a seeded r3d18_KM_200ep.pth-style file "
        f"({os.path.getsize(path) / 2**20:.1f} MiB), BatchNorm folded:")
    server, _ = check_imported_server(
        "-ea resnet18 --norm affine",
        Config(enc_arch="resnet18", norm="affine", mini_batchsize=150,
               seed=0), video, fps, path, want)
    del server
    torch.cuda.empty_cache()

    net = resnet2d18()
    path = os.path.join(tmp, "resnet18-imagenet.pth")
    torch.save({k: torch.from_numpy(v) for k, v in resnet_reference_state(
        net, (2, 2, 2, 2), seed=14).items()}, path)
    os.environ["AVTEX_ENCODER_CKPT"] = path
    cvideo = synthetic_video(CLASSIC_SECONDS, fps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats, _ = frame_features("ResNet", cvideo, "cuda")
    torch.cuda.synchronize()
    feat_s = time.perf_counter() - t0
    module = resnet2d18(norm="affine")
    state, loaded = maybe_load_encoder(
        "resnet18_2d", module, flax_style_init(module, 0),
        torch.zeros((1, 32, 32, 3)))
    module.load_state_dict(state)
    direct, _ = resnet_features(cvideo, "cuda", module.cuda().eval())
    same = loaded and torch.equal(feats, direct)
    log(f"        classic -f ResNet with a seeded resnet18-imagenet.pth-"
        f"style file: features {tuple(feats.shape)} of the {len(cvideo)} "
        f"frames in {feat_s:.3f} s (the file's import included), finite "
        f"{bool(torch.isfinite(feats).all())}, bit-identical to the "
        f"explicitly loaded net's {same}")
    if not (same and torch.isfinite(feats).all()
            and tuple(feats.shape) == (len(cvideo), 512)):
        raise AssertionError("the classic ResNet features did not load "
                             "the file")


def native_phase(server) -> None:
    """Phase 12 (c): a fresh build of the host runtime; phase 5's 30 s
    request stitched natively and with numpy; the two AVI muxers."""
    import tempfile
    import types
    from avtex_torch.media import avimux
    from avtex_torch.native import muxer
    from avtex_torch.ops import _build
    from avtex_torch.synth import stitcher

    saved_dir = _build.BUILD_DIR
    with tempfile.TemporaryDirectory() as tmp:
        _build.BUILD_DIR = tmp
        try:
            rep = _build.build_native()
        finally:
            _build.BUILD_DIR = saved_dir
    log(f"    (c) the native runtime: a fresh g++ build of "
        f"{', '.join(_build.NATIVE_SOURCES)} in {rep['seconds']:.2f} s "
        f"({' '.join(_build.GXX_FLAGS)})")

    result = server.synthesize(seconds=30, threshold=0.2, seed=2,
                               stitch=False)["result"]
    numpy_runtime = types.SimpleNamespace(stitch_frames=stitcher.stitch_frames,
                                          crossfade=stitcher.crossfade)
    native_runtime = stitcher.native_stitch
    best = {}
    for bar in (False, True):
        runs, outs = {"native": [], "numpy": []}, {}
        for _ in range(3):
            for label, runtime in (("native", native_runtime),
                                   ("numpy", numpy_runtime)):
                stitcher.native_stitch = runtime
                try:
                    t0 = time.perf_counter()
                    outs[label] = stitcher.stitch_texture(
                        server.video_full, result.indices, server.W,
                        server.S, sf=server.cfg.SF, frames_bar=bar,
                        fps=server.fps)
                    runs[label].append((time.perf_counter() - t0) * 1e3)
                finally:
                    stitcher.native_stitch = native_runtime
        a, b = outs["native"], outs["numpy"]
        same = all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
                   for k in ("frames", "frames_intp"))
        log(f"        stitch of phase 5's 30 s request ({len(result.indices)}"
            f" steps, {a['jump_count']} jumps, {len(a['frames'])} frames, "
            f"{len(a['frames_intp'])} interpolated), frames_bar={bar}: "
            f"native {min(runs['native']):.1f} ms, numpy "
            f"{min(runs['numpy']):.1f} ms (best of 3; runs native "
            f"{', '.join(f'{x:.1f}' for x in runs['native'])}, numpy "
            f"{', '.join(f'{x:.1f}' for x in runs['numpy'])}); "
            f"byte-identical {same}")
        if not same:
            raise AssertionError("the native stitch differs from numpy's")
        best[bar] = min(runs["native"])

    # the parts the native runtime replaces: the gather and the crossfades
    frame_ids, jump_at = stitcher.walk_frame_ids(result.indices, server.W,
                                                 server.S)
    video, sf = server.video_full, server.cfg.SF
    pairs = [(video[frame_ids[k - 1]], video[frame_ids[k]])
             for k in jump_at if k > 0]
    parts = {}
    for label, runtime in (("native", native_runtime),
                           ("numpy", numpy_runtime)) * 2:
        t0 = time.perf_counter()
        runtime.stitch_frames(video, frame_ids, False, len(video))
        t1 = time.perf_counter()
        for f0, f1 in pairs:
            runtime.crossfade(f0, f1, sf - 1)
        parts[label] = ((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3)
    log(f"        of which (the second of two runs each): the gather of "
        f"{len(frame_ids)} frames native {parts['native'][0]:.1f} ms, "
        f"numpy {parts['numpy'][0]:.1f} ms; {len(pairs)} crossfades of "
        f"{sf - 1} frames native {parts['native'][1]:.1f} ms, numpy "
        f"{parts['numpy'][1]:.1f} ms; the rest of the stitch (assembling "
        f"the interpolated track, frames_bar off) "
        f"~{best[False] - sum(parts['native']):.1f} ms")

    g = np.random.default_rng(15)
    n, sr = 900, 22050
    jpegs = [g.bytes(int(k)) for k in g.integers(15000, 30000, n)]
    pcm = (g.standard_normal(n * sr // 30) * 3000).astype(np.int16)
    times, data = {"native": [], "python": []}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for _ in range(3):
            for label, write in (("native", muxer.write_avi),
                                 ("python", avimux.mux_avi)):
                path = os.path.join(tmp, f"{label}.avi")
                t0 = time.perf_counter()
                write(path, jpegs, 224, 224, 30.0, pcm, sr)
                times[label].append((time.perf_counter() - t0) * 1e3)
                with open(path, "rb") as f:
                    data[label] = f.read()
    same = data["native"] == data["python"]
    log(f"        AVI of {n} synthetic JPEG byte strings "
        f"({sum(map(len, jpegs)) / 2**20:.1f} MiB) and {len(pcm) / sr:.0f} s "
        f"of PCM at {sr} Hz: C++ muxer {min(times['native']):.1f} ms, "
        f"Python {min(times['python']):.1f} ms (best of 3); files "
        f"byte-identical {same} ({len(data['native'])} bytes)")
    if not same:
        raise AssertionError("the C++ muxer's file differs from Python's")


def profiler_phase(server) -> None:
    """Phase 12 (d): trace(logdir) around one warm embed batch."""
    import tempfile
    import torch
    from avtex_torch.obs import trace
    from avtex_torch.synth.embeddings import precompute_embeddings_from_video

    def batch():
        precompute_embeddings_from_video(
            server.model, server.video, server.W, server.S, 150,
            img_size=server.cfg.img_size, batch_size=150)
        torch.cuda.synchronize()

    batch()  # warm
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with trace(tmp, name="warm_embed_batch"):
            batch()
        traced_s = time.perf_counter() - t0
        files = os.listdir(tmp)
        text = ""
        if len(files) == 1:
            with open(os.path.join(tmp, files[0])) as f:
                text = f.read()
    t0 = time.perf_counter()
    batch()
    plain_s = time.perf_counter() - t0
    named = text.count("fused_conv1x1_kernel")
    log(f"    (d) trace(logdir) around one warm embed batch (150 segments, "
        f"both towers): {files}, {len(text) / 2**20:.1f} MiB, "
        f"fused_conv1x1_kernel named {named} times; the batch {traced_s:.3f}"
        f" s traced (export included) vs {plain_s:.3f} s untraced")
    if len(files) != 1 or named == 0 or "warm_embed_batch" not in text:
        raise AssertionError("the trace is missing or does not name the "
                             "fused_conv1x1 kernel")


def parallel_phase(cfg, server, video: np.ndarray, fps: int, n_batches: int,
                   m2: dict, ref_indices: np.ndarray) -> dict:
    """Phase 13: the parallel layer at world size 1 (module docstring).
    Returns the numbers of the ``parallel`` line."""
    import torch
    import torch.distributed as dist
    from avtex_torch.classic import (anticipated_future_cost,
                                     classic_transition_matrix,
                                     classic_transition_matrix_sharded,
                                     diagonal_filter_smooth,
                                     distance_to_transition_probs,
                                     pairwise_l2, rgb_features,
                                     threshold_rows)
    from avtex_torch.ops.pairwise import pairwise_l2_reference
    from avtex_torch.config import ClassicConfig, Config
    from avtex_torch.contrastive.model import ContrastiveTextures
    from avtex_torch.data.pipeline import SegmentBatches
    from avtex_torch.ops import launch_counts, reset_launch_counts
    from avtex_torch.parallel import (make_mesh, make_sharded_train_step,
                                      sharded_embed_from_video, shutdown)
    from avtex_torch.synth import TextureServer
    from avtex_torch.synth.embeddings import precompute_embeddings_from_video
    from avtex_torch.train import create_state, make_train_step
    from avtex_torch.train.loop import step_generator

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    mesh = make_mesh()
    out = {"world_size": dist.get_world_size(),
           "backend": dist.get_backend(), "mesh_s": time.perf_counter() - t0}
    log(f"[13] parallel: world size {out['world_size']}, backend "
        f"{out['backend']}, {mesh} ({out['mesh_s']:.2f} s to start the "
        f"one-process world and the mesh; {smi})")
    problems = []
    try:
        W, S, L = server.W, server.S, server.L
        kw = dict(img_size=cfg.img_size, batch_size=cfg.mini_batchsize)

        def best(fn, runs=2):
            """(last result, best seconds) of synchronised runs."""
            times = []
            for _ in range(runs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            return res, min(times)

        def sharded_tables(model, vid, audio=None):
            return tuple(sharded_embed_from_video(
                model, mesh, vid, W, S, L, audio, tower=tower, **kw)
                for tower in ("query", "target"))

        def check_tables(label, got, want, dim):
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            cos = min(float(torch.nn.functional.cosine_similarity(
                g, w, dim=-1).min()) for g, w in zip(got, want))
            norm = max(float((torch.linalg.vector_norm(g, dim=-1) - 1)
                             .abs().max()) for g in got)
            if any(tuple(g.shape) != (L, dim) for g in got) or norm > 1e-3:
                problems.append(f"{label}: bad tables")
            return same, cos

        # (a) phase 5's model and tables, the sharded embed
        plain, plain_s = best(lambda: precompute_embeddings_from_video(
            server.model, server.video, W, S, L, **kw))
        reset_launch_counts()
        got, sharded_s = best(lambda: sharded_tables(server.model,
                                                     server.video))
        launches = launch_counts()["fused_conv1x1"] // 2
        same, cos = check_tables("(a)", got,
                                 (server.q_table, server.t_table), 2304)
        log(f"    (a) sharded_embed_from_video, both towers, L={L}: "
            f"{sharded_s:.3f} s against the unsharded embed's "
            f"{plain_s:.3f} s (best of 2 each); tables bit-identical to "
            f"phase 5's {same} (cosine min {cos:.6f}); fused_conv1x1 "
            f"launches {launches} an embed (phase 5: "
            f"{LAUNCHES_PER_BATCH * n_batches})")
        if not same:
            problems.append("(a) the sharded tables differ from phase 5's")
        if launches != LAUNCHES_PER_BATCH * n_batches:
            problems.append(f"(a) {launches} kernel launches an embed")
        out.update(embed_s=plain_s, sharded_embed_s=sharded_s,
                   launches=launches)
        del plain, got

        # (b) a server with the mesh
        t0 = time.perf_counter()
        srv = TextureServer.from_frames(cfg, video, float(fps),
                                        device="cuda", mesh=mesh)
        load_s = time.perf_counter() - t0
        res = srv.synthesize(seconds=10, seed=1)
        same_idx = np.array_equal(res["result"].indices, ref_indices)
        log(f"    (b) TextureServer.from_frames(mesh=...): {load_s:.2f} s "
            f"(init + sharded embed {srv.embed_s:.3f} s); a 10 s request "
            f"(seed 1): {len(res['result'].indices)} steps, the indices of "
            f"phase 5's {same_idx}")
        if not same_idx:
            problems.append("(b) the mesh server's indices differ")
        out.update(server_load_s=load_s, server_embed_s=srv.embed_s)
        del srv, res
        torch.cuda.empty_cache()

        # (c) the DP+TP train step against the unsharded one, phase 9 (b)
        tcfg = Config(enc_arch="slowfast", batch_size=TRAIN_BS,
                      n_negs=TRAIN_NEGS, seed=0).derive_geometry(fps)
        data = SegmentBatches(video, tcfg.window, tcfg.train_stride,
                              n_negs=tcfg.n_negs,
                              batch_size=tcfg.batch_size, seed=tcfg.seed,
                              drop_last=True)
        it = data.epoch(0)
        bats = [next(it) for _ in range(2)]

        def train(sharded):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            model = ContrastiveTextures("slowfast", 1, tcfg.temp,
                                        dtype=torch.bfloat16, norm="group",
                                        remat=True).cuda()
            step = (make_sharded_train_step(model, mesh, tcfg.img_size,
                                            True, tcfg.augment) if sharded
                    else make_train_step(model, tcfg.img_size, True,
                                         tcfg.augment))
            state = create_state(model, tcfg, len(data))
            init = {k: v.detach().clone() for k, v in state.params.items()}
            state, _ = step(state, bats[0], step_generator(0, 0))  # warm-up
            # the compared step starts from the initial state again
            state.load_params(init)
            state.load_momentum({k: torch.zeros_like(v)
                                 for k, v in init.items()})
            state.step = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, bats[1], step_generator(0, 1))
            loss = float(m["loss"])
            ms = (time.perf_counter() - t0) * 1e3
            params = {k: v.detach().float().cpu()
                      for k, v in state.params.items()}
            return (loss, ms, params,
                    torch.cuda.max_memory_allocated() / 2**30)

        p_loss, p_ms, p_params, p_gib = train(False)
        s_loss, s_ms, s_params, s_gib = train(True)
        num = sum(float((s_params[k] - v).double().pow(2).sum())
                  for k, v in p_params.items())
        den = sum(float(v.double().pow(2).sum()) for v in p_params.values())
        rel = (num / den) ** 0.5
        dloss = abs(s_loss - p_loss)
        log(f"    (c) make_sharded_train_step vs make_train_step, "
            f"SlowFast-R50 (norm=group, bf16 + fp32 master, remat) at -bs "
            f"{tcfg.batch_size} -negs {tcfg.n_negs}, a warm-up step, then "
            f"one step from the same initial state, batch and draws: loss "
            f"{s_loss!r} vs {p_loss!r} (|diff| {dloss:.3g}, tol "
            f"{PAR_LOSS_TOL:g}); parameters after it rel L2 {rel:.3g} (tol "
            f"{PAR_PARAM_TOL:g}); the timed step "
            f"{s_ms:.1f} ms vs {p_ms:.1f} ms; peak {s_gib:.2f} GiB vs "
            f"{p_gib:.2f} GiB")
        if dloss > PAR_LOSS_TOL or not rel <= PAR_PARAM_TOL:
            problems.append(f"(c) the sharded step differs: loss {dloss:.3g}"
                            f", parameters {rel:.3g}")
        out.update(train_ms=p_ms, sharded_train_ms=s_ms, train_gib=p_gib,
                   sharded_train_gib=s_gib, train_loss_diff=dloss,
                   train_param_rel_l2=rel)
        del p_params, s_params
        torch.cuda.empty_cache()

        # (e) phase 5d's -m 2 model and tables, the sharded embed
        m2_plain, m2_plain_s = best(lambda: precompute_embeddings_from_video(
            m2["model"], server.video, W, S, L, m2["examples"], **kw))
        got, m2_s = best(lambda: sharded_tables(m2["model"], server.video,
                                                m2["examples"]))
        same, cos = check_tables("(e)", got, m2["tables"], 2304 + 12288)
        log(f"    (e) -m 2 sharded_embed_from_video (VGGish on the source "
            f"examples): {m2_s:.3f} s against the unsharded {m2_plain_s:.3f}"
            f" s; tables bit-identical to phase 5d's {same} (cosine min "
            f"{cos:.6f}, tol {AUDIO_COS})")
        if not same and cos < AUDIO_COS:
            problems.append("(e) the -m 2 sharded tables differ")
        out.update(m2_embed_s=m2_plain_s, m2_sharded_embed_s=m2_s)
        del got, m2_plain
        torch.cuda.empty_cache()

        # (d) phase 7's classic chain, one sigma, sharded by row blocks
        ccfg = ClassicConfig()
        feats, _ = rgb_features(synthetic_video(CLASSIC_SECONDS, fps), "cuda")
        ckw = dict(filter_size=ccfg.filter_size, stride=1, p=ccfg.q_p,
                   alpha=ccfg.q_alpha, eps=ccfg.q_eps,
                   thresholding=ccfg.threshold)
        s0 = ccfg.sigmas[0]

        def sweeps_of(d1):
            return anticipated_future_cost(
                diagonal_filter_smooth(d1, ccfg.filter_size, 1), p=ccfg.q_p,
                alpha=ccfg.q_alpha, eps=ccfg.q_eps, return_sweeps=True)[1]

        def rel(a, b):
            return float(((a - b).abs() / b.amax(1, keepdim=True)).max())

        ref, ref_s = best(lambda: classic_transition_matrix(feats, s0, **ckw))
        (p3, sweeps), p3_s = best(lambda: classic_transition_matrix_sharded(
            feats, mesh, s0, return_sweeps=True, **ckw))
        # the same chain unsharded on the plain D1 (the sharded block's
        # arithmetic), whose P3_new the sharded one must equal bit for bit
        with fp32_exact():
            d1_plain = pairwise_l2_reference(feats)
        plain = threshold_rows(distance_to_transition_probs(
            anticipated_future_cost(
                diagonal_filter_smooth(d1_plain, ccfg.filter_size, 1),
                p=ccfg.q_p, alpha=ccfg.q_alpha, eps=ccfg.q_eps),
            s0)[0], ccfg.threshold)
        # and on an fp64 D1, the nearest to exact
        x64 = feats.double()
        sq64 = (x64 * x64).sum(1)
        d1_fp64 = (sq64[:, None] + sq64[None, :] - 2.0 * (x64 @ x64.t())
                   ).clamp_min(0.0)
        d1_fp64.fill_diagonal_(0.0)
        d1_fp64 = d1_fp64.sqrt().float()
        del x64
        plain_sweeps, kernel_sweeps, fp64_sweeps = (
            sweeps_of(d1_plain), sweeps_of(pairwise_l2(feats)),
            sweeps_of(d1_fp64))
        # phase 7's comparison: P3 before the threshold (thresholding=1)
        unthresholded = dict(ckw, thresholding=1.0)
        rel_p3 = rel(classic_transition_matrix_sharded(
            feats, mesh, s0, **unthresholded),
            classic_transition_matrix(feats, s0, **unthresholded))
        same = torch.equal(p3, plain)
        log(f"    (d) classic_transition_matrix_sharded at N={len(feats)}, "
            f"F={feats.shape[1]}, sigma {s0}: {p3_s:.3f} s against "
            f"classic_transition_matrix's {ref_s:.3f} s (best of 2 each); "
            f"P3_new bit-identical to the unsharded chain on the plain D1 "
            f"{same}, D3 sweeps {sweeps} vs its {plain_sweeps}; against "
            f"the kernel's chain: P3 (unthresholded, phase 7's comparison) "
            f"max |dP3| / row max {rel_p3:.3g} (tol {P3_RTOL:g}), P3_new "
            f"{rel(p3, ref):.3g}, D3 sweeps {sweeps} vs {kernel_sweeps}; "
            f"the chain on an fp64 D1: {fp64_sweeps} sweeps")
        if not same or sweeps != plain_sweeps or rel_p3 > P3_RTOL:
            problems.append(f"(d) the sharded chain differs: P3_new equal "
                            f"{same}, sweeps {sweeps} != {plain_sweeps}, "
                            f"P3 {rel_p3:.3g}")
        out.update(classic_s=ref_s, sharded_classic_s=p3_s, sweeps=sweeps,
                   kernel_sweeps=kernel_sweeps, fp64_sweeps=fp64_sweeps,
                   classic_p3_rel=rel_p3, classic_p3_new_rel=rel(p3, ref))
        del feats, ref, p3, d1_plain, plain, d1_fp64
    finally:
        shutdown()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"    phase 13: {out['seconds']:.1f} s ({nvidia_smi_line()})")
    if problems:
        raise AssertionError("parallel phase: " + "; ".join(problems))
    return out


if __name__ == "__main__":
    sys.exit(main())
