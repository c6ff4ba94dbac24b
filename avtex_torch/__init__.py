"""avtex_torch — the PyTorch/CUDA port of avtex for NVIDIA Hopper.

The JAX package ``avtex`` stays the reference; this package mirrors its
layout module for module (``avtex/synth/server.py`` ->
``avtex_torch/synth/server.py``) and imports nothing from it. Every Pallas
kernel on a ported path becomes a hand-written Hopper kernel under
``avtex_torch/csrc/``, built with ``nvcc`` at first use and bound through
``ctypes`` (``avtex_torch/ops/_build.py``).

Layout contract: public functions take and return channels-last
``[B, T, H, W, C]`` tensors, as ``avtex`` does; the encoder keeps its
activations in ``torch.channels_last_3d`` so the 1x1 kernel's ``[M, K]``
operand is a free view.

Device contract: entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU they raise instead of running on the CPU
(``avtex_torch.device.resolve_device``).

Ported so far: contrastive synthesis (``-m 1 -e``) with SlowFast-R50 (its
stems in space-to-depth form) or the 3D ResNets, served warm by
``avtex_torch.synth.TextureServer``, SuperSloMo at jumps from a found
checkpoint, avtex's checkpoint files (``avtex_torch.train``) and the
``-e`` CLI (``python -m avtex_torch.cli.main``); the classic Schödl
baseline with RGB features, modes 1-3
(``avtex_torch.classic.run_classic_frames``, ``python -m
avtex_torch.cli.classic_main``); multi-GPU on ``torch.distributed``
(``avtex_torch.parallel``: the mesh, the segment-sharded embed behind
``--mesh``, the DP+TP train step; the row-block-sharded classic chain).
"""

__version__ = "0.1.0"
