"""Parallelism on ``torch.distributed`` (the port of avtex/parallel/):
a data x model ``DeviceMesh``, the segment-sharded embed and the DP+TP
train step.

- ``data`` axis: batch sharding for training and segment-axis sharding
  for the embed-once pass (each rank embeds its block, the table is
  all-gathered).
- ``model`` axis: tensor parallelism for the audio path's widest layers
  (the shared VGGish's 512-channel conv pair, the ``AudioMLP``).

On one host: ``torchrun --nproc_per_node=N`` starts one process per GPU;
without torchrun ``make_mesh`` starts a one-process world.
"""

from .mesh import make_mesh, replicate, shard_leading, shutdown
from .sharded import (gather_params, make_sharded_train_step,
                      param_shardings, parallelize, shard_params,
                      sharded_embed_from_video, sharded_embed_segments)

__all__ = ["make_mesh", "replicate", "shard_leading", "shutdown",
           "param_shardings", "shard_params", "gather_params",
           "parallelize", "sharded_embed_segments",
           "sharded_embed_from_video", "make_sharded_train_step"]
