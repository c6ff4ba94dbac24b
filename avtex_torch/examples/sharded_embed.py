"""The segment-sharded embed over a ``make_mesh`` mesh.

The port's counterpart of avtex's ``examples/sharded_embed.py``. Every
rank holds the uint8 video; the segment starts are sharded over the
mesh's ``data`` axis, so each rank gathers, preprocesses and embeds its
block of L/n segments on its device, and the blocks are all-gathered
into the ``[L, D]`` table on every rank. The table is checked against
the unsharded embed. The same ``("data", "model")`` mesh drives the
DP+TP train step (``avtex_torch.parallel.make_sharded_train_step``).
With ``out_dir`` the first rank writes the table as ``table.npy``.

One process on one GPU:
    python -m avtex_torch.examples.sharded_embed
A GPU per process (NCCL), or processes on the CPU (gloo), which stand in
for avtex's 8 virtual CPU devices:
    torchrun --nproc_per_node 2 -m avtex_torch.examples.sharded_embed \\
        --device cpu
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch.distributed as dist

from avtex_torch.contrastive.model import ContrastiveTextures
from avtex_torch.contrastive.segments import num_segments
from avtex_torch.parallel.mesh import (is_first_rank, make_mesh, rank_device,
                                       shutdown)
from avtex_torch.parallel.sharded import sharded_embed_from_video
from avtex_torch.synth.embeddings import embed_segments_from_video
from avtex_torch.synth.pipeline import flax_style_init

from ._common import loop_clip, run_cli

T, RES, W, S = 64, 16, 4, 2


def main(device=None, out_dir: Optional[str] = None) -> Dict:
    """Embed the clip sharded and unsharded on this rank; returns both
    tables (numpy) and the world size. Ends a world it started."""
    mesh = make_mesh(device=device)  # (data, model) = (world size, 1)
    try:
        n, dev = dist.get_world_size(), rank_device(mesh)
        first = is_first_rank(mesh)
        if first:
            print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
                  f"{dev.type}")
        video = loop_clip(T, RES, RES, period=16)  # the decoded uint8 buffer
        L = num_segments(T, W, S)
        model = ContrastiveTextures(arch="resnet10", model_type=1)
        model.load_state_dict(flax_style_init(model, 0))
        model = model.to(dev).eval()

        table = sharded_embed_from_video(model, mesh, video, W, S, L,
                                         img_size=RES).float().cpu().numpy()
        # cross-check against the single-device path
        ref = embed_segments_from_video(model, video, W, S, L,
                                        img_size=RES).float().cpu().numpy()
        np.testing.assert_allclose(table, ref, atol=2e-2, rtol=2e-2)
        if first:
            print(f"sharded table: {table.shape} ({L} segments over {n} "
                  f"processes)")
            print("matches the unsharded embed")
            if out_dir is not None:
                os.makedirs(out_dir, exist_ok=True)
                np.save(os.path.join(out_dir, "table.npy"), table)
        return {"table": table, "unsharded": ref, "world_size": n}
    finally:
        shutdown()


if __name__ == "__main__":
    run_cli(main, __doc__, "avtex_torch_sharded_embed_")
