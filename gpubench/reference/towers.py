"""The reference's two towers, its table rows and its training steps.

``Towers`` holds a query and a target encoder under the program's names
(``q_embedder.video_encoder.*``, ``t_embedder.video_encoder.*``), so the
weights one dict holds load into it as they load into the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from . import common


class Towers(nn.Module):
    def __init__(self, encoder_module, cfg: dict, kind: str):
        super().__init__()
        self.input_kind = encoder_module.INPUT_KIND
        self.cfg = cfg
        for tower in ("q", "t"):
            holder = nn.Module()
            holder.video_encoder = encoder_module.build(cfg, kind)
            self.add_module(f"{tower}_embedder", holder)

    def encoder(self, tower: str) -> nn.Module:
        return getattr(self, f"{tower[0]}_embedder").video_encoder

    def inputs(self, x: torch.Tensor):
        """Encoder input from preprocessed ``[B, T, size, size, 3]``."""
        if self.input_kind == "slowfast":
            return common.pathways(x, self.cfg["fast_frames"],
                                   self.cfg["alpha"])
        return x

    def embed(self, x, tower: str, precision: str, checkpoint=False):
        """Unit embeddings of preprocessed clips ``x``."""
        return common.unit(self.encoder(tower)(self.inputs(x), precision,
                                               checkpoint))


def param_shapes(towers: Towers):
    return [(n, tuple(p.shape)) for n, p in towers.named_parameters()]


def load(towers: Towers, weights: Dict[str, torch.Tensor]) -> Towers:
    towers.load_state_dict({k: v.float() for k, v in weights.items()})
    return towers


def table_rows(towers: Towers, video: np.ndarray, starts: Sequence[int],
               window: int, size: int, precision: str, device,
               block: int = 16) -> Dict[str, torch.Tensor]:
    """{"query", "target"}: unit rows ``[len(starts), D]`` of the
    segments starting at ``starts``, in blocks of ``block`` segments."""
    slowfast = towers.input_kind == "slowfast"
    out: Dict[str, List[torch.Tensor]] = {"query": [], "target": []}
    with torch.no_grad(), common.exact_fp32():
        for b0 in range(0, len(starts), block):
            frames = torch.from_numpy(common.windows(
                video, starts[b0:b0 + block], window)).to(device)
            x = common.preprocess(frames, size, slowfast)
            for tower in out:
                out[tower].append(towers.embed(x, tower, precision))
    return {k: torch.cat(v) for k, v in out.items()}


def train_steps(towers: Towers, video: np.ndarray, traffic: dict, seed: int,
                n_steps: int, precision: str, device,
                leaves: Sequence[str], steps_per_epoch: int) -> dict:
    """``n_steps`` of avtex's training step from the weights ``towers``
    holds: the sampler's batches and each step's augmentation draws
    worked out again, both towers, InfoNCE, the backward, SGD with
    momentum and weight decay, all in ``precision``. The batch runs in
    chunks of rows (``reference_rows_per_chunk``) whose gradients add up
    to the batch's, each encoder block checkpointed.

    Returns the step losses, the per-leaf norm of the first gradient and
    of each leaf's change over the steps (``leaves`` by name)."""
    cfg = towers.cfg
    size = cfg["img_size"]
    slowfast = towers.input_kind == "slowfast"
    fps = traffic["video"]["fps"]
    window, stride = -(-fps // 2), -(-fps // 5)
    bs, negs = traffic["batch_size"], traffic["n_negs"]
    opt = traffic["optimizer"]
    chunk = traffic["reference_rows_per_chunk"]
    params = dict(towers.named_parameters())
    start = {k: params[k].detach().clone() for k in leaves}
    momentum: Dict[str, torch.Tensor] = {}
    batches = common.train_batches(len(video), window, stride, bs, negs,
                                   seed)
    starts = np.arange(common.num_train_segments(len(video), window,
                                                 stride) + 1) * stride
    losses, grad_norms = [], None
    with common.exact_fp32():
        for step in range(n_steps):
            ids, t_ids = next(batches)
            g = common.step_generator(seed, step)
            h, w = video.shape[1:3]
            q_draws = common.draw_augment(bs, h, w, size, g)
            t_draws = common.draw_augment(bs * (1 + negs), h, w, size, g)
            for p in params.values():
                p.grad = None
            total = 0.0
            for r0 in range(0, bs, chunk):
                rows = slice(r0, min(bs, r0 + chunk))
                n = rows.stop - rows.start
                q = torch.from_numpy(common.windows(
                    video, starts[ids[rows]], window)).to(device)
                t = torch.from_numpy(common.windows(
                    video, starts[t_ids[rows].reshape(-1)], window)).to(device)
                tr = slice(rows.start * (1 + negs), rows.stop * (1 + negs))
                qx = common.augment(q, {k: v[rows] for k, v in
                                        q_draws.items()}, size, slowfast)
                tx = common.augment(t, {k: v[tr] for k, v in
                                        t_draws.items()}, size, slowfast)
                del q, t
                qe = towers.embed(qx, "query", precision, checkpoint=True)
                te = towers.embed(tx, "target", precision, checkpoint=True)
                loss = common.info_nce(qe, te.view(n, 1 + negs, -1),
                                       traffic["temp"]).sum() / bs
                loss.backward()
                total += float(loss.detach())
                del qx, tx, qe, te, loss
            grads = {k: (p.grad if p.grad is not None
                         else torch.zeros_like(p)) for k, p in params.items()}
            if grad_norms is None:
                grad_norms = common.leaf_norms({k: grads[k] for k in leaves})
            lr = common.lr_at(step, opt["lr"], steps_per_epoch,
                              opt["lr_steps"])
            common.sgd_step({k: p.data for k, p in params.items()}, grads,
                            momentum, lr, opt["momentum"],
                            opt["weight_decay"])
            losses.append(total)
    change = common.leaf_norms({k: params[k].detach() - start[k]
                                for k in leaves})
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
