"""The training loop: avtex's trainer, one step after another.

Set-up makes one seeded video and the weights, builds the program's
model (group norm, checkpointed blocks) with its fp32 master copy and
SGD (``create_state``), its step (``make_train_step``) and its batches
(``SegmentBatches`` behind ``prefetch``), as ``train_video`` does. It
then drives that same state through the first ``check_steps`` steps with
the window's own call and feed; these steps warm up every shape. The
window goes on from there with the same objects. The check holds those
first steps against the plain fp32 reference: each step's loss, each
leaf's first gradient (worked out from the optimizer's momentum after
one step) and each leaf's change over the steps.
"""

from __future__ import annotations

import itertools
import time
from typing import Dict

import numpy as np
import torch

from gpubench import inputs
from gpubench.harness import (DTYPES, encoder_kwargs, free,
                              reference_towers, sync)
from gpubench.reference import common
from gpubench.reference import towers as ref_towers

# A leaf whose reference gradient is under this share of the median
# leaf's moves by round-off alone (a bias under a norm that removes it):
# it is left out of the comparison of changes.
STILL_LEAF = 1e-3
# the numbers ``compare`` can hold against a limit
NUMBERS = ("loss_gap", "grad_gap", "change_gap", "grad_gap_median",
           "change_gap_median")


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               keep=None) -> list:
    """Per leaf, |prog - ref| / max(ref, median of ref): the gap of the
    leaf's norms against the reference's norm of the leaf or of the median
    leaf, whichever is larger."""
    keys = [k for k in ref if keep is None or k in keep]
    med = common.median([ref[k] for k in keys])
    return [abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys]


class Driver:
    def __init__(self, cell, seed: int, device, spans, fault=None):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.spans, self.fault = spans, fault
        self.cfg, self.traffic = cell.config, cell.traffic
        t = self.traffic
        self.clips_per_step = t["batch_size"] * (2 + t["n_negs"])

    def reference_towers(self, device) -> ref_towers.Towers:
        return reference_towers(self.cell, self.cfg["norm"]["train"], device)

    def setup(self) -> None:
        from avtex_torch.config import Config
        from avtex_torch.contrastive.model import ContrastiveTextures
        from avtex_torch.data.pipeline import SegmentBatches, prefetch
        from avtex_torch.train.loop import (create_state, make_train_step,
                                            step_generator)
        t, v = self.traffic, self.traffic["video"]
        self.video = inputs.synthetic_video(self.seed, 0, v["seconds"],
                                            v["fps"], v["size"], self.device)
        shapes = ref_towers.param_shapes(self.reference_towers("meta"))
        self.weights = inputs.seeded_weights(shapes, self.seed, self.device)
        opt = t["optimizer"]
        cfg = Config(enc_arch=self.cfg["arch"], img_size=self.cfg["img_size"],
                     batch_size=t["batch_size"], n_negs=t["n_negs"],
                     temp=t["temp"], lr=opt["lr"], momentum=opt["momentum"],
                     weight_decay=opt["weight_decay"],
                     lr_steps=opt["lr_steps"], augment=t["augment"],
                     compute_dtype=self.cfg["compute_dtype"],
                     seed=self.seed).derive_geometry(v["fps"])
        with torch.device(self.device):
            model = ContrastiveTextures(
                arch=cfg.enc_arch, model_type=1, temp=cfg.temp,
                dtype=DTYPES[cfg.compute_dtype],
                norm=self.cfg["norm"]["train"], remat=True,
                **encoder_kwargs(self.cfg))
        data = SegmentBatches(self.video, cfg.window, cfg.train_stride,
                              n_negs=cfg.n_negs, batch_size=cfg.batch_size,
                              seed=cfg.seed)
        data.drop_last = data.n_train >= data.batch_size
        self.steps_per_epoch = len(data)
        self.state = create_state(model, cfg, len(data), params=self.weights)
        step = make_train_step(model, cfg.img_size, cfg.enc_arch == "slowfast",
                               augment=cfg.augment)
        self.batches = itertools.chain.from_iterable(
            prefetch(data.epoch(e), depth=max(2, cfg.workers))
            for e in itertools.count())
        self.global_step = 0
        self._plant(step)
        model.train()

        def run_step(batch):
            self.state, metrics = self.step_fn(
                self.state, batch, step_generator(self.seed, self.global_step))
            self.global_step += 1
            return float(metrics["loss"])

        self.run_step = run_step
        self.first_losses, self.window_losses = [], []
        wd = opt["weight_decay"]
        for k in range(t["check_steps"]):
            self.first_losses.append(run_step(next(self.batches)))
            if k == 0:
                mom = self.state.momentum()
                self.first_grads = common.leaf_norms(
                    {n: mom[n] - wd * self.weights[n] for n in mom})
        self.first_changes = common.leaf_norms(
            {n: p - self.weights[n] for n, p in self.state.params.items()})
        sync(self.device)

    def _plant(self, step) -> None:
        """The step as the program makes it, or with a planted fault."""
        self.step_fn = step
        if self.fault == "state_unchanged":
            def unchanged(state, batch, generator):
                params = {n: p.clone() for n, p in state.params.items()}
                state, metrics = step(state, batch, generator)
                state.load_params(params)
                state.optimizer.state.clear()
                return state, metrics
            self.step_fn = unchanged
        elif self.fault == "half_batch":
            def half(state, batch, generator):
                b = len(batch["q_frames"]) // 2
                return step(state, {k: v[:b] for k, v in batch.items()},
                            generator)
            self.step_fn = half
        elif self.fault not in (None, "control"):
            raise ValueError(f"unknown fault {self.fault!r}")

    # ---- window ----------------------------------------------------------- #

    def window(self, seconds: float) -> dict:
        losses = []
        t0 = time.perf_counter()
        with self.spans("window"):
            while True:
                with self.spans("batch_wait"):
                    batch = next(self.batches)
                with self.spans("step"):
                    losses.append(self.run_step(batch))
                if time.perf_counter() - t0 >= seconds:
                    break
            sync(self.device)
        elapsed = time.perf_counter() - t0
        steps = len(losses)
        self.window_losses = losses
        return {"elapsed_s": elapsed, "steps": steps, "attempted": steps,
                "failed": int(sum(not np.isfinite(x) for x in losses)),
                "clips": steps * self.clips_per_step}

    def end_to_end(self, work: dict) -> dict:
        return {"train_clips_per_s": work["clips"] / work["elapsed_s"]}

    # ---- check ------------------------------------------------------------ #

    def readings(self, control: bool = False) -> dict:
        """The first steps' losses, first gradients and changes, of the
        program (``program``) and the reference (``reference``), with
        ``control`` also of the reference computed in fp8 (``control``).
        Frees the program's state first."""
        leaves = list(self.state.params)
        self.state = self.step_fn = self.run_step = self.batches = None
        free(self.device)
        out = {"program": {"losses": self.first_losses,
                           "grad_norms": self.first_grads,
                           "change_norms": self.first_changes},
               "nonfinite": sum(not np.isfinite(x)
                                for x in self.window_losses)}
        for key, precision in (("reference", "fp32"),) + (
                (("control", "fp8"),) if control else ()):
            towers = ref_towers.load(self.reference_towers(self.device),
                                     self.weights)
            out[key] = ref_towers.train_steps(
                towers, self.video, self.traffic, self.seed,
                self.traffic["check_steps"], precision, self.device, leaves,
                self.steps_per_epoch)
            del towers
            free(self.device)
        return out

    def check(self, limits: dict) -> dict:
        """The first steps' numbers against ``limits``; with the fault
        "control", those of the reference computed in fp8 in the
        program's place."""
        control = self.fault == "control"
        r = self.readings(control=control)
        p = r["control"] if control else r["program"]
        return compare(p["losses"], p["grad_norms"], p["change_norms"],
                       r["reference"], limits, nonfinite=r["nonfinite"])


def compare(losses, grads, changes, ref: dict, limits: dict,
            nonfinite: int = 0) -> dict:
    """The training cell's numbers, each beside its limit, for the numbers
    ``limits`` names: ``loss_gap`` (the widest relative gap of a step's
    loss), ``grad_gap`` / ``change_gap`` (the worst leaf's gap of the first
    gradient's and of the change's norm) and ``grad_gap_median`` /
    ``change_gap_median`` (the median leaf's); always the non-finite
    losses, against 0. Leaves that the reference's first gradient leaves
    still (``STILL_LEAF``) are not in the changes."""
    med = common.median(ref["grad_norms"].values())
    moving = {k for k, g in ref["grad_norms"].items() if g >= STILL_LEAF * med}
    grad = _leaf_gaps(grads, ref["grad_norms"])
    change = _leaf_gaps(changes, ref["change_norms"], moving)
    numbers = {
        "loss_gap": max(abs(p - r) / abs(r)
                        for p, r in zip(losses, ref["losses"])),
        "grad_gap": max(grad), "change_gap": max(change),
        "grad_gap_median": common.median(grad),
        "change_gap_median": common.median(change)}
    out = {k: (numbers[k], lim) for k, lim in limits.items()}
    out["nonfinite_losses"] = (int(nonfinite) + sum(
        not np.isfinite(x) for x in losses), 0)
    return out
