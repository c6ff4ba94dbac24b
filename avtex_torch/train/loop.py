"""InfoNCE training loop (the port of avtex/train/loop.py): SGD with
momentum and weight decay, the staircase StepLR, early stop, exact
resume.

One step takes a uint8 batch from ``SegmentBatches``, uploads it,
augments and normalises it on the device, runs both towers, takes the
InfoNCE loss against column 0 and steps the optimizer, as avtex's jitted
step does.

- Optimizer: avtex chains ``optax.add_decayed_weights(wd)`` and
  ``optax.sgd(schedule, momentum)``: that is ``torch.optim.SGD(momentum,
  weight_decay, dampening=0, nesterov=False)`` on every parameter, norms
  and biases included. Before each step the LR is set to ``lr * 0.1 **
  floor(step / (steps_per_epoch * lr_steps))``, optax's staircase counted
  in steps, so a resumed run continues the schedule exactly.
- Precision: the model computes in its dtype (bf16 conv weights by
  default), while ``TrainState.params`` holds an fp32 master copy of
  every parameter, as flax keeps avtex's parameters in fp32 and casts
  them inside each op. The gradients of the compute-dtype weights, cast to
  fp32 (flax's gradient through the cast), step the master copy, which is
  then copied into the model. SGD on bf16 weights would drop every update
  smaller than about 2^-8 of the weight. Parameters that are fp32 in the
  model (the norms) are their own master.
- Randomness: the data order and negatives come from ``SegmentBatches``
  seeded by ``(seed, epoch)``; the augmentation draws of global step k
  from a CPU ``torch.Generator`` seeded from ``(seed + 1, k)`` (avtex's
  ``fold_in(key(seed + 1), k)``), so a resumed run replays the
  uninterrupted one and a run on the card draws what a CPU run draws.
- Checkpoints: avtex's file (``save_checkpoint``), holding the fp32
  master parameters and the optimizer state as avtex's trees.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from avtex_torch.checkpoints import maybe_load_vggish_into_model
from avtex_torch.config import Config
from avtex_torch.contrastive.infonce import info_nce_from_logits
from avtex_torch.contrastive.model import ContrastiveTextures
from avtex_torch.convert import (convert_opt_state, convert_params,
                                 export_opt_state, export_params)
from avtex_torch.data.pipeline import SegmentBatches, prefetch
from avtex_torch.data.preprocess import (apply_augment, draw_augment_params,
                                         preprocess_clip)
from avtex_torch.device import module_device, resolve_device
from avtex_torch.nn.slowfast import slowfast_pathways
from avtex_torch.obs import AverageMeter
from avtex_torch.obs.spans import span
from avtex_torch.synth.pipeline import _DTYPES, flax_style_init
from avtex_torch.utils.batching import row_chunks

from .checkpoint import restore_checkpoint, save_checkpoint


class TrainConfigError(ValueError):
    pass


@dataclasses.dataclass
class TrainState:
    """What a training run carries from step to step.

    ``model`` computes in its own dtype; ``params`` is the fp32 master
    copy by state_dict name (a model parameter that is already fp32 is
    its own master); ``optimizer`` steps ``params`` (SGD here, Adam in
    ``avtex_torch.contrastive.retrieval_train``); ``schedule(step)``
    gives the LR of step ``step``; ``step`` counts the steps taken."""

    model: torch.nn.Module
    params: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0

    def _pairs(self):
        for name, p in self.model.named_parameters():
            yield p, self.params[name]

    def apply_gradients(self, grad_hook: Optional[
            Callable[[List[torch.Tensor]], None]] = None) -> None:
        """One optimizer step of the master copy from the model's gradients,
        then the master copy into the model; clears the gradients.
        ``grad_hook`` gets the fp32 gradients of the master copy before the
        step and may change them in place (the data-parallel mean)."""
        for p, m in self._pairs():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            m.grad = g if m is p else g.float()
        if grad_hook is not None:
            grad_hook([m.grad for _, m in self._pairs()])
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        with torch.no_grad():
            for p, m in self._pairs():
                if m is not p:
                    p.copy_(m)
                p.grad = m.grad = None
        self.step += 1

    def load_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Set the master copy and the model from an fp32 state_dict."""
        with torch.no_grad():
            for name, m in self.params.items():
                m.copy_(params[name])
        self.model.load_state_dict(params)

    def momentum(self) -> Dict[str, torch.Tensor]:
        """The momentum buffer of every master parameter (zeros before the
        first step, as optax's trace starts)."""
        out = {}
        for name, m in self.params.items():
            buf = self.optimizer.state.get(m, {}).get("momentum_buffer")
            out[name] = torch.zeros_like(m) if buf is None else buf
        return out

    def load_momentum(self, momentum: Dict[str, torch.Tensor]) -> None:
        for name, m in self.params.items():
            self.optimizer.state[m]["momentum_buffer"] = (
                momentum[name].to(m.device, torch.float32).clone())

    def params_tree(self) -> Dict:
        """The master parameters as avtex's tree (``{"params": ...}``)."""
        return export_params(self.params)

    def opt_state_tree(self) -> Dict:
        """The optimizer state as avtex's optax tree."""
        return export_opt_state(self.momentum(), self.step)


# The step preprocesses its clips in chunks of at most this many elements
# of the fp32 [clips, T, size, size, 3] result (1 GiB), each cast to the
# encoder's dtype as it is made, so that no fp32 copy of the whole batch
# is ever live. Every op of the preprocessing acts clip by clip.
PREP_CHUNK_ELEMENTS = 2 ** 28


def _prep_pathways(frames: torch.Tensor,
                   draws: Optional[Dict[str, torch.Tensor]], size: int,
                   slowfast: bool, dtype: torch.dtype = torch.float32):
    """uint8 windows -> encoder input in ``dtype`` (a clip tensor or the
    slowfast tuple): augmented under ``draws`` (``draw_augment_params``),
    or preprocessed without augmentation when it is None; in chunks of
    clips (``PREP_CHUNK_ELEMENTS``)."""
    clip = frames[0].numel() // (frames.shape[2] * frames.shape[3]) * (
        size * size)
    outs = None
    for rows in row_chunks(len(frames), clip, PREP_CHUNK_ELEMENTS):
        if draws is not None:
            x = apply_augment(frames[rows], {k: v[rows] for k, v in
                                             draws.items()}, size, slowfast)
        else:
            x = preprocess_clip(frames[rows], size, slowfast)
        parts = slowfast_pathways(x) if slowfast else (x,)
        del x
        if outs is None:
            outs = tuple(torch.empty((len(frames),) + p.shape[1:],
                                     dtype=dtype, device=p.device)
                         for p in parts)
        for out, p in zip(outs, parts):
            out[rows] = p
        del parts
    return outs if slowfast else outs[0]


def _draws(n_all: int, rows: slice, frames: torch.Tensor, size: int,
           generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The augmentation draws of all ``n_all`` clips, cut to ``rows``: a
    clip's draws do not depend on how the batch is split."""
    h, w = frames.shape[2:4]
    return {k: v[rows] for k, v in draw_augment_params(
        n_all, h, w, size, generator).items()}


def step_generator(seed: int, global_step: int) -> torch.Generator:
    """The CPU generator of one step's augmentation draws, seeded from
    ``(seed + 1, global_step)``."""
    state = np.random.SeedSequence((seed + 1, global_step)).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def make_train_step(model: ContrastiveTextures, size: int, slowfast: bool,
                    augment: bool = True, *,
                    rows: Optional[Callable[[int], slice]] = None,
                    grad_hook: Optional[
                        Callable[[List[torch.Tensor]], None]] = None
                    ) -> Callable:
    """Build ``step(state, batch, generator) -> (state, metrics)``.

    ``batch`` is one of ``SegmentBatches``' numpy batches, uploaded here
    to the model's device; ``generator`` (a CPU ``torch.Generator``)
    draws the query clips' augmentation, then the targets'. ``augment=
    False`` trains with the reference's exact preprocessing (resize and
    normalise only). ``metrics`` holds the loss and the top-1 accuracy as
    0-d tensors on the device.

    For data parallelism (``avtex_torch.parallel.make_sharded_train_step``)
    ``rows(B)`` gives the slice of the batch's B rows this process trains
    on (the draws are made for all B rows and cut), and ``grad_hook`` goes
    to ``state.apply_gradients``.

    Memory: the clips are preprocessed in chunks straight into the
    encoder's dtype (``_prep_pathways``) and the uint8 upload is dropped,
    so the step holds one compute-dtype copy of the batch, never a whole
    fp32 one; the encoders' ``remat`` does the rest
    (avtex_torch/nn/resnet3d.py)."""

    # the encoders cast their input to their dtype first; the step casts
    # each preprocessed chunk instead, the same rounding
    in_dtype = getattr(model.q_embedder.video_encoder, "dtype",
                       torch.float32)

    def step(state: TrainState, batch: Dict, generator: torch.Generator):
        dev = module_device(model)
        b_all = len(batch["q_frames"])
        sel = slice(0, b_all) if rows is None else rows(b_all)

        def upload(key, dtype=None):
            if batch.get(key) is None:
                return None
            x = torch.from_numpy(np.ascontiguousarray(batch[key][sel]))
            return x.to(dev, dtype)

        with span("train.step") as rec:
            if rec is not None:  # a stand-in state may keep no count
                rec.attrs["step"] = getattr(state, "step", None)
            with span("train.upload"):
                q, t = upload("q_frames"), upload("t_frames")
                audio = [upload(k, torch.float32)
                         for k in ("q_audio", "t_audio")]
            b, n = t.shape[:2]
            t = t.reshape((-1,) + t.shape[2:])
            q_draws = t_draws = None
            if augment:
                with span("train.draws"):
                    q_draws = _draws(b_all, sel, q, size, generator)
                    t_draws = _draws(b_all * n,
                                     slice(sel.start * n, sel.stop * n),
                                     t, size, generator)
            with span("train.augment"):
                q_in = _prep_pathways(q, q_draws, size, slowfast, in_dtype)
                t_flat = _prep_pathways(t, t_draws, size, slowfast,
                                        in_dtype)
            del q, t
            if slowfast:
                t_in = tuple(p.reshape((b, n) + p.shape[1:]) for p in t_flat)
            else:
                t_in = t_flat.reshape((b, n) + t_flat.shape[1:])
            with span("train.forward"):
                logits = model(q_in, t_in, *audio)
                loss = info_nce_from_logits(logits)
                acc = (logits.argmax(dim=-1) == 0).float().mean()
            with span("train.backward"):
                loss.backward()
            with span("train.optimizer"):
                state.apply_gradients(grad_hook)
        return state, {"loss": loss.detach(), "acc": acc.detach()}

    return step


def make_lr_schedule(cfg: Config, steps_per_epoch: int
                     ) -> Callable[[int], float]:
    """StepLR(step_size=lr_steps, gamma=0.1) in steps: the LR falls by 10x
    every ``lr_steps`` epochs, as optax's staircase exponential decay
    (constant when ``steps_per_epoch * lr_steps`` is not positive)."""
    transition = steps_per_epoch * cfg.lr_steps

    def schedule(step: int) -> float:
        if transition <= 0:
            return cfg.lr
        return cfg.lr * 0.1 ** (step // transition)

    return schedule


def load_master_copy(model: torch.nn.Module,
                     params: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Load ``params`` (an fp32 state_dict) into ``model`` (already on its
    device) and return the fp32 master copy by parameter name: the
    model's own tensor where it is fp32, an fp32 clone of ``params``
    otherwise."""
    model.load_state_dict(params)
    return {name: p if p.dtype == torch.float32 else
            params[name].to(p.device, torch.float32).clone()
            for name, p in model.named_parameters()}


def create_state(model: ContrastiveTextures, cfg: Config,
                 steps_per_epoch: int,
                 params: Optional[Dict[str, torch.Tensor]] = None
                 ) -> TrainState:
    """The fp32 master copy and the SGD optimizer for ``model`` (already
    on its device), from ``params`` (an fp32 state_dict; None: the seeded
    flax-style init of ``cfg.seed``, with a found VGGish checkpoint
    grafted in for ``model_type=2``, as avtex's ``create_state``)."""
    if params is None:
        params = flax_style_init(model, cfg.seed)
        if cfg.model_type == 2:
            params, _ = maybe_load_vggish_into_model(
                params, context="model_type=2 training init")
    master = load_master_copy(model, params)
    optimizer = torch.optim.SGD(list(master.values()), lr=cfg.lr,
                                momentum=cfg.momentum, dampening=0.0,
                                weight_decay=cfg.weight_decay,
                                nesterov=False)
    return TrainState(model, master, optimizer,
                      make_lr_schedule(cfg, steps_per_epoch))


def train_video(cfg: Config, frames: np.ndarray,
                audio_examples: Optional[np.ndarray] = None,
                logger=None, epochs: Optional[int] = None,
                log_every: Optional[int] = None,
                resume: Optional[str] = None,
                ckpt_dir: Optional[str] = None,
                ckpt_name: Optional[str] = None,
                device=None) -> Tuple[TrainState, List[float]]:
    """Train the contrastive model on one video, on ``device`` (``cuda``
    unless given ``"cpu"``).

    Returns (final state, per-epoch mean losses). Early-stops when an
    epoch's loss is below ``cfg.early_stop_loss``. ``resume``: an avtex
    checkpoint to restore the parameters, the optimizer state, the epoch
    and the best loss from (a missing file raises). With ``ckpt_dir`` and
    ``ckpt_name``, saves ``_latest`` every epoch and copies it to
    ``_best`` on improvement. The model is ``norm="group"`` with its
    blocks checkpointed, in ``cfg.compute_dtype``.
    """
    if cfg.model_type == 2 and audio_examples is None:
        raise TrainConfigError("model_type=2 requires audio examples")
    if ckpt_dir and ckpt_name is None:
        raise TrainConfigError("ckpt_dir requires ckpt_name")
    dev = resolve_device(device)
    model = ContrastiveTextures(
        arch=cfg.enc_arch, model_type=cfg.model_type, temp=cfg.temp,
        dtype=_DTYPES[cfg.compute_dtype], norm="group", remat=True).to(dev)
    slowfast = cfg.enc_arch == "slowfast"
    train_stride = (cfg.train_stride if cfg.train_stride is not None
                    else cfg.stride)
    data = SegmentBatches(frames, cfg.window, train_stride,
                          n_negs=cfg.n_negs, batch_size=cfg.batch_size,
                          audio_examples=(audio_examples
                                          if cfg.model_type == 2 else None),
                          seed=cfg.seed)
    # a ragged tail batch is dropped whenever one full batch remains, as
    # avtex does to keep its step's shapes static
    data.drop_last = data.n_train >= data.batch_size
    state = create_state(model, cfg, len(data))

    start_epoch = cfg.start_epoch or 0
    best = float("inf")
    if resume:
        payload = restore_checkpoint(resume)
        if payload is None:
            # a typoed resume must not retrain from scratch over the files
            raise FileNotFoundError(f"No checkpoint found at '{resume}'")
        state.load_params(convert_params(payload["state"], model))
        if "opt_state" in payload:
            momentum, _ = convert_opt_state(payload["opt_state"], model)
            state.load_momentum(momentum)
            state.step = int(payload["step"])
        if cfg.start_epoch is None:  # an explicit start_epoch wins
            start_epoch = int(payload["epoch"])
        best = float(payload["best_loss"])

    step_fn = make_train_step(model, cfg.img_size, slowfast,
                              augment=cfg.augment)
    if log_every is None:
        log_every = cfg.log_freq
    history: List[float] = []
    n_epochs = epochs if epochs is not None else cfg.epochs
    global_step = start_epoch * len(data)
    model.train()
    for epoch in range(start_epoch, n_epochs):
        meter, batch_meter = AverageMeter(), AverageMeter()
        t0 = t_step = time.perf_counter()
        batches = prefetch(data.epoch(epoch), depth=max(2, cfg.workers))
        for epoch_i, batch in enumerate(batches):
            state, metrics = step_fn(state, batch,
                                     step_generator(cfg.seed, global_step))
            loss = float(metrics["loss"])
            meter.update(loss, len(batch["q_ids"]))
            batch_meter.update(time.perf_counter() - t_step)
            t_step = time.perf_counter()
            if epoch_i % cfg.print_freq == 0:
                print(f"Epoch: [{epoch}][{epoch_i}/{len(data)}]\t"
                      f"Time {batch_meter.val:.3f} ({batch_meter.avg:.3f})\t"
                      f"Loss {loss:.4f} ({meter.avg:.4f})")
            if logger is not None and global_step % log_every == 0:
                logger.log_scalar(loss, "train/iter_loss", global_step)
                logger.log_scalar(float(metrics["acc"]), "train/iter_acc",
                                  global_step)
                logger.log_video(batch["q_frames"][0], "train/query",
                                 global_step)
                logger.log_video(batch["t_frames"][0, 0], "train/positive",
                                 global_step)
            global_step += 1
        history.append(meter.avg)
        is_best = meter.avg < best
        best = min(best, meter.avg)
        if ckpt_dir:
            save_checkpoint(ckpt_dir, ckpt_name, state.params_tree(),
                            epoch + 1, cfg.enc_arch, best, is_best=is_best,
                            opt_state=state.opt_state_tree(),
                            step=state.step)
        if logger is not None:
            logger.log_scalar(meter.avg, "train/epoch_loss", epoch)
            logger.log_scalar(time.perf_counter() - t0, "train/epoch_time_s",
                              epoch)
        if meter.avg < cfg.early_stop_loss:
            break
    return state, history
