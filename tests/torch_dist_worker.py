"""Multi-process CPU worlds for the port's parallel tests (gloo).

The parent side, ``run_world(tmp, world, jobs)``, starts ``world``
processes of this file, one per rank, and returns each job's result per
rank. A rank process imports torch and avtex_torch only (never jax or
avtex: tests/conftest.py gives the pytest process JAX's eight virtual
devices), joins a gloo world through a ``FileStore`` under ``tmp`` (no
TCP port, so several pytest workers can run worlds at once), runs the
jobs in order and pickles what each returns. A world that does not end
within its time limit is killed, and the ranks' output is raised.

    python tests/torch_dist_worker.py STORE WORLD RANK JOBS OUT

A job is ``(case, kwargs)``: ``case`` names a function below, called on
every rank as ``case(**kwargs)``; it returns numpy arrays, numbers or
strings.
"""

from __future__ import annotations

import os
import pathlib
import pickle
import subprocess
import sys
import time
from datetime import timedelta

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]


def run_world(tmp, world: int, jobs, timeout: float = 240.0):
    """Run ``jobs`` in a gloo world of ``world`` processes; returns
    ``results[job][rank]``."""
    tmp = pathlib.Path(tmp) / f"world{world}_{time.monotonic_ns()}"
    tmp.mkdir(parents=True)
    with open(tmp / "jobs.pkl", "wb") as f:
        pickle.dump(jobs, f)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    logs = [tmp / f"rank{rank}.log" for rank in range(world)]
    procs = []
    for rank, log in enumerate(logs):
        with open(log, "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, str(tmp / "store"), str(world),
                 str(rank), str(tmp / "jobs.pkl"), str(tmp)],
                cwd=REPO, env=env, stdout=out, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            break
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        text = "\n".join(f"--- rank {r} (rc {p.returncode}) ---\n"
                         + log.read_text()[-3000:]
                         for r, (p, log) in enumerate(zip(procs, logs)))
        raise AssertionError(f"world of {world}: ranks {failed} failed "
                             f"(time limit {timeout} s)\n{text}")
    out = []
    for j in range(len(jobs)):
        ranks = []
        for r in range(world):
            with open(tmp / f"{j}.{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        out.append(ranks)
    return out


# ------------------------------------------------------------------ #
# Rank side: only torch and avtex_torch below
# ------------------------------------------------------------------ #

def _np(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return x


def _model(model_kw, params):
    import torch
    from avtex_torch.contrastive.model import ContrastiveTextures
    kw = dict(model_kw)
    kw["dtype"] = getattr(torch, kw.get("dtype", "float32"))
    model = ContrastiveTextures(**kw)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return model.eval()


def mesh_info(shape):
    import torch
    from avtex_torch.parallel import make_mesh, replicate, shard_leading
    mesh = make_mesh(shape, device="cpu")
    rank = torch.distributed.get_rank()
    return {"data": (mesh["data"].size(), mesh.get_local_rank("data")),
            "model": (mesh["model"].size(), mesh.get_local_rank("model")),
            "leading": shard_leading(mesh, np.arange(8)),
            "replicated": _np(replicate(mesh, torch.full((3,), rank)))}


def mesh_error(shape):
    from avtex_torch.parallel import make_mesh
    try:
        make_mesh(shape, device="cpu")
    except ValueError as e:
        return str(e)
    return None


def shard_round_trip(shape, model_kw, params):
    from avtex_torch.parallel import (gather_params, make_mesh,
                                      param_shardings, shard_params)
    import torch
    mesh = make_mesh(shape, device="cpu")
    full = {k: torch.from_numpy(v) for k, v in params.items()}
    local = shard_params(full, mesh)
    back = gather_params(local, mesh)
    return {"dims": param_shardings(full, mesh),
            "local_shapes": {k: tuple(v.shape) for k, v in local.items()},
            "round_trip": all(torch.equal(back[k], full[k]) for k in full)}


def embed(shape, model_kw, params, tower, img_size, batch_size,
          windows=None, video=None, window=None, stride=None,
          num_segments=None, audio=None):
    from avtex_torch.parallel import (make_mesh, sharded_embed_from_video,
                                      sharded_embed_segments)
    model = _model(model_kw, params)
    mesh = make_mesh(shape, device="cpu")
    kw = dict(tower=tower, img_size=img_size, batch_size=batch_size)
    if windows is not None:
        table = sharded_embed_segments(model, mesh, windows, audio, **kw)
    else:
        table = sharded_embed_from_video(model, mesh, video, window, stride,
                                         num_segments, audio, **kw)
    return _np(table)


def video_for_audio(shape, examples):
    """VideoForAudio's audio embedding (VGGish + AudioMLP, torch's default
    init under seed 0, fp32) with its layers parallelized over ``shape``
    (None: unsharded)."""
    import torch
    from avtex_torch.contrastive.audio_retrieval import VideoForAudio
    from avtex_torch.parallel import make_mesh, parallelize
    torch.manual_seed(0)
    vfa = VideoForAudio("resnet10", dtype=torch.float32)
    if shape is not None:
        parallelize(vfa, make_mesh(shape, device="cpu"))
    with torch.inference_mode():
        return _np(vfa.embed_audio(torch.from_numpy(examples)))


def train(shape, model_kw, params, cfg_kw, batches, augment):
    """Steps of make_sharded_train_step on ``batches``: per step the loss
    and acc, then the gathered fp32 master parameters."""
    import torch
    from avtex_torch.config import Config
    from avtex_torch.parallel import (gather_params, make_mesh,
                                      make_sharded_train_step, shard_params)
    from avtex_torch.train import create_state
    from avtex_torch.train.loop import step_generator
    model = _model(model_kw, params).train()
    mesh = make_mesh(shape, device="cpu")
    cfg = Config(**cfg_kw)
    step = make_sharded_train_step(model, mesh, cfg.img_size,
                                   model.arch == "slowfast", augment)
    full = {k: torch.from_numpy(v) for k, v in params.items()}
    state = create_state(model, cfg, len(batches), shard_params(full, mesh))
    losses, accs = [], []
    for i, batch in enumerate(batches):
        state, metrics = step(state, batch, step_generator(cfg.seed, i))
        losses.append(float(metrics["loss"]))
        accs.append(float(metrics["acc"]))
    params = gather_params(state.params, mesh)
    return {"loss": losses, "acc": accs,
            "params": {k: _np(v) for k, v in params.items()}}


def train_bad_batch(shape, model_kw, params, cfg_kw, batch):
    from avtex_torch.config import Config
    from avtex_torch.parallel import make_mesh, make_sharded_train_step
    from avtex_torch.train import create_state
    import torch
    model = _model(model_kw, params).train()
    mesh = make_mesh(shape, device="cpu")
    cfg = Config(**cfg_kw)
    step = make_sharded_train_step(model, mesh, cfg.img_size, False)
    full = {k: torch.from_numpy(v) for k, v in params.items()}
    state = create_state(model, cfg, 1, full)
    try:
        step(state, batch, torch.Generator())
    except ValueError as e:
        return str(e)
    return None


def classic(shape, feats, kwargs):
    from avtex_torch.classic import classic_transition_matrix_sharded
    from avtex_torch.parallel import make_mesh
    mesh = make_mesh(shape, device="cpu")
    p3, sweeps = classic_transition_matrix_sharded(
        feats, mesh, return_sweeps=True, **kwargs)
    return {"p3": _np(p3), "sweeps": sweeps}


def _main(store, world, rank, jobs_path, out):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    world, rank = int(world), int(rank)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=timedelta(seconds=120))
    try:
        with open(jobs_path, "rb") as f:
            jobs = pickle.load(f)
        for j, (case, kwargs) in enumerate(jobs):
            result = globals()[case](**kwargs)
            with open(os.path.join(out, f"{j}.{rank}.pkl"), "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(*sys.argv[1:])
