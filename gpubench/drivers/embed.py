"""The embed loop: one client embeds fresh videos one after another.

Set-up makes the cell's pool of seeded videos and the weights of a served
model (norm scales and shifts drawn per channel, as a trained or BN-folded
model has them), builds the program's two-tower model in the
configuration's embed form and runs one job to warm up its shapes. The window runs
``precompute_embeddings_from_video`` on each video of the pool in turn
and waits for its tables, as a user waits before a first texture. The
check samples rows of the tables the window produced, draws from the
seed, and holds them against the plain fp32 reference.
"""

from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from gpubench import inputs
from gpubench.harness import (DTYPES, encoder_kwargs, free, geometry,
                              reference_towers, sync)
from gpubench.reference import towers as ref_towers

# Planted faults (tests and the control's readings only):
# "answer_altered" moves every fifth row of each query table off its
# answer by this much, then renormalises; "control" judges the reference
# computed in fp8 in the program's place.
ALTERED_ROW_SHIFT = 0.5


def _gap(rows: dict, ref: dict) -> float:
    """max over towers and rows of the L2 distance between unit rows."""
    return max(float(torch.linalg.vector_norm(
        rows[k].float() - ref[k], dim=-1).max()) for k in rows)


class Driver:
    def __init__(self, cell, seed: int, device, spans, fault=None):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.spans, self.fault = spans, fault
        self.cfg, self.traffic = cell.config, cell.traffic
        self.norm = self.cfg["norm"]["embed"]
        self.window_frames, self.stride = geometry(self.traffic)

    # ---- set-up ----------------------------------------------------------- #

    def reference_towers(self, device) -> ref_towers.Towers:
        return reference_towers(self.cell, self.norm, device)

    def setup(self) -> None:
        from avtex_torch.contrastive.model import ContrastiveTextures
        v = self.traffic["video"]
        self.videos = [inputs.synthetic_video(self.seed, i, v["seconds"],
                                              v["fps"], v["size"],
                                              self.device)
                       for i in range(v["pool"])]
        self.num_segments = ((len(self.videos[0]) - self.window_frames)
                             // self.stride)
        shapes = ref_towers.param_shapes(self.reference_towers("meta"))
        self.weights = inputs.seeded_weights(shapes, self.seed, self.device,
                                             served=True)
        with torch.device(self.device):
            model = ContrastiveTextures(
                arch=self.cfg["arch"], model_type=1,
                dtype=DTYPES[self.cfg["compute_dtype"]], norm=self.norm,
                **encoder_kwargs(self.cfg))
        model.load_state_dict(self.weights)
        self.model = model.eval()
        self.tables: List[Tuple[int, torch.Tensor, torch.Tensor]] = []
        self._job(0)
        sync(self.device)
        self.tables.clear()

    def _job(self, index: int) -> None:
        from avtex_torch.synth.embeddings import (
            precompute_embeddings_from_video)
        video = index % len(self.videos)
        q, t = precompute_embeddings_from_video(
            self.model, self.videos[video], self.window_frames, self.stride,
            self.num_segments, img_size=self.cfg["img_size"],
            batch_size=self.traffic["batch_size"])
        if self.fault == "answer_altered":
            q = q.clone()
            rows = q[::5]
            rows = rows + ALTERED_ROW_SHIFT * torch.roll(rows, 1, dims=-1)
            q[::5] = rows / torch.linalg.vector_norm(rows, dim=-1,
                                                     keepdim=True)
        self.tables.append((video, q, t))

    # ---- window ----------------------------------------------------------- #

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        with self.spans("window"):
            while True:
                with self.spans("job"):
                    self._job(len(self.tables))
                    sync(self.device)
                if time.perf_counter() - t0 >= seconds:
                    break
        elapsed = time.perf_counter() - t0
        jobs = len(self.tables)
        segments = jobs * self.num_segments
        return {"elapsed_s": elapsed, "videos": jobs, "segments": segments,
                "attempted": jobs, "clip_forwards": 2 * segments}

    def end_to_end(self, work: dict) -> dict:
        return {"embed_segments_per_s": work["segments"] / work["elapsed_s"]}

    # ---- check ------------------------------------------------------------ #

    def sample(self) -> List[Tuple[int, int]]:
        """(job, segment) pairs to check, drawn from the seed: the first
        job's first segment, the last job's last (a padded batch's edge)
        and ``check_rows - 2`` more."""
        jobs, L = len(self.tables), self.num_segments
        rng = np.random.default_rng([self.seed, 7])
        picks = {(0, 0), (jobs - 1, L - 1)}
        while len(picks) < min(self.traffic["check_rows"], jobs * L):
            picks.add((int(rng.integers(jobs)), int(rng.integers(L))))
        return sorted(picks)

    def readings(self, control: bool = False) -> dict:
        """The widest distance between a sampled table row and the
        reference's (``program``), the rows that are not finite, and with
        ``control`` the same distance of the reference computed in fp8
        (``control``). Frees the program's state first."""
        picks = self.sample()
        nonfinite = sum(int((~torch.isfinite(q)).any(dim=-1).sum()
                            + (~torch.isfinite(t)).any(dim=-1).sum())
                        for _, q, t in self.tables)
        prog = {"query": torch.stack([self.tables[j][1][s] for j, s in picks]),
                "target": torch.stack([self.tables[j][2][s] for j, s in picks])}
        videos = [self.tables[j][0] for j, _ in picks]
        # the program's state goes before the reference runs
        self.model = None
        self.tables.clear()
        free(self.device)
        ref = self.reference_rows(picks, videos, "fp32")
        out = {"program": _gap(prog, ref), "nonfinite": nonfinite}
        if control:
            out["control"] = _gap(self.reference_rows(picks, videos, "fp8"),
                                  ref)
        return out

    def check(self, limits: dict) -> dict:
        control = self.fault == "control"
        r = self.readings(control=control)
        gap = r["control"] if control else r["program"]
        return {"embed_gap": (gap, limits["embed_gap"]),
                "nonfinite_rows": (r["nonfinite"], 0)}

    def reference_rows(self, picks, videos, precision: str) -> dict:
        towers = ref_towers.load(self.reference_towers(self.device),
                                 self.weights)
        out = {"query": [], "target": []}
        for video in sorted(set(videos)):
            idx = [i for i, v in enumerate(videos) if v == video]
            starts = [picks[i][1] * self.stride for i in idx]
            rows = ref_towers.table_rows(
                towers, self.videos[video], starts, self.window_frames,
                self.cfg["img_size"], precision, self.device)
            for k in out:
                out[k].append((idx, rows[k]))
        n = len(picks)
        result = {}
        for k, parts in out.items():
            full = torch.empty((n, parts[0][1].shape[1]), device=self.device)
            for idx, rows in parts:
                full[torch.tensor(idx, device=self.device)] = rows
            result[k] = full
        return result
