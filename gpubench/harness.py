"""What every driver shares: the harness's host spans and device
helpers."""

from __future__ import annotations

import collections
import contextlib
import time

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Spans:
    """The harness's own host spans around its calls into the program:
    seconds per call by name, and, in a traced run, a profiler range
    ``gpubench.<name>`` around each."""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.seconds = collections.defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        rng = (torch.profiler.record_function("gpubench." + name)
               if self.traced else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rng:
            yield
        self.seconds[name].append(time.perf_counter() - t0)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    import gc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def geometry(traffic: dict):
    """(window W, stride S) of a traffic mix's video: avtex's
    W = ceil(fps / 2), S = ceil(fps / 5)."""
    fps = traffic["video"]["fps"]
    return -(-fps // 2), -(-fps // 5)


def encoder_kwargs(config: dict) -> dict:
    """The port's encoder arguments for a configuration file: its depth
    and width, and whatever else it lists under ``encoder_kwargs``."""
    return dict(layers=tuple(config["layers"]), width=config["width"],
                **config["encoder_kwargs"])


def reference_towers(cell, norm: str, device):
    """The plain reference's two towers of a cell's configuration, with
    uninitialised weights on ``device`` ("meta" for their names and shapes
    alone)."""
    from gpubench import spec
    from gpubench.reference.towers import Towers
    module = spec.load_module("reference", cell.config_name)
    with torch.device(device):
        return Towers(module, cell.config, norm)
