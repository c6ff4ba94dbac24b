"""torch.profiler around a block (the port of avtex/obs/profiler.py)."""

from __future__ import annotations

import contextlib
import itertools
import os
from typing import Iterator, Optional

_counter = itertools.count()


@contextlib.contextmanager
def trace(logdir: Optional[str] = None, name: str = "avtex_torch"
          ) -> Iterator[None]:
    """Profile a block when ``logdir`` is given: ``torch.profiler`` with
    the CPU activity and, where a GPU is present, the CUDA activity, the
    block inside ``record_function(name)``; on exit a Chrome trace
    ``<logdir>/<name>.<pid>.<n>.pt.trace.json`` (Perfetto, TensorBoard's
    profiler plugin or ``chrome://tracing`` open it). With ``logdir=None``
    it does nothing, so call sites can leave it wired in."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        with record_function(name):
            yield
    prof.export_chrome_trace(os.path.join(
        logdir, f"{name}.{os.getpid()}.{next(_counter)}.pt.trace.json"))
