"""The traced run: ``torch.profiler`` over the window, read in memory.

The profiler's events never go to disk: ``TraceSummary`` takes the
device's kernels, copies and sets, the host's named ranges and the
runtime's launch calls straight from the profiler's results. From them:

- ``busy_s``: the union of every device operation's time in the window;
- ``device_ops``: device seconds by kind of operation;
- ``idle_gaps``: the device's idle seconds by the harness span that was
  open on the host when each gap began;
- ``device_s_in_range(name)``: device seconds of the operations launched
  inside a named host range (by the launch's correlation id).

``CallRecorder`` wraps one function of the program, wherever the
program's modules hold it, and records the shapes of its calls: the
harness's own record of what it handed a kernel.
"""

from __future__ import annotations

import bisect
import collections
import sys
from typing import Callable, Dict, List, Optional, Tuple

import torch

# Kinds of device kernels, by a lower-case part of their names, first
# match wins.
KERNEL_KINDS = (
    ("fused_conv1x1", ("fused_conv1x1",)),
    ("conv fp32 NCHW xmma", ("nchw",)),
    ("convolution", ("conv", "xmma", "cudnn", "implicit", "wgrad", "dgrad",
                     "fprop", "sm90_", "sm80_")),
    ("group norm", ("group_norm", "groupnorm")),
    ("max pool", ("max_pool", "maxpool")),
    ("matmul", ("gemm", "cutlass")),
    ("optimizer", ("multi_tensor", "foreach")),
    ("elementwise and copies", ("elementwise", "vectorized", "copy",
                                "reduce", "unrolled", "cat", "index",
                                "where", "scatter", "gather")),
)
SPAN_PREFIX = "gpubench."


def kernel_kind(name: str) -> str:
    low = name.lower()
    if "memcpy" in low:
        return ("memcpy HtoD" if "htod" in low else "memcpy DtoH"
                if "dtoh" in low else "memcpy DtoD")
    if "memset" in low:
        return "memset"
    for kind, parts in KERNEL_KINDS:
        if any(p in low for p in parts):
            # "xmma" kernels outside NCHW layouts are ordinary convs
            if kind == "conv fp32 NCHW xmma" and "xmma" not in low:
                continue
            return kind
    return "other"


def _activity(e, on_device: bool) -> str:
    """The kineto activity of an event: its own ``activity_type`` where
    torch gives it, else worked out from ``is_user_annotation`` and the
    name (runtime and driver calls start with ``cu``)."""
    act = getattr(e, "activity_type", None)
    if act is not None:
        return str(act())
    annotation = getattr(e, "is_user_annotation", None)
    if annotation is not None and annotation():
        return "gpu_user_annotation" if on_device else "user_annotation"
    name = e.name()
    if on_device:
        low = name.lower()
        return ("gpu_memcpy" if "memcpy" in low else
                "gpu_memset" if "memset" in low else "kernel")
    if name.startswith("cu"):
        return "cuda_runtime"
    return "user_annotation" if name.startswith(SPAN_PREFIX) else "cpu_op"


class TraceSummary:
    """The window's events, in ns on the profiler's clock."""

    def __init__(self, events, window: Tuple[int, int]):
        self.window = window
        self.window_s = (window[1] - window[0]) / 1e9
        self.device: List[Tuple[int, int, str, int]] = []  # start, end, name, corr
        self.ranges: List[Tuple[int, int, str]] = []       # host ranges
        self.launches: Dict[int, int] = {}                 # corr -> start
        w0, w1 = window
        host = []
        for e in events:
            start, end = e.start_ns(), e.end_ns()
            if end < w0 or start > w1:
                continue
            on_device = e.device_type() == torch.autograd.DeviceType.CUDA
            act = _activity(e, on_device)
            if on_device and act in ("kernel", "gpu_memcpy", "gpu_memset"):
                self.device.append((start, end, e.name(), e.correlation_id()))
            elif not on_device and act == "user_annotation":
                self.ranges.append((start, end, e.name()))
            elif not on_device and act in ("cuda_runtime", "cuda_driver"):
                self.launches[e.correlation_id()] = start
            elif not on_device:
                host.append((start, end, e.name()))
        # a host range mirrored on the device timeline is a range, not an
        # operation (where torch does not mark annotations as such)
        mirrored = {d[2] for d in self.device} & (
            {n for _, _, n in host} | {n for _, _, n in self.ranges})
        self.ranges += [h for h in host if h[2] in mirrored]
        self.device = [d for d in self.device if d[2] not in mirrored]
        self.device.sort()
        self.ranges.sort()

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        w0, w1 = self.window
        for start, end, _, _ in self.device:
            start, end = max(start, w0), min(end, w1)
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            elif end > start:
                merged.append([start, end])
        return [tuple(m) for m in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def device_ops(self) -> Dict[str, float]:
        out: Dict[str, float] = collections.defaultdict(float)
        for start, end, name, _ in self.device:
            out[kernel_kind(name)] += (end - start) / 1e9
        return dict(out)

    def device_s(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """(seconds, count) of the device operations whose name matches."""
        sel = [(e - s) for s, e, n, _ in self.device if match(n)]
        return sum(sel) / 1e9, len(sel)

    def device_s_in_range(self, range_name: str) -> Optional[float]:
        """Device seconds of the operations whose launch lies inside a
        host range named ``range_name``; None without such a range."""
        spans = [(s, e) for s, e, n in self.ranges if n == range_name]
        if not spans:
            return None
        starts = [s for s, _ in spans]
        total = 0
        for start, end, _, corr in self.device:
            t = self.launches.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                total += end - start
        return total / 1e9

    def idle_gaps(self) -> Dict[str, float]:
        """Idle device seconds in the window by the innermost harness span
        open on the host when the gap began ("no span" outside them)."""
        spans = [(s, e, n[len(SPAN_PREFIX):]) for s, e, n in self.ranges
                 if n.startswith(SPAN_PREFIX)]
        out: Dict[str, float] = collections.defaultdict(float)
        w0, w1 = self.window
        edges = [w0]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(w1)
        for gap_start, gap_end in zip(edges[0::2], edges[1::2]):
            if gap_end <= gap_start:
                continue
            open_spans = [(e - s, n) for s, e, n in spans
                          if s <= gap_start < e]
            name = min(open_spans)[1] if open_spans else "no span"
            out[name] += (gap_end - gap_start) / 1e9
        return dict(out)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.device_ops().items(), key=lambda kv: -kv[1])
        gaps = sorted(self.idle_gaps().items(), key=lambda kv: -kv[1])
        return {"device_ops": [[k, v] for k, v in ops[:top]],
                "idle_gaps": [[k, v] for k, v in gaps[:top]]}


class Tracer:
    """``torch.profiler`` (host and CUDA activity) while entered; its
    results stay in memory."""

    def __init__(self, cuda: bool):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        self.prof = profile(activities=acts)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)

    def summary(self) -> Optional[TraceSummary]:
        """The events inside the harness's ``window`` span (the last one
        traced); None when the trace holds no such span."""
        events = self.prof.profiler.kineto_results.events()
        host = torch.autograd.DeviceType.CPU
        marks = [(e.start_ns(), e.end_ns()) for e in events
                 if e.name() == SPAN_PREFIX + "window"
                 and e.device_type() == host]
        return TraceSummary(events, marks[-1]) if marks else None


class CallRecorder:
    """Records ``shape(*args, **kwargs)`` of every call of the function
    ``attr`` of module ``module``, wherever a loaded ``avtex_torch``
    module holds that function, while entered."""

    def __init__(self, module: str, attr: str, shape: Callable):
        self.module, self.attr, self.shape = module, attr, shape
        self.calls: List = []
        self._patched: List = []

    def __enter__(self):
        import importlib
        original = getattr(importlib.import_module(self.module), self.attr)

        def wrapper(*args, **kwargs):
            self.calls.append(self.shape(*args, **kwargs))
            return original(*args, **kwargs)

        for name, mod in list(sys.modules.items()):
            if (name.split(".")[0] == "avtex_torch"
                    and getattr(mod, self.attr, None) is original):
                setattr(mod, self.attr, wrapper)
                self._patched.append((mod, original))
        return self

    def __exit__(self, *exc):
        for mod, original in self._patched:
            setattr(mod, self.attr, original)
        self._patched.clear()
