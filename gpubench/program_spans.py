"""The program's own spans (``avtex_torch.obs.spans``) read against the
traced window's device events.

While the harness's profiler runs, the program records its spans in
memory, on the profiler's clock (Unix ns), the prefetch thread's too,
which the profiler itself cannot see. ``window_spans(trace)`` returns
those that lie wholly inside the traced window; a program without the
span module gives None, and every reader built on it is then silent.

- ``device_ms(trace, spans, name)``: device ms of the operations whose
  launch lies inside a span named ``name`` (matched by correlation id, as
  ``TraceSummary.device_s_in_range`` does for profiler ranges);
- ``idle_ms(trace, spans, name)``: device idle ms while a span named
  ``name`` is open, cut by the spans' own intervals (a gap that starts in
  one span and ends in the next is split between them);
- ``count(spans, name)``: the spans of that name, the readers' divisor;
- ``idle_by_innermost(trace, spans, thread)``: idle ms by the innermost
  span open on one thread (``gpubench/span_report.py``'s breakdown).
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[int, int]


def window_spans(trace) -> Optional[list]:
    """The program's spans wholly inside ``trace.window``; None without a
    trace or without the program's span module."""
    if trace is None:
        return None
    try:
        from avtex_torch.obs import spans
    except ImportError:
        return None
    return spans.collect(*trace.window)


def named(spans, name: str) -> list:
    return [s for s in spans if s.name == name]


def count(spans, name: str) -> int:
    return len(named(spans, name))


def merged(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of ``intervals`` as sorted disjoint intervals."""
    out: List[List[int]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        elif end > start:
            out.append([start, end])
    return [tuple(i) for i in out]


def overlap_ns(a: Sequence[Interval], b: Sequence[Interval]) -> int:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_intervals(trace) -> List[Interval]:
    """The window's stretches with no device operation running."""
    w0, w1 = trace.window
    edges = [w0]
    for s, e in trace.busy_intervals():
        edges += [s, e]
    edges.append(w1)
    return [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]


def device_ms(trace, spans, name: str) -> float:
    """Device ms of the operations launched inside a span named ``name``."""
    inside = merged([(s.start_ns, s.end_ns) for s in named(spans, name)])
    starts = [s for s, _ in inside]
    total = 0
    for start, end, _, corr in trace.device:
        t = trace.launches.get(corr)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= inside[i][1]:
            total += end - start
    return total / 1e6


def idle_ms(trace, spans, name: str) -> float:
    """Device idle ms while a span named ``name`` is open."""
    inside = merged([(s.start_ns, s.end_ns) for s in named(spans, name)])
    return overlap_ns(idle_intervals(trace), inside) / 1e6


def innermost(spans, thread: int) -> List[Tuple[int, int, str]]:
    """One thread's timeline as sorted disjoint (start, end, name) pieces,
    each named by the innermost span open there (spans on one thread
    nest)."""
    mine = sorted((s for s in spans if s.thread == thread),
                  key=lambda s: (s.start_ns, -s.end_ns))
    pieces: List[Tuple[int, int, str]] = []
    stack: list = []
    t = 0

    def close_until(limit):
        nonlocal t
        while stack and stack[-1].end_ns <= limit:
            top = stack.pop()
            if top.end_ns > t:
                pieces.append((t, top.end_ns, top.name))
                t = top.end_ns

    for s in mine:
        close_until(s.start_ns)
        if stack and s.start_ns > t:
            pieces.append((t, s.start_ns, stack[-1].name))
        stack.append(s)
        t = s.start_ns
    close_until(float("inf"))
    return pieces


def idle_by_innermost(trace, spans, thread: int) -> Dict[str, float]:
    """Device idle ms in the window by the innermost span open on
    ``thread`` ("no span" outside them)."""
    idle = idle_intervals(trace)
    out: Dict[str, float] = collections.defaultdict(float)
    i = 0
    for start, end, name in innermost(spans, thread):
        while i < len(idle) and idle[i][1] <= start:
            i += 1
        j = i
        while j < len(idle) and idle[j][0] < end:
            out[name] += (min(end, idle[j][1]) - max(start, idle[j][0])) / 1e6
            j += 1
    out["no span"] = sum(e - s for s, e in idle) / 1e6 - sum(out.values())
    return dict(out)


def per_span_device_ms(ctx, name: str, per: str) -> Optional[float]:
    """Device ms launched inside spans ``name``, over the spans ``per``
    in the window; None where the trace or the spans are missing."""
    spans = window_spans(ctx.trace)
    if not spans or not ctx.trace.device:
        return None
    n = count(spans, per)
    if not n or not count(spans, name):
        return None
    return device_ms(ctx.trace, spans, name) / n
