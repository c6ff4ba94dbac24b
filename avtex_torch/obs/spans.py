"""Program spans: named host intervals of the port's own work, recorded in
memory while a ``torch.profiler`` runs.

``span(name, **attrs)`` marks a block (``with span("train.step", step=k):``).
``with span(name) as rec:`` gives None while nothing is recorded, else the
open record, whose ``rec.attrs`` may be filled in before the block ends:
the way to attach a value that costs something to read.

- With no profiler running it returns one shared no-op: nothing is
  recorded, and the clock is not read.
- While a profiler runs, in any thread of the process, each span appends
  one ``Span`` to a bounded ring on exit: its name, its start and end in
  ns on the profiler's clock (Kineto stamps its events in Unix ns, which
  ``time.time_ns()`` reads), its id, the id of the innermost span open on
  the same thread (``parent``), the thread, the id of the outermost span
  of that nesting (``root``: one request, such as one ``embed.video`` or
  one ``train.step``) and ``attrs``. Where the calling thread's own
  profiler state is on, the span also opens
  ``torch.profiler.record_function(name)``, so a trace keeps the range.
  A thread started outside the profiler (the prefetch thread) has its
  spans in the ring only: ``torch.profiler`` records nothing there.

No span reads a tensor or synchronises a device. ``collect(start_ns,
end_ns)`` returns the spans that lie wholly inside an interval, oldest
first; ``clear()`` empties the ring.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# Spans kept: a 30 s traced window of the benchmark records a few hundred.
RING_SIZE = 65536


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    root: int
    thread: int
    attrs: dict


class Ring:
    """The last ``size`` spans, appended from any thread."""

    def __init__(self, size: int = RING_SIZE):
        self._spans: "collections.deque[Span]" = collections.deque(
            maxlen=size)
        self._lock = threading.Lock()

    def append(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    def collect(self, start_ns: int, end_ns: int) -> List[Span]:
        with self._lock:
            spans = list(self._spans)
        return [s for s in spans
                if start_ns <= s.start_ns and s.end_ns <= end_ns]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


RING = Ring()
_ids = itertools.count(1)
_open = threading.local()  # .stack: this thread's open spans


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Recording:
    __slots__ = ("name", "attrs", "id", "parent", "root", "range",
                 "start_ns")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        outer = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if outer is None else outer.id
        self.root = self.id if outer is None else outer.root
        self.range = None
        if torch.autograd._profiler_enabled():  # this thread's state
            self.range = _autograd_profiler.record_function(self.name)
            self.range.__enter__()
        stack.append(self)
        # read inside the range, so the span lies within it
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        _open.stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        RING.append(Span(self.name, self.start_ns, end_ns, self.id,
                         self.parent, self.root, threading.get_ident(),
                         self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager marking one block of the program's work as
    ``name``; see the module's docstring."""
    if not _autograd_profiler._is_profiler_enabled:
        return NOOP
    return _Recording(name, attrs)


def collect(start_ns: int, end_ns: int) -> List[Span]:
    """The recorded spans wholly inside ``[start_ns, end_ns]``."""
    return RING.collect(start_ns, end_ns)


def clear() -> None:
    RING.clear()
