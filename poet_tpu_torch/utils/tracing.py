"""Spans and counts of the program's phases, on the profiler's clock.

`span(name, unit=None, **counts)` is a context manager around one phase of
the host's work (a request's upload, the darknet body's launches, an NMS
fixed point and its waits, a train step's backward). While a
`torch.profiler` session records, each span appends one record to a bounded
buffer:

    {"name", "start_ns", "end_ns", "parent", "unit", "counts"}

`start_ns` and `end_ns` are `time.time_ns()`, the wall clock that the
profiler's events carry, so a span can be laid over the trace's kernels
and idle gaps. `parent` is the index in `recorded()` of the span open
around it on the same thread (None at the top, or when the parent was
dropped); `unit` is the request or step the span belongs to (the parent's
when not given); `counts` are numbers measured inside the span
(`Span.add`), summed per key.

Recording is on exactly while a profiler session records
(`torch.autograd.profiler._is_profiler_enabled`): every trace carries the
spans, and an untraced call pays one global read and gets the shared
`NO_SPAN` back, which records nothing and is false. Nothing is recorded
while `torch.export` traces a program: the exported graph holds no span.
The buffer keeps the newest `CAPACITY` records; `dropped()` counts the
older ones it let go. `recorded()` returns the records, `clear()` empties
the buffer.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from collections import deque
from typing import Dict, List

import torch
from torch.autograd import profiler as _autograd_profiler

CAPACITY = 1 << 16

_buffer: deque = deque(maxlen=CAPACITY)
_seq = itertools.count()
_first_seq = 0          # the sequence number of the first record since clear()
_local = threading.local()


class Span:
    """One recorded span; also the record itself until `recorded()` copies
    it out."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "unit", "counts", "seq")

    def __init__(self, name: str, unit, counts: Dict[str, float]):
        self.name, self.unit, self.counts = name, unit, counts
        self.start_ns = self.end_ns = None
        self.parent = self.seq = None

    def __enter__(self) -> "Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if stack:
            self.parent = stack[-1].seq
            if self.unit is None:
                self.unit = stack[-1].unit
        self.seq = next(_seq)
        stack.append(self)
        _buffer.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        _local.stack.pop()
        return False

    def add(self, **counts: float) -> None:
        """Add `counts` to the span's own (summed per key)."""
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v


class _NoSpan:
    """The span of an untraced call: records nothing, false in a test."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def add(self, **counts: float) -> None:
        pass

    def __bool__(self) -> bool:
        return False


NO_SPAN = _NoSpan()


def span(name: str, unit=None, **counts: float):
    """A span of `name` (see the module's docstring): a recording `Span`
    while a profiler session records, else `NO_SPAN`."""
    if not _autograd_profiler._is_profiler_enabled or torch.compiler.is_exporting():
        return NO_SPAN
    return Span(name, unit, counts)


def traced(name: str):
    """Decorate a function (a module's `forward`, a detector's step) so that
    each call is a span of `name`."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def recorded() -> List[dict]:
    """The buffer's records, oldest first, each a new dict."""
    spans = list(_buffer)
    if not spans:
        return []
    first = spans[0].seq
    return [{"name": s.name, "start_ns": s.start_ns, "end_ns": s.end_ns,
             "parent": None if s.parent is None or s.parent < first else s.parent - first,
             "unit": s.unit, "counts": dict(s.counts)} for s in spans]


def dropped() -> int:
    """Records made since the last `clear()` that the buffer let go."""
    spans = list(_buffer)
    return spans[0].seq - _first_seq if spans else 0


def clear() -> None:
    """Empty the buffer (spans still open are kept out of it too)."""
    global _first_seq
    _buffer.clear()
    _first_seq = next(_seq) + 1
