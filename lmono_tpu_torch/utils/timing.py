"""The port's tracer: host spans of the running system, on the torch
profiler's clock (reference `TicToc` + times_recorder.txt parity:
`include/utils/TicToc.h:38-61`, `Estimator.cc:374-377,647-648`).

The work is spanned where it happens: `span(name)` is called inside the
port's layers and does nothing unless a `Tracer` is active (`tracing`).
Inactive, `span` hands back one shared no-op object: no clock read, no
allocation, no `record_function`.

An active tracer records each span's name, frame index, id, parent id and
start and end in ns on the unix-epoch clock that `torch.profiler` stamps
its events with (`trace_start_ns()` + an event's offset): durations come
from `perf_counter_ns`, mapped through one (epoch, perf_counter) anchor
pair taken when the tracer is made.  A tracer made with `ranges` also
opens `torch.profiler.record_function(name)` for each span while a torch
profiler is recording, so a profile that records CPU activity shows the
spans (torch does not tell which activities the running profiler records,
and one without CPU activity keeps no range).  Records go into a bounded
buffer (`spans`): the oldest go first when no reader takes them
(`frame_records`); `summary()` gives the totals by span name.

`read(fetch, *args)` is the port's one way to wait for the device: every
device→host read on `SlamSystem.process`'s path goes through it, inside a
`read` span.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import NamedTuple

import torch.autograd.profiler as _profiler


class SpanRecord(NamedTuple):
    name: str
    frame: int       # the tracer's frame index when the span opened
    id: int
    parent: int      # id of the enclosing span, -1 at the top
    t0: int          # ns, unix-epoch clock (the profiler's)
    t1: int


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoSpan()
_active: "Tracer | None" = None


def profiling() -> bool:
    """Whether a torch profiler is recording."""
    return _profiler._is_profiler_enabled


class _Span:
    __slots__ = ("tracer", "name", "id", "parent", "t0", "rf")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        tr = self.tracer
        self.id = tr._next_id
        tr._next_id += 1
        self.parent = tr._stack[-1] if tr._stack else -1
        tr._stack.append(self.id)
        # the profiler's range opens after t0 and closes before t1, so the
        # span holds its own marker
        self.t0 = time.perf_counter_ns()
        self.rf = None
        if tr.ranges and _profiler._is_profiler_enabled:
            self.rf = _profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        t1 = time.perf_counter_ns()
        tr = self.tracer
        tr._stack.pop()
        off = tr._epoch0 - tr._perf0
        tr.spans.append(SpanRecord(self.name, tr.frame, self.id, self.parent,
                                   self.t0 + off, t1 + off))
        tot = tr._totals.get(self.name)
        if tot is None:
            tot = tr._totals[self.name] = [0, 0, deque(maxlen=tr.recent)]
        tot[0] += t1 - self.t0
        tot[1] += 1
        tot[2].append(t1 - self.t0)
        return False


class Tracer:
    """Spans and counts of the code run while it is active (`tracing`).

    capacity: span records kept (the oldest go first); recent: durations
    per span name kept for the medians of `summary()`; ranges: open a
    profiler range per span while a torch profiler records.  `frame` is
    the caller's frame index, stamped on every record."""

    def __init__(self, capacity: int = 1 << 16, recent: int = 4096,
                 ranges: bool = False):
        self.spans: deque = deque(maxlen=capacity)
        self.recent = recent
        self.ranges = ranges
        self.frame = -1
        self._stack: list = []
        self._next_id = 0
        self._totals: dict = {}      # name → [total ns, count, recent ns]
        self._epoch0 = time.time_ns()
        self._perf0 = time.perf_counter_ns()

    def now(self) -> int:
        """The current time in ns on the tracer's (the profiler's) clock."""
        return time.perf_counter_ns() + self._epoch0 - self._perf0

    def frame_records(self) -> list:
        """The newest frame's span records, in the order they closed; the
        buffer keeps them."""
        if not self.spans:
            return []
        f = self.spans[-1].frame
        spans = []
        for r in reversed(self.spans):
            if r.frame != f:
                break
            spans.append(r)
        return spans[::-1]

    def summary(self) -> dict:
        """By span name: total_s, count, mean_ms and median_ms (of the
        newest `recent` spans of that name: the median separates the steady
        state from the first calls' one-off costs)."""
        out = {}
        for name, (total, n, recent) in self._totals.items():
            s = sorted(recent)
            out[name] = {"total_s": total * 1e-9, "count": n,
                         "mean_ms": total * 1e-6 / n,
                         "median_ms": s[len(s) // 2] * 1e-6}
        return out


@contextlib.contextmanager
def tracing(tracer: Tracer, frame: int | None = None, root: str | None = None):
    """Make `tracer` the active one for the block, with its frame index set
    to `frame` and the block inside a span `root` (when given); the tracer
    active before comes back after it."""
    global _active
    before = _active
    _active = tracer
    if frame is not None:
        tracer.frame = frame
    try:
        if root is None:
            yield tracer
        else:
            with _Span(tracer, root):
                yield tracer
    finally:
        _active = before


def span(name: str):
    """A span of the active tracer, or the shared no-op without one."""
    tr = _active
    return _NOOP if tr is None else _Span(tr, name)


def read(fetch, *args):
    """`fetch(*args)`, a read that waits for the device, inside a `read`
    span."""
    tr = _active
    if tr is None:
        return fetch(*args)
    with _Span(tr, "read"):
        return fetch(*args)
