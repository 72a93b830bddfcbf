"""The port's own spans, read from its tracer
(`lmono_tpu_torch/utils/timing.py`) over the profiled frames of a
`--trace 1` run.

`SlamSystem` traces a frame while a torch profiler records, so the frames
the harness profiles carry the port's span tree.  A reader names `record`
under its `CALLS` on `SlamSystem.process`: after each profiled frame it
takes that frame's span records, as plain tuples (name, frame, id, parent,
t0 ns, t1 ns).  A port without a tracer gives nothing, and the reader
returns None.
"""

from __future__ import annotations

TARGET = "lmono_tpu_torch.pipeline:SlamSystem.process"
NAME, FRAME, ID, PARENT, T0, T1 = range(6)


def record(args, kwargs, out):
    """The span records of the frame `process` has just run, or None."""
    read = getattr(getattr(args[0], "tracer", None), "frame_records", None)
    if read is None:
        return None
    return [tuple(r) for r in read()]


def frames(calls) -> list:
    """The traced frames' record lists (each holding its `frame` span)."""
    return [recs for recs in calls or []
            if recs and any(r[NAME] == "frame" for r in recs)]


def ms(recs, name: str) -> float:
    """Host ms of one frame inside spans called `name`."""
    return sum(r[T1] - r[T0] for r in recs if r[NAME] == name) * 1e-6


def unspanned_ms(recs) -> float:
    """Host ms of one frame outside every direct child of its `frame` span."""
    root = next(r for r in recs if r[NAME] == "frame")
    kids = sorted((r[T0], r[T1]) for r in recs if r[PARENT] == root[ID])
    covered, end = 0, root[T0]
    for a, b in kids:
        a, b = max(a, end), min(b, root[T1])
        if b > a:
            covered += b - a
            end = b
    return (root[T1] - root[T0] - covered) * 1e-6


def per_frame(calls, fn):
    """The mean of fn(records) over the traced frames, None without any."""
    fr = frames(calls)
    return sum(fn(r) for r in fr) / len(fr) if fr else None
