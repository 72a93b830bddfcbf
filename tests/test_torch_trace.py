"""The port's tracer (`lmono_tpu_torch/utils/timing.py`) on the CPU.

* Off, `span` hands back one shared no-op object, and an untraced
  `SlamSystem.process` reads no clock of the tracer's, opens no
  `record_function` and records nothing.
* A traced run and an untraced one give bitwise equal poses.
* Each traced frame's span tree nests: every child inside its parent, the
  children together no longer than the parent; a full-window frame holds
  the layers' spans.
* Every read the system and the estimator count in `readbacks` waits
  inside a `read` span, and there are as many as they count.
* Under a CPU `torch.profiler` an untraced system traces the frame; with
  `ranges` each span's `record_function` event, placed by the profile's
  `trace_start_ns`, lies inside the tracer's own [t0, t1] within 1 ms, and
  without them the profile holds no span's range.
* The buffer stays bounded over 200 frames with no reader.

The drive is `test_torch_system.py`'s out-and-back at its small widths
(16 frames: the window fills at frame 5, a closure is reaped at frame 15,
the map flushes every 4 frames).
"""

import dataclasses
import functools
import time
from types import SimpleNamespace

import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_system import TCFG, _drive
from torch_estimator_cases import one_torch_thread  # noqa: F401

from lmono_tpu_torch import pipeline
from lmono_tpu_torch.estimator import estimator, solver
from lmono_tpu_torch.loop.posegraph import PoseGraph
from lmono_tpu_torch.pipeline import SlamSystem
from lmono_tpu_torch.utils import timing

CFG = TCFG.replace(mapping=dataclasses.replace(TCFG.mapping, flush_every=4))
END = 16
_SCAN = ("points", "ranges", "valid")


def _system(trace: bool) -> SlamSystem:
    s = SlamSystem(CFG, device="cpu", generator=torch.Generator().manual_seed(3),
                   trace=trace)
    s._graph_cap = 4
    s.graph = PoseGraph.empty(4, s.graph.loop_mask.shape[0], "cpu")
    return s


def _run(s: SlamSystem, frames: list) -> tuple[list, list]:
    """Per-frame (pose t, q, raw t, raw q) and the estimator's read counts."""
    front, est_reads = s.front.process, []

    def counted(*args, **kwargs):
        out = front(*args, **kwargs)
        est_reads.append(out["readbacks"])
        return out

    s.front.process = counted
    poses = []
    for i, f in enumerate(frames):
        o = s.process({k: f[k] for k in _SCAN}, f["image"], time=i * 0.1)
        poses.append((o["pose"].t, o["pose"].q, o["pose_raw"].t, o["pose_raw"].q))
    s.front.process = front
    return poses, est_reads


def _watch_counted_reads(seen: list):
    """Route the reads that `readbacks` counts (the system's `_read`, the
    estimator's keyframe flag, the LM's done flag) through a fetch that
    notes the innermost open span and the tracer's clock as it waits; the
    returned callable undoes it."""
    mods = (pipeline, estimator, solver)
    real = [m.read for m in mods]

    def watched(fetch, *args):
        def fetched(*a):
            tr = timing._active
            seen.append((tr._stack[-1], tr.now()) if tr is not None and tr._stack
                        else None)
            return fetch(*a)
        return timing.read(fetched, *args)

    for m in mods:
        m.read = watched
    return lambda: [setattr(m, "read", r) for m, r in zip(mods, real)]


@functools.lru_cache(maxsize=None)
def _runs() -> SimpleNamespace:
    """The untraced and the traced run over the same frames, then one more
    frame of the untraced system under a CPU profiler with ranges, and one
    of the traced system under a CPU profiler without."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        chunks, _ = _drive()
        frames = [{k: v[i] for k, v in c.items()} for c in chunks
                  for i in range(c["points"].shape[0])]
        plain = _system(False)
        calls = {"clock": 0, "record_function": 0}

        def counting(name, fn):
            def f(*args, **kwargs):
                calls[name] += 1
                return fn(*args, **kwargs)
            return f

        clock, rf = timing.time, timing._profiler.record_function
        timing.time = SimpleNamespace(
            perf_counter_ns=counting("clock", time.perf_counter_ns),
            time_ns=counting("clock", time.time_ns))
        timing._profiler.record_function = counting("record_function", rf)
        try:
            plain_poses, _ = _run(plain, frames[:END])
        finally:
            timing.time, timing._profiler.record_function = clock, rf
        plain_records = len(plain.tracer.spans)

        traced, reads = _system(True), []
        undo = _watch_counted_reads(reads)
        try:
            traced_poses, est_reads = _run(traced, frames[:END])
        finally:
            undo()
        traced_spans, traced_reads = list(traced.tracer.spans), traced.readbacks

        f = frames[END]
        plain.tracer.ranges = True
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            plain.process({k: f[k] for k in _SCAN}, f["image"], time=END * 0.1)
        with profile(activities=[ProfilerActivity.CPU]) as bare:
            traced.process({k: f[k] for k in _SCAN}, f["image"], time=END * 0.1)
        return SimpleNamespace(
            calls=calls, plain_records=plain_records, plain_poses=plain_poses,
            traced=traced, traced_spans=traced_spans, traced_reads=traced_reads,
            traced_poses=traced_poses, est_reads=est_reads, reads=reads,
            profiled=plain.tracer.frame_records(), prof=prof, bare=bare)
    finally:
        torch.set_num_threads(n)


def test_off_span_is_the_shared_noop():
    assert timing._active is None
    assert timing.span("a") is timing.span("b") is timing._NOOP
    with timing.span("a") as s:
        assert s is timing._NOOP
    assert timing.read(int, 3) == 3


def test_untraced_process_records_nothing():
    r = _runs()
    assert r.calls == {"clock": 0, "record_function": 0}
    assert r.plain_records == 0


def test_traced_poses_equal_untraced_bitwise():
    r = _runs()
    assert len(r.plain_poses) == len(r.traced_poses) == END
    for i, (a, b) in enumerate(zip(r.plain_poses, r.traced_poses)):
        for x, y in zip(a, b):
            assert torch.equal(x, y), i


def test_span_tree_nests():
    r = _runs()
    spans = r.traced_spans
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.name == "frame"]
    assert [s.frame for s in roots] == list(range(END))
    assert all(s.parent == -1 for s in roots)
    for s in spans:
        assert s.t0 <= s.t1
        if s.parent != -1:
            p = by_id[s.parent]
            assert p.t0 <= s.t0 and s.t1 <= p.t1, (s, p)
            assert p.frame == s.frame
    kids: dict = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    for pid, ch in kids.items():
        if pid != -1:
            assert sum(c.t1 - c.t0 for c in ch) <= by_id[pid].t1 - by_id[pid].t0
    # a full-window keyframe: every layer of the estimator's path is spanned
    names = {}
    for s in spans:
        names.setdefault(s.frame, set()).add(s.name)
    full = [f for f, n in names.items() if "marginalization" in n]
    assert full, names
    want = {"frame", "odometry", "tracker", "window_solve", "window_solve.jacobian",
            "marginalization", "map", "read"}
    assert want <= names[full[0]], names[full[0]]
    assert any("reap" in n and "pose_graph.solve" in n and "reap.read" in n
               for n in names.values()), names
    assert any("loop_lane.detect" in n for n in names.values())
    top = {s.name for s in spans if s.parent in {r.id for r in roots}}
    assert top <= {"reap", "odometry", "tracker", "window_solve", "marginalization",
                   "loop_lane", "map", "read"}, top


def test_every_readback_is_inside_a_read_span():
    r = _runs()
    by_id = {s.id: s for s in r.traced_spans}
    assert r.reads and None not in r.reads
    for sid, t in r.reads:
        s = by_id[sid]
        assert s.name == "read" and s.t0 <= t <= s.t1
    assert len(r.reads) == r.traced_reads + sum(r.est_reads)


def test_record_functions_on_the_tracer_clock():
    r = _runs()
    spans = r.profiled
    assert spans and spans[-1].name == "frame" and spans[-1].frame == END
    start = r.prof.profiler.kineto_results.trace_start_ns()
    names = {s.name for s in spans}
    events: dict = {}
    for e in r.prof.events():
        if e.name in names:
            events.setdefault(e.name, []).append(
                (start + int(e.time_range.start * 1e3), start + int(e.time_range.end * 1e3)))
    tol = 1_000_000
    for name in names:
        mine = sorted((s.t0, s.t1) for s in spans if s.name == name)
        theirs = sorted(events.get(name, []))
        assert len(mine) == len(theirs), name
        for (t0, t1), (a, b) in zip(mine, theirs):
            assert t0 - tol <= a and b <= t1 + tol, (name, a - t0, b - t1)


def test_no_ranges_without_the_ranges_flag():
    r = _runs()
    spans = r.traced.tracer.frame_records()
    assert spans and spans[-1].name == "frame" and spans[-1].frame == END
    names = {s.name for s in spans}
    assert not [e.name for e in r.bare.events() if e.name in names]


def test_buffers_stay_bounded_without_a_reader():
    tr = timing.Tracer(capacity=64, recent=16)
    for f in range(200):
        with timing.tracing(tr, f, "frame"):
            for name in ("odometry", "tracker", "window_solve"):
                with timing.span(name):
                    timing.read(int, 1)
    assert timing._active is None
    assert len(tr.spans) == 64
    assert tr.spans[-1].name == "frame" and tr.spans[-1].frame == 199
    s = tr.summary()
    assert s["frame"]["count"] == 200 and s["read"]["count"] == 600
    assert all(len(v[2]) <= 16 for v in tr._totals.values())
