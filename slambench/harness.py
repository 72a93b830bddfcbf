"""One run of one cell: set-up, the measured window, the per-layer readings
and the judgement of `correct`.

The window drives `lmono_tpu_torch.pipeline.SlamSystem.process(scan, image)`
frame by frame, closed loop with one frame outstanding: each call ends when
that frame's pose is on the host, and the next starts then.  Frames come in
order from the drive staged on the device at set-up (`traffic/drive.py`);
the port receives only the sweep {points, ranges, valid} and the image.

What the judge needs is taken from the timed path itself by wrapping the
port's functions from outside (the laser pose, the tracks, the hand-eye's
relative rotations with their inputs, the map merge of a few frames drawn
from the seed, a few marginalizations drawn from the seed with the rows
they eliminate, the loop edges, every pose-graph solve with a copy of the
graph it was handed) and holding references to what they returned.  Inside
the window only the copies of the graph and the residuals of the drawn
marginalizations are extra work.  A `--trace 1` run adds host spans around
the layers the cell's metrics name, counts the kernel calls they name, and
profiles `trace_frames` window frames on the device.
"""

from __future__ import annotations

import ast
import contextlib
import hashlib
import importlib
import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path

import torch

from slambench import reference
from slambench.manifest import HERE, Cell
from slambench.traffic import lens
from slambench.traffic.drive import Drive

SCAN = ("points", "ranges", "valid")
FORBIDDEN = {"jax", "jaxlib", "flax", "lmono_tpu"}
PORT = "lmono_tpu_torch"
REFERENCE_FILES = ("reference.py", "steps.py", "traffic/sim.py", "traffic/drive.py",
                   "traffic/figure8.py", "traffic/lens.py")
CLOSURE_CHECKS = ("closure_deg", "graph_excess")   # limits that make a cell close loops
GRAPH_FIELDS = ("t", "ypr", "seq_dt", "seq_dyaw", "seq_mask", "loop_i", "loop_j",
                "loop_dt", "loop_dyaw", "loop_mask", "loop_w", "n_nodes")


class Patches(contextlib.ExitStack):
    """Wrap functions of the port for the length of a run, restoring each
    on exit.  A target is "module:attr.path"."""

    def wrap(self, target: str, make):
        mod_name, path = target.split(":")
        owner = importlib.import_module(mod_name)
        *parents, name = path.split(".")
        for part in parents:
            owner = getattr(owner, part)
        original = owner.__dict__[name] if name in vars(owner) else getattr(owner, name)
        setattr(owner, name, make(original))
        self.callback(setattr, owner, name, original)


class Recorder:
    """What the timed path answered, by window position (-1: the frame
    before the window), and the host spans of a traced run."""

    def __init__(self):
        self.frame = None          # window position being processed
        self.front = {}
        self.tracks = {}
        self.handeye = {}
        self.handeye_steps = {}
        self.maps = {}
        self.loops = []
        self.map_frames = set()
        self.relpose = []          # window calls: (x0, x1, mask, gumbel, q, ok)
        self.margs = []            # drawn marginalizations, see steps.marg_schur
        self.marg_seen = 0
        self.marg_pick = set()
        self.marg_rows = None      # the drawn call's (J, r) while it runs
        self.solves = []           # pose-graph solves: {"g", "t", "ypr"}
        self.spans = {}            # label → [seconds] in the window
        self.span_log = []         # (label, t0, t1) while profiling
        self.calls = {}            # metric call key → [records] while profiling
        self.profiling = False


def _span(rec: Recorder, label: str):
    def make(fn):
        def spanned(*args, **kwargs):
            if rec.frame is None or rec.frame < 0:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                t1 = time.perf_counter()
                rec.spans.setdefault(label, []).append(t1 - t0)
                if rec.profiling:
                    rec.span_log.append((label, t0, t1))
        return spanned
    return make


def _counted(rec: Recorder, key: str, record):
    def make(fn):
        def counted(*args, **kwargs):
            out = fn(*args, **kwargs)
            if rec.profiling:
                rec.calls.setdefault(key, []).append(record(args, kwargs, out))
            return out
        return counted
    return make


def _install_captures(p: Patches, rec: Recorder, system, seen_at) -> None:
    """The judge's answers, held by reference as the timed path makes them."""
    front = system.front.process

    def front_process(*args, **kwargs):
        out = front(*args, **kwargs)
        if rec.frame is not None:
            rec.front[rec.frame] = out
        return out

    system.front.process = front_process

    def tracker(fn):
        def step(*args, **kwargs):
            state, out = fn(*args, **kwargs)
            if rec.frame is not None:
                rec.tracks[rec.frame] = out
            return state, out
        return step

    def rel_pose(fn):
        def rp(x0, x1, mask, gumbel):
            q, ok = fn(x0, x1, mask, gumbel)
            if rec.frame is not None:
                rec.handeye[rec.frame] = (q, ok)
                if rec.frame >= 0:
                    rec.relpose.append((x0, x1, mask, gumbel, q, ok))
            return q, ok
        return rp

    def marg(fn):
        def marginalized(state, cfg, axis=None):
            window = rec.frame is not None and rec.frame >= 0
            pick = window and rec.marg_seen in rec.marg_pick
            rec.marg_seen += int(window)
            rec.marg_rows = [] if pick else None
            try:
                out = fn(state, cfg, axis=axis)
            finally:
                rows, rec.marg_rows = rec.marg_rows, None
            if pick:
                # the rows of the reprojection factors, then of the pose
                # factors; anything else leaves the reference nothing to
                # follow, and the reading fails
                m = {"w1": state.w1, "J": out.J, "r0": out.r0}
                if len(rows) == 2:
                    (m["J_rep"], m["r_rep"]), (m["J_pose"], m["r_pose"]) = rows
                rec.margs.append(m)
            return out
        return marginalized

    def jacobian(fn):
        def jac(f, consts, d0):
            J = fn(f, consts, d0)
            if rec.marg_rows is not None:
                rec.marg_rows.append((J, f(d0, *consts)))
            return J
        return jac

    def solve(fn):
        def solved(g, *args, **kwargs):
            out = fn(g, *args, **kwargs)
            if rec.frame is not None and rec.frame >= 0:
                rec.solves.append({"g": {k: getattr(g, k).clone() for k in GRAPH_FIELDS},
                                   "t": out.t.clone(), "ypr": out.ypr.clone()})
            return out
        return solved

    def he_update(fn):
        def update(st, q_cam, q_las, pair_ok):
            out = fn(st, q_cam, q_las, pair_ok)
            if rec.frame is not None and rec.frame >= 0:
                rec.handeye_steps[rec.frame] = (st, q_cam, q_las, pair_ok, out)
            return out
        return update

    def build(fn):
        def build_frame(*args, **kwargs):
            out = fn(*args, **kwargs)
            if rec.frame in rec.map_frames:
                T_WC = args[4]
                rec.maps.setdefault(rec.frame, {}).update(
                    pts_w=out[0], keep=out[2], depth=out[3], dmask=out[4],
                    T_WC=(T_WC.t, T_WC.q))
            return out
        return build_frame

    def merge(fn):
        def merged(cm, pts, cols, mask, voxel, axis=None):
            out = fn(cm, pts, cols, mask, voxel, axis=axis)
            if rec.frame in rec.map_frames:
                rec.maps.setdefault(rec.frame, {}).update(
                    bank_in=tuple(cm), new=(pts, cols, mask), bank_out=tuple(out))
            return out
        return merged

    def add_loop(fn):
        def added(g, i, j, rel, k, weight=5.0):
            if rec.frame is not None and rec.frame >= 0:
                rec.loops.append((i, j, rel.t, seen_at(i), seen_at(j), rel.q))
            return fn(g, i, j, rel, k, weight=weight)
        return added

    p.wrap("lmono_tpu_torch.fused:tracker_step", tracker)
    p.wrap("lmono_tpu_torch.estimator.estimator:relative_pose_from_tracks", rel_pose)
    p.wrap("lmono_tpu_torch.estimator.estimator:handeye_update", he_update)
    p.wrap("lmono_tpu_torch.mapping.builder:build_frame", build)
    p.wrap("lmono_tpu_torch.mapping.builder:colormap_update_hash", merge)
    p.wrap("lmono_tpu_torch.pipeline:graph_add_loop", add_loop)
    p.wrap("lmono_tpu_torch.estimator.estimator:marginalize_oldest", marg)
    p.wrap("lmono_tpu_torch.estimator.factors:jacobian", jacobian)
    p.wrap("lmono_tpu_torch.pipeline:optimize_posegraph", solve)


def _port_key(root: Path, cell: Cell) -> str:
    """Hash of the port's sources, the configuration and the history's
    traffic: the name of the history checkpoint."""
    h = hashlib.sha256()
    for f in sorted((root / PORT).rglob("*")):
        if f.suffix in (".py", ".cu", ".cpp", ".npz") and "build" not in f.parts:
            h.update(str(f.relative_to(root)).encode())
            h.update(f.read_bytes())
    h.update(json.dumps(cell.config["system"], sort_keys=True).encode())
    h.update(json.dumps(cell.traffic, sort_keys=True).encode())
    drive_files = ["sim.py"]
    if cell.traffic["generator"] == "figure8":
        drive_files.append("figure8.py")
    if lens.lens_of(cell.config["system"]["camera"]) is not None:
        drive_files.append("lens.py")
    for name in drive_files:
        h.update((HERE / "traffic" / name).read_bytes())
    return h.hexdigest()[:16]


def history_state(root: Path, cell: Cell, drive: Drive, make_system, log,
                  bench_dir: Path = HERE) -> Path:
    """The prior drive's checkpoint, made by the code under test once per
    checkout under `slambench/cache/` and read by every later run."""
    cache = bench_dir / "cache"
    cache.mkdir(exist_ok=True)
    path = cache / f"history-{cell.entry['config']}-{_port_key(root, cell)}.npz"
    if path.is_file():
        return path
    t0 = time.perf_counter()
    system = make_system()
    for fr in drive.history_frames():
        system.process({k: fr[k] for k in SCAN}, fr["image"])
    tmp = cache / f"{path.stem}.partial.npz"
    system.save_checkpoint(str(tmp))
    os.replace(tmp, path)
    log(f"history: {drive.history} frames run and saved in "
        f"{time.perf_counter() - t0:.1f} s to {path.name}")
    return path


def check_calibrated(system, est_cfg: dict) -> None:
    """A rig that calibrates itself (estimate_laser 2) must come out of its
    history with the hand-eye's extrinsic adopted and the window's
    `fine_times` refinements made; a run that never calibrated is a failed
    run, not a fast one."""
    if est_cfg["estimate_laser"] != 2:
        return
    est = system.front.state.est
    adopted = bool(est.handeye.converged)
    refines = int(est.window.ex_refines)
    if not adopted or refines < est_cfg["fine_times"]:
        raise RuntimeError(f"the history left the rig uncalibrated: hand-eye adopted "
                           f"{adopted}, {refines} of {est_cfg['fine_times']} refinements")


def import_guard() -> list:
    """Top-level names of loaded modules that a run may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def reference_imports() -> list:
    """Modules of the port, JAX or the JAX package that the reference's
    files import."""
    bad = []
    for rel in REFERENCE_FILES:
        tree = ast.parse((HERE / rel).read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            bad += [f"{rel}: {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN | {PORT}]
    return bad


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def _device_stats(prof, t_wall: float) -> dict:
    """Kernel time by name, busy union and the longest idle gaps of a
    profiled stretch of `t_wall` host seconds."""
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    spans = []
    for e in ev:
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        c = by_name.setdefault(e.name, [0, 0.0])
        c[0] += 1
        c[1] += (b - a) * 1e-6
    spans.sort()
    busy, end, gaps = 0.0, None, []
    for a, b in spans:
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return {"kernels": by_name, "busy_s": busy * 1e-6, "window_s": t_wall,
            "launches": len(ev), "gaps_us": gaps,
            "first_us": spans[0][0] if spans else 0.0}


def _gap_labels(dev: dict, span_log: list, t_prof0: float) -> list:
    """The ten longest idle gaps, each named by the host span that covers
    most of it (the driver outside every span otherwise)."""
    rows = []
    for a, b in sorted(dev["gaps_us"], key=lambda g: g[0] - g[1])[:10]:
        h0, h1 = t_prof0 + a * 1e-6, t_prof0 + b * 1e-6
        best, label = 0.0, "driver (SlamSystem.process outside the spans)"
        for name, s0, s1 in span_log:
            ov = min(h1, s1) - max(h0, s0)
            if ov > best:
                best, label = ov, name
        rows.append([label, (b - a) * 1e-6])
    return rows


def _answers(rec: Recorder, drive: Drive, n: int, warm: int, system,
             loops_expected: bool) -> reference.Answers:
    """The captured answers of window positions -1..n-1 as plain tensors
    (the run's frame j = warm + position)."""
    rows = range(-1, n)
    idx = [drive.run_index(w + warm) for w in rows]
    fr = [rec.front[w] for w in rows]
    laser = (torch.stack([f["laser_t"] for f in fr]), torch.stack([f["laser_q"] for f in fr]))
    pose = (torch.stack([f["pose_t"] for f in fr]), torch.stack([f["pose_q"] for f in fr]))
    tr = [rec.tracks[w] for w in rows]
    tracks = (torch.stack([t.uv for t in tr]), torch.stack([t.alive for t in tr]),
              torch.stack([t.track_cnt for t in tr]))
    handeye = None
    if rec.handeye:
        he = [rec.handeye[w] for w in rows]
        handeye = (torch.stack([h[0] for h in he]), torch.stack([h[1] for h in he]))
    steps = []
    for w in sorted(rec.handeye_steps):
        if w < n:
            st, qc, ql, ok, out = rec.handeye_steps[w]
            state = lambda h: {"q_cam": h.q_cam, "q_las": h.q_las, "mask": h.mask,  # noqa: E731
                               "n": h.n, "q_ex": h.q_ex, "converged": h.converged}
            steps.append({"before": state(st), "after": state(out), "q_cam": qc,
                          "q_las": ql, "ok": ok})
    maps = [dict(m, idx=drive.run_index(w + warm))
            for w, m in sorted(rec.maps.items()) if w < n and "bank_out" in m]
    graph = None
    if loops_expected and system.graph is not None:
        graph = (system.graph.t, system.graph.ypr)
    return reference.Answers(idx=idx, laser=laser, pose=pose, tracks=tracks,
                             handeye=handeye, handeye_steps=steps, maps=maps,
                             loops=list(rec.loops), graph=graph,
                             relpose=list(rec.relpose), margs=list(rec.margs),
                             solves=list(rec.solves), loops_expected=loops_expected)


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device=None, process_hook=None, log=None, bench_dir: Path = HERE,
             t_start: float | None = None) -> dict:
    """One run; returns {"result": the result line's object, "checks": the
    compared numbers, "readings": every reading, "answers", "drive"}.
    device: the CUDA card unless given (tests pass "cpu").  process_hook:
    wraps `SlamSystem.process` for the window (the tests' faults).  t_start:
    the host clock at the process's start, from which `setup_s` counts."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    cell = Cell(root, name, bench_dir)
    dev = torch.device(device or "cuda")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(bench_dir / "cache" / sub)

    from lmono_tpu_torch.config import SystemConfig
    from lmono_tpu_torch.pipeline import SlamSystem

    cfg = SystemConfig.from_json(json.dumps(cell.config["system"]))
    traffic = cell.traffic
    drive = Drive(traffic, cell.config["system"], dev)
    rec = Recorder()
    make_system = lambda: SlamSystem(cfg, device=dev)   # noqa: E731
    loops_expected = any(k in cell.limits for k in CLOSURE_CHECKS)
    with Patches() as patches:
        if traffic["history"]:
            ckpt = history_state(root, cell, drive, make_system, log, bench_dir)
        frames = drive.stage(seed)
        system = make_system()
        if traffic["history"]:
            system.load_checkpoint(str(ckpt))
            check_calibrated(system, cell.config["system"]["estimator"])
        history = drive.history

        def seen_at(node: int) -> int:
            f = system._node_frames[node]
            return f if f < history else drive.run_index(f - history)

        _install_captures(patches, rec, system, seen_at)
        if trace:
            for m in cell.metrics.values():
                for label, targets in getattr(m, "SPANS", {}).items():
                    for target in targets:
                        patches.wrap(target, _span(rec, label))
                for key, (target, record) in getattr(m, "CALLS", {}).items():
                    patches.wrap(target, _counted(rec, key, record))
        rng = random.Random(seed)
        rec.map_frames = set(rng.sample(range(traffic["map_check_span"]),
                                        traffic["map_check_frames"]))
        rec.marg_pick = set(rng.sample(range(traffic["marg_check_span"]),
                                       traffic["marg_check_calls"]))
        process = system.process if process_hook is None else process_hook(system.process)

        def step(j: int):
            fr = frames[j % len(frames)]
            t0 = time.perf_counter()
            out = process({k: fr[k] for k in SCAN}, fr["image"])
            host = torch.cat([out["pose"].t, out["pose"].q]).cpu()
            return out, host, time.perf_counter() - t0

        warm = traffic["warmup_frames"]
        for j in range(warm):
            rec.frame = -1 if j == warm - 1 else None
            step(j)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        reads0 = system.readbacks
        times, failed = [], 0
        prof, t_prof, dev_stats = None, None, None
        t_w0 = time.perf_counter()
        setup_s = t_w0 - t_start
        w = 0
        while time.perf_counter() - t_w0 < seconds:
            if trace and w == traffic["trace_skip"]:
                from torch.profiler import ProfilerActivity, profile
                prof = profile(activities=[ProfilerActivity.CUDA if dev.type == "cuda"
                                          else ProfilerActivity.CPU])
                prof.__enter__()
                rec.profiling, t_prof = True, time.perf_counter()
            rec.frame = w
            out, host, dt = step(warm + w)
            # the estimator's pose as `process` returned it is the answer judged
            rec.front[w]["pose_t"], rec.front[w]["pose_q"] = out["pose_raw"].t, out["pose_raw"].q
            failed += int(not torch.isfinite(host).all())
            times.append(dt)
            w += 1
            if prof is not None and rec.profiling and w == traffic["trace_skip"] + traffic["trace_frames"]:
                t_wall = time.perf_counter() - t_prof
                rec.profiling = False
                prof.__exit__(None, None, None)
        t_end = time.perf_counter()
        if rec.profiling:
            t_wall = time.perf_counter() - t_prof
            rec.profiling = False
            prof.__exit__(None, None, None)
        if prof is not None:
            dev_stats = _device_stats(prof, t_wall)
        rec.frame = None
        n = w
        traced = max(0, min(n - traffic["trace_skip"], traffic["trace_frames"]))
        front_reads = [int(rec.front[i]["readbacks"]) for i in range(n)]
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        window_s = t_end - t_w0
        e2e = {"frames_per_s": n / window_s,
               "frame_ms_p90": 1e3 * reference.percentile(times, 90.0),
               "setup_s": setup_s}
        view = {"frames": n, "spans": {k: sum(v) for k, v in rec.spans.items()},
                "front": [rec.front[i] for i in range(n)], "front_readbacks": front_reads,
                "system_readbacks": system.readbacks - reads0, "device": dev_stats,
                "calls": rec.calls, "traced_frames": traced}
        per_layer = {}
        if trace:
            for pname, m in cell.metrics.items():
                v = m.read(view)
                if v is not None:
                    per_layer[pname] = v
        ans = _answers(rec, drive, n, warm, system, loops_expected)
        # the program's state goes before the reference runs
        system = frames = process = None
    series = {}
    readings = reference.judge(drive, ans, cell.config["system"]["mapping"], series=series)
    if cell.config["system"]["estimator"]["estimate_laser"] == 2:
        # printed beside the numbers: a yaw-only drive must leave it at 0
        readings["handeye_adopted_frames"] = float(sum(
            bool(f["handeye_converged"]) for f in view["front"]))
        readings["extrinsic_deg"] = reference.extrinsic_gap(view["front"][-1]["ex_q"],
                                                            drive.T_CL[1])
    ok, checks = reference.compare(readings, cell.limits)
    units = {e["name"]: e["unit"] for e in cell.end_to_end}
    units.update({p["name"]: p["unit"] for p in cell.per_layer})
    metrics = ({k: {"value": v, "unit": units[k]} for k, v in per_layer.items()} if trace
               else {k: {"value": e2e[k], "unit": units[k]} for k in units if k in e2e})
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak),
                   "power_limit": _power_limit() if dev.type == "cuda" else None}
    result = {"correct": bool(ok and failed == 0), "attempted": n, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace and dev_stats is not None:
        device_info.update(busy_s=dev_stats["busy_s"], window_s=dev_stats["window_s"])
        top = sorted(dev_stats["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
        result["breakdown"] = {
            "device_ops": [[k, v[1]] for k, v in top],
            "idle_gaps": _gap_labels(dev_stats, rec.span_log, t_prof)}
    result["limits"] = checks
    return {"result": result, "checks": checks, "readings": readings,
            "answers": ans, "drive": drive, "e2e": e2e, "per_layer": per_layer,
            "series": series}
