#!/usr/bin/env python3
"""Kernel times and profiler windows of the PyTorch/CUDA port on one GPU.

    python3 chip_perf.py [--root DIR]
    python3 chip_perf.py --capture-loop FILE.npz
    python3 chip_perf.py --calib-seeds 7,8,9,10 [--calib-fine-times 3,1000]
    python3 chip_perf.py --calib-capture FILE.npz
    python3 chip_perf.py --spans kitti00.lap1,kitti00.revisit
    python3 chip_perf.py --graph
    python3 chip_perf.py --posegraph
    python3 chip_perf.py --attempts kitti00.lap1,kitti00.revisit [--root DIR] [--seed N]

Times the port's two hand-written kernels through the entry points that its
slices call, and takes `torch.profiler` windows of the KITTI-scale
odometry and tracker.  `--root` imports `lmono_tpu_torch` from another
checkout instead of this one, for example an earlier commit unpacked with
`git archive` into a git-ignored directory; to compare two versions, run
both on the same card one after the other, in turns (old, new, new, old).

1. knn: `ops.knn.knn(q, t, mask, 5, center=c)` at the odometry's four
   shapes and the loop lane's two, points at world scale, recentred on a
   sensor position;
2. lk: `ops.lk.track_fb` at the tracker's two pyramids, 150 / 96 random
   slots on two consecutive rendered frames of the simulator;
   for each: ms per call batched (20 back-to-back calls between two CUDA
   events, median of 5), and from a profiler window of 20 calls the device
   ms per call of every kernel the call launches, of the hand-written
   kernels alone, and the kernels per call;
3. profile: the kitti odometry (20 frames after 40) and tracker-kitti (10
   frames after 50): device ms per frame, busy share of the wall time, the
   hand-written kernels' ms and share, kernels per frame; wall ms per frame
   from a window of the same length with the profiler off;
4. profile-pipeline-kitti: the fused pipeline at KITTI scale (10 frames
   after 50): device ms per frame, busy share, kernels per frame, K1's and
   K2's shares and, as profiler ranges, the window solve, the
   marginalization and the tracker's RANSAC (device ms and share, host ms
   and share of the profiled window's wall time; the port's own spans,
   `lmono_tpu_torch/utils/timing.py`, open these ranges), and LM attempts
   and read-backs per frame;
5. profile-system-kitti: `SlamSystem.process_chunk` at KITTI scale on the
   circuit (260 frames of warm-up, the first lap and the start of the
   revisit, then 10 frames profiled while closures fire, and the reap of
   their detections): the same fields,
   and as ranges the window solve, the loop lane's keyframe step, the
   reaps (their pose-graph solves included) and the dense-map merge.

`--spans` instead runs whole `slambench` cells (the benchmark's own
profiler off, the port's tracer on for every window frame) and prints, a
`[spans]` line and one JSON line a cell, the host ms a frame of every
span, the frame's account (its direct children and what none of them
owns) beside the frame's wall time, and over 12 profiled frames the device
ops by the innermost span open at their launch and the card's idle share
inside each span (`span_table`).

`--graph` instead measures the window solve's CUDA graph at KITTI scale
against the same solve issued eagerly (`graph_study`): equality, host ms a
solve, the capture's time and memory, device ops and ms of a replay.

`--posegraph` instead times the single-device pose-graph solve at each
node capacity the system grows through, exact steps against the
budgeted CG (`posegraph_study`).  `--attempts` instead runs benchmark
cells on the checkout at `--root` and writes each frame's LM attempts and
reads (`attempts_study`), for a frame-by-frame comparison of two checkouts.

`--capture-loop` instead runs `chip_smoke.py`'s system-kitti cell alone
and saves what its graph lane consumed, for a CPU replay against the JAX
package (`tests/kitti_loop_lane.py`): every processed keyframe's frame,
time, uncorrected camera pose and detection (found, candidate, relative
pose, refined), every frame's uncorrected laser pose, the corrected
trajectory and its ATE, and the inputs and output of every loop-lane
`register` call (K1 inside).

`--calib-seeds` instead runs calib-online (`eval_sweep.run_preset(2, 300)`)
once per noise seed and fine_times, printing the adoption frame, the
rotation errors at adoption and at the end, ATE and fps, and saves the
hand-eye's rotation pairs for a CPU replay through both packages
(`tests/handeye_replay.py`); `--calib-capture` runs it once and saves each
frame's estimator inputs (tracks and laser pose) for a CPU replay of both
packages' estimators (`tests/handeye_replay.py --teacher`).

Prints one line per measurement and the card's name and power limit.
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import math
import os
import re
import statistics
import subprocess
import sys
import time

import torch

# the odometry's four shapes and the loop lane's LiDAR refinement (a
# keyframe's 512 edge / 1024 planar features against a candidate's banks of
# the same sizes)
KNN_SHAPES = [(1536, 32768), (4096, 65536), (512, 8192), (1024, 16384),
              (512, 512), (1024, 1024)]
KNN_K = 5
# (config, slots) of the tracker's two pyramids
LK_CASES = [("kitti", 150), ("synthetic", 96)]
CALLS, REPS = 20, 5
OWN_KERNEL = re.compile(r"\b(knn|lk)_\w*kernel\b")   # the csrc/ kernels


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def _batched_ms(fn) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / CALLS)
    return statistics.median(times)


def _device_events(prof) -> list:
    """The kernels and copies of a profiler window (not the device-side
    marks of the port's spans)."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


def _device_per_call(fn) -> dict:
    """Device ms per call of all kernels and of the hand-written ones, and
    kernels per call, from a profiler window of CALLS calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    ev = _device_events(prof)
    own = [e for e in ev if OWN_KERNEL.search(e.name)]
    us = lambda es: sum(e.time_range.elapsed_us() for e in es)  # noqa: E731
    return {"device_ms": f"{us(ev) / 1e3 / CALLS:.4f}",
            "kernel_ms": f"{us(own) / 1e3 / CALLS:.4f}",
            "kernels_per_call": f"{len(ev) / CALLS:.1f}"}


def knn_times(dev) -> None:
    from lmono_tpu_torch.ops.knn import knn

    g = torch.Generator(device=dev).manual_seed(5)
    for Q, M in KNN_SHAPES:
        c = torch.tensor([310.0, -45.0, 2.0], device=dev)
        q = c + 20.0 * torch.randn(Q, 3, generator=g, device=dev)
        t = c + 20.0 * torch.randn(M, 3, generator=g, device=dev)
        mask = torch.rand(M, generator=g, device=dev) < 0.9

        def call():
            return knn(q, t, mask, KNN_K, center=c)

        say("knn", Q=Q, M=M, batched_ms=f"{_batched_ms(call):.4f}",
            **_device_per_call(call))


def _frames(cfg, dev, first: int, n: int) -> list:
    """Rendered grey frames first … first+n-1 of the simulator's circuit."""
    from lmono_tpu_torch.io import synthetic as syn
    from lmono_tpu_torch.utils.lie import Pose

    scene = syn.make_city_scene(device=dev)
    traj = syn.circuit_trajectory(120, device=dev)
    T_LC = syn.synthetic_T_CL(device=dev).inverse()
    return [syn.render_camera(scene, Pose(traj.t[i], traj.q[i]).compose(T_LC),
                              cfg.camera) for i in range(first, first + n)]


def lk_times(dev) -> None:
    from lmono_tpu_torch.config import kitti_scale_config, synthetic_config
    from lmono_tpu_torch.ops.image import build_pyramid, scharr_gradients
    from lmono_tpu_torch.ops.lk import track_fb

    g = torch.Generator(device=dev).manual_seed(6)
    for name, N in LK_CASES:
        cfg = kitti_scale_config() if name == "kitti" else synthetic_config()
        L, tc = cfg.tracker.pyramid_levels, cfg.tracker
        img0, img1 = _frames(cfg, dev, 20, 2)
        H, W = img0.shape
        pyr0, pyr1 = build_pyramid(img0, L), build_pyramid(img1, L)
        grads0 = [scharr_gradients(p) for p in pyr0]
        grads1 = [scharr_gradients(p) for p in pyr1]
        pts = torch.rand(N, 2, generator=g, device=dev) * torch.tensor(
            [W - 1.0, H - 1.0], device=dev)
        mask = torch.rand(N, generator=g, device=dev) < 0.9

        def call():
            return track_fb(pyr0, grads0, pyr1, grads1, pts, mask,
                            patch=tc.lk_patch, iters=tc.lk_iters, eps=tc.lk_eps,
                            fb_thresh=tc.fb_threshold)

        say("lk", pyramid=name, H=H, W=W, levels=L, N=N,
            batched_ms=f"{_batched_ms(call):.4f}", **_device_per_call(call))


def _window(prof, frames: int, wall_ms: float, pattern: str) -> dict:
    ev = _device_events(prof)
    spans = sorted((e.time_range.start, e.time_range.end) for e in ev)
    busy, end = 0.0, float("-inf")
    for a, b in spans:                       # union of the device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    total = sum(b - a for a, b in spans)
    own = [e for e in ev if OWN_KERNEL.search(e.name) and pattern in e.name]
    t = sum(e.time_range.elapsed_us() for e in own)
    return {"device_ms_per_frame": f"{total / 1e3 / frames:.4f}",
            "busy_share": f"{busy / 1e3 / frames / wall_ms:.4f}",
            "kernels_per_frame": f"{len(ev) / frames:.1f}",
            f"{pattern}_ms_per_frame": f"{t / 1e3 / frames:.4f}",
            f"{pattern}_share_of_device": f"{t / total:.4f}" if total else "0",
            f"{pattern}_launches_per_frame": f"{len(own) / frames:.2f}"}


def profile_windows(dev) -> None:
    from torch.profiler import ProfilerActivity, profile

    from lmono_tpu_torch.camera import camera_from_config
    from lmono_tpu_torch.config import kitti_scale_config
    from lmono_tpu_torch.estimator.tracker import FeatureTracker
    from lmono_tpu_torch.io import synthetic as syn
    from lmono_tpu_torch.lidar.odometry import LidarOdometry
    from lmono_tpu_torch.utils.lie import Pose

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    cfg = kitti_scale_config()

    # kitti odometry: 2 chunks of 20 frames as warm-up, 1 timed, 1 profiled
    scene = syn.make_city_scene(device=dev)
    traj = syn.circuit_trajectory(120, device=dev)
    g = torch.Generator(device=dev).manual_seed(200)
    frames = [syn.simulate_lidar(scene, Pose(traj.t[i], traj.q[i]), cfg.lidar,
                                 0.01, generator=g) for i in range(80)]
    chunks = [{k: torch.stack([f[k] for f in frames[c:c + 20]])
               for k in ("points", "ranges", "valid")} for c in range(0, 80, 20)]
    odo = LidarOdometry(cfg.lidar, device=dev)
    for c in chunks[:2]:
        odo.process_chunk(c)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    odo.process_chunk(chunks[2])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 20
    with profile(activities=acts) as prof:
        odo.process_chunk(chunks[3])
        torch.cuda.synchronize()
    say("profile-kitti", frames=20, wall_ms_per_frame=f"{wall:.3f}",
        **_window(prof, 20, wall, "knn"))

    # tracker-kitti: 50 frames of warm-up, 20 timed, 10 profiled
    images = _frames(cfg, dev, 0, 80)
    tracker = FeatureTracker(camera_from_config(cfg.camera), cfg.tracker,
                             cfg.camera.height, cfg.camera.width, device=dev)
    for f in images[:50]:
        tracker.process(f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in images[50:70]:
        tracker.process(f)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 20
    with profile(activities=acts) as prof:
        for f in images[70:80]:
            tracker.process(f)
        torch.cuda.synchronize()
    say("profile-tracker-kitti", frames=10, wall_ms_per_frame=f"{wall:.3f}",
        **_window(prof, 10, wall, "lk"))


# the port's spans (`lmono_tpu_torch/utils/timing.py`) that the pipeline
# window and the system window report: each opens a profiler range
PIPE_RANGES = ["window_solve", "marginalization", "tracker.ransac"]
SYSTEM_RANGES = ["window_solve", "loop_lane", "reap", "map"]


def _tracing(system=None):
    """The port's tracer (`system`'s own, or a fresh one), active and
    opening a profiler range per span for a profiled window."""
    from lmono_tpu_torch.utils import timing

    tracer = system.tracer if system is not None else timing.Tracer()
    tracer.ranges = True
    return timing.tracing(tracer)


def _range_fields(prof, ranges, frames: int, prof_wall: float) -> dict:
    """Device and host ms per frame of each range and their shares of the
    window's device time and profiled wall time."""
    total = sum(e.time_range.elapsed_us() for e in _device_events(prof))
    fields = {}
    for label in ranges:
        ev = [e for e in prof.events() if e.name == label
              and e.device_type == torch.autograd.DeviceType.CPU]
        d_us = sum(e.device_time_total for e in ev)
        h_ms = sum(e.cpu_time_total for e in ev) / 1e3 / frames
        fields[f"{label}_device_ms_per_frame"] = f"{d_us / 1e3 / frames:.4f}"
        fields[f"{label}_share_of_device"] = f"{d_us / total:.4f}"
        fields[f"{label}_host_ms_per_frame"] = f"{h_ms:.3f}"
        fields[f"{label}_share_of_profiled_wall"] = f"{h_ms / prof_wall:.4f}"
    return fields


def _kitti_chunks(cfg, dev, n: int) -> tuple[list, object]:
    """The circuit's first n frames (a multiple of 10) at `cfg`'s widths,
    simulated on the card (seed 600) in chunks of 10, and the rig's T_CL."""
    from lmono_tpu_torch.io import synthetic as syn
    from lmono_tpu_torch.utils.lie import Pose

    scene = syn.make_city_scene(device=dev)
    traj = syn.circuit_trajectory(120, device=dev)
    T_CL = syn.synthetic_T_CL(device=dev)
    g = torch.Generator(device=dev).manual_seed(600)
    frames = []
    for i in range(n):
        pose = Pose(traj.t[i], traj.q[i])
        fr = syn.simulate_lidar(scene, pose, cfg.lidar, 0.01, generator=g)
        fr = {k: fr[k] for k in ("points", "ranges", "valid")}
        fr["image"] = syn.render_camera(scene, pose.compose(T_CL.inverse()),
                                        cfg.camera)
        frames.append(fr)
    chunks = [{k: torch.stack([f[k] for f in frames[c:c + 10]]) for k in frames[0]}
              for c in range(0, n, 10)]
    return chunks, T_CL


def profile_pipeline(dev) -> None:
    """pipeline-kitti: `FusedPipeline.process_chunk` at kitti_scale_config,
    40 frames of warm-up, 10 timed, 10 profiled: device ms and busy share
    per frame, kernels per frame, K1's and K2's device share and launches,
    the device and host ms of the window solve (its jacfwd included),
    the marginalization and the tracker's RANSAC, LM attempts and
    read-backs per frame."""
    from torch.profiler import ProfilerActivity, profile

    from lmono_tpu_torch.camera import camera_from_config
    from lmono_tpu_torch.config import kitti_scale_config
    from lmono_tpu_torch.fused import FusedPipeline

    cfg = kitti_scale_config()
    chunks, T_CL = _kitti_chunks(cfg, dev, 60)
    fp = FusedPipeline(cfg, camera_from_config(cfg.camera), T_CL, device=dev)
    for c in chunks[:4]:
        fp.process_chunk(c)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fp.process_chunk(chunks[4])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            _tracing():
        t0 = time.perf_counter()
        out = fp.process_chunk(chunks[5])
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3 / 10
    fields = {**_window(prof, 10, wall, "knn"), **_window(prof, 10, wall, "lk"),
              **_range_fields(prof, PIPE_RANGES, 10, prof_wall)}
    say("profile-pipeline-kitti", frames=10, wall_ms_per_frame=f"{wall:.3f}",
        profiled_wall_ms_per_frame=f"{prof_wall:.3f}",
        lm_attempts_per_frame=f"{float(out['lm_attempts'].float().mean()):.2f}",
        readbacks_per_frame=f"{float(out['readbacks'].float().mean()):.2f}",
        **fields)


def graph_study(dev) -> None:
    """The window solve's CUDA graph at KITTI scale.  `FusedPipeline` at
    kitti_scale_config over the circuit's first 40 frames (the window fills
    at frame 10) records every window its solve was handed; then, on each,
    the graphed solve against the eager one (`chip_smoke.graph_against_eager`):
    attempts and reads equal, costs equal, the largest state difference and
    whether the state is bitwise the eager one, and host ms per solve of
    each.  Then the attempt captured anew on the
    last window: capture seconds (warm-up included), the memory the capture
    reserved and its peak, device ops a replay (a CUDA-only profiler over
    one replay) against an eager attempt's, the device ms of their kernels
    and the wall ms of each."""
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from lmono_tpu_torch.camera import camera_from_config
    from lmono_tpu_torch.config import kitti_scale_config
    from lmono_tpu_torch.estimator import estimator as est_mod
    from lmono_tpu_torch.estimator import solver
    from lmono_tpu_torch.fused import FusedPipeline

    cfg = kitti_scale_config()
    ecfg = cfg.estimator
    chunks, T_CL = _kitti_chunks(cfg, dev, 40)
    inputs, solve = [], est_mod.solve_window

    def recorded(state, c):
        inputs.append(state)
        return solve(state, c)

    est_mod.solve_window = recorded
    try:
        fp = FusedPipeline(cfg, camera_from_config(cfg.camera), T_CL, device=dev)
        for c in chunks:
            fp.process_chunk(c)
    finally:
        est_mod.solve_window = solve
    rows = []
    for st in inputs:
        both = chip_smoke.graph_against_eager(st, ecfg)
        (_, g), (_, e) = both["graphed"], both["eager"]
        rows.append({"attempts": (g.iters, e.iters), "reads": (g.readbacks, e.readbacks),
                     "replayed": g.replayed, **{k: both[k] for k in (
                         "costs_equal", "max_diff", "bitwise", "eager_ms", "graphed_ms")}})
    n_att = sum(r["attempts"][0] for r in rows)
    say("graph-solves", solves=len(rows), attempts=n_att,
        attempts_equal=all(a == b for r in rows for a, b in [r["attempts"]]),
        reads_equal=all(a == b for r in rows for a, b in [r["reads"]]),
        replayed=sum(r["replayed"] for r in rows),
        costs_equal=sum(r["costs_equal"] for r in rows),
        bitwise_solves=sum(r["bitwise"] for r in rows),
        max_abs_diff=f"{max(r['max_diff'] for r in rows):.3e}",
        eager_ms_per_solve=f"{statistics.median(r['eager_ms'] for r in rows):.3f}",
        graphed_ms_per_solve=f"{statistics.median(r['graphed_ms'] for r in rows):.3f}",
        eager_ms_per_attempt=f"{sum(r['eager_ms'] for r in rows) / n_att:.3f}",
        graphed_ms_per_attempt=f"{sum(r['graphed_ms'] for r in rows) / n_att:.3f}")

    st = inputs[-1]
    solver._GRAPHS.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    graph = solver._AttemptGraph(st, ecfg)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    held, reserved = torch.cuda.memory_allocated() - m0, torch.cuda.memory_reserved() - r0
    peak = torch.cuda.max_memory_allocated() - m0
    graph.solve(st, ecfg)
    lam = torch.tensor(ecfg.lm_lambda_init, device=dev)
    solver._attempt(st, lam, ecfg)
    torch.cuda.synchronize()

    def measured(fn) -> tuple[int, float, float]:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        ev = _device_events(prof)
        return len(ev), sum(e.time_range.elapsed_us() for e in ev) / 1e3, wall

    r_ops, r_dev, r_wall = measured(graph.graph.replay)
    e_ops, e_dev, e_wall = measured(lambda: solver._attempt(st, lam, ecfg))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(CALLS):
        graph.graph.replay()
    end.record()
    host_us = (time.perf_counter() - t0) * 1e6 / CALLS
    end.synchronize()
    say("graph-capture", slots=ecfg.max_tracks, window=ecfg.window_size + 1,
        capture_s=f"{capture_s:.3f}", held_bytes=held, reserved_bytes=reserved,
        peak_bytes=peak, replay_device_ops=r_ops, eager_attempt_device_ops=e_ops,
        replay_kernel_ms=f"{r_dev:.3f}", eager_attempt_kernel_ms=f"{e_dev:.3f}",
        replay_wall_ms=f"{r_wall:.3f}", eager_attempt_wall_ms=f"{e_wall:.3f}",
        replay_event_ms=f"{start.elapsed_time(end) / CALLS:.3f}",
        replay_host_us=f"{host_us:.1f}")


def _study_graph(cap: int, seed: int):
    """A pose graph of `cap` live nodes on the CPU: a circuit of a lap and
    5% more (about 1 m between keyframes) with random-walk drift in the
    positions and the yaw, and loop edges from the truth between the
    nodes a lap apart (every other one, up to the 256 slots), one of them
    metres off."""
    from lmono_tpu_torch.loop import posegraph as tp
    from lmono_tpu_torch.utils import lie

    g = torch.Generator().manual_seed(seed)
    th = torch.linspace(0.0, 2 * math.pi * 1.05, cap)
    radius = cap / (2 * math.pi)
    gt = torch.stack([radius * torch.cos(th), radius * torch.sin(th),
                      0.1 * torch.sin(3 * th)], -1)
    ypr = torch.stack([th + math.pi / 2, torch.full_like(th, 0.01),
                       torch.full_like(th, 0.02)], -1)
    q_gt = lie.mat_to_quat(lie.ypr_to_mat(ypr))
    t = gt + torch.cumsum(0.01 * torch.randn(cap, 3, generator=g), 0)
    drift = ypr.clone()
    drift[:, 0] += torch.cumsum(5e-4 * torch.randn(cap, generator=g), 0)
    q = lie.mat_to_quat(lie.ypr_to_mat(drift))
    G = tp.PoseGraph.empty(cap)
    for i in range(cap):
        tp.graph_add_node(G, lie.Pose(t[i], q[i]), i)
    lap = int(round((cap - 1) / 1.05))
    pairs = [(i, i + lap) for i in range(0, cap - lap, 2)][:256]
    for k, (i, j) in enumerate(pairs):
        rel = lie.Pose(gt[i], q_gt[i]).inverse().compose(lie.Pose(gt[j], q_gt[j]))
        if k == len(pairs) // 2:
            rel = lie.Pose(rel.t + torch.tensor([8.0, -6.0, 1.0]), rel.q)
        tp.graph_add_loop(G, i, j, rel, k)
    return G, len(pairs)


def posegraph_study(dev) -> None:
    """The single-device pose-graph solve at each node capacity the system
    grows through (512 → 4096), every node live (`_study_graph`): ms a
    solve (host clock to a synchronize, after one warm-up solve) and the
    peak device memory above the graph's own, for `optimize_posegraph` at
    the system's 20 GN steps with each step's normal equations solved
    exactly (the default: dense J, one LU) and by the reference's 50 CG
    steps, in 4-DoF and 6-DoF; and how far the two results' positions
    lie apart."""
    from lmono_tpu_torch.loop import posegraph as tp

    for cap in POSEGRAPH_CAPS:
        G, loops = _study_graph(cap, 31)
        G = G._replace(**{k: v.to(dev) for k, v in G._asdict().items()})
        for four_dof in (True, False):
            outs = {}
            for cg in (None, 50):
                def solve():
                    return tp.optimize_posegraph(G, iters=20, cg_iters=cg,
                                                 four_dof=four_dof)
                solve()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                m0 = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                outs[cg] = solve()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                say("posegraph", capacity=cap, loops=loops, four_dof=four_dof,
                    step="exact" if cg is None else f"cg{cg}", solve_ms=f"{ms:.1f}",
                    peak_bytes=torch.cuda.max_memory_allocated() - m0)
            apart = (outs[None].t - outs[50].t).abs().max().item()
            say("posegraph-apart", capacity=cap, four_dof=four_dof, max_m=f"{apart:.4g}")
            outs = None
        G = None
        torch.cuda.empty_cache()


def attempts_study(dev, root: str, cells: list, seed: int, out_dir: str) -> None:
    """Each cell's benchmark run (`slambench.harness.run_cell`, 51 s,
    untraced) on the checkout at `root`, recording every frame's LM
    attempts and device reads (`fused_step`'s `lm_attempts` and
    `readbacks`, warm-up frames included): prints the run's end-to-end
    metrics and whether it was correct, and writes the per-frame lists to
    `out_dir/<cell>.<seed>.json`, for a frame-by-frame comparison of two
    checkouts on the same seed."""
    import json
    from pathlib import Path

    from slambench import harness

    os.makedirs(out_dir, exist_ok=True)
    for name in cells:
        rows = []

        def hook(process):
            front = process.__self__.front
            inner = front.process

            def recorded(*args, **kwargs):
                out = inner(*args, **kwargs)
                rows.append((int(out["lm_attempts"]), int(out["readbacks"])))
                return out
            front.process = recorded
            return process

        out = harness.run_cell(Path(root), name, seed, 51.0, False, process_hook=hook)
        path = os.path.join(out_dir, f"{name}.{seed}.json")
        with open(path, "w") as f:
            json.dump({"cell": name, "seed": seed, "e2e": out["e2e"],
                       "correct": out["result"]["correct"], "frames": rows}, f)
        say("attempts", cell=name, seed=seed, frames=len(rows),
            correct=out["result"]["correct"], path=path,
            **{k: f"{v:.4f}" for k, v in out["e2e"].items()})


def profile_system(dev) -> None:
    """system-kitti: `SlamSystem.process_chunk` (loop and map on) at
    kitti_scale_config, the estimator seeded with the rig's extrinsic, on
    frames made chunk by chunk; 13 chunks of 20 as warm-up (a lap is 251
    frames), then a chunk of 10 profiled while the revisit closes loops,
    with the reap of its detections."""
    from torch.profiler import ProfilerActivity, profile

    from lmono_tpu_torch.config import kitti_scale_config
    from lmono_tpu_torch.io import synthetic as syn
    from lmono_tpu_torch.pipeline import SlamSystem
    from lmono_tpu_torch.utils.lie import Pose

    warm, n, last_n = 13, 20, 10
    T_CL = syn.synthetic_T_CL(device=dev)
    cfg = kitti_scale_config().replace(
        laser_to_camera=tuple(T_CL.to_mat4().reshape(-1).tolist()))
    scene = syn.make_city_scene(device=dev)
    traj = syn.circuit_trajectory(warm * n + last_n, device=dev)
    g = torch.Generator(device=dev).manual_seed(800)

    def chunk(c: int, size: int = n) -> dict:
        frames = []
        for i in range(c * n, c * n + size):
            pose = Pose(traj.t[i], traj.q[i])
            fr = syn.simulate_lidar(scene, pose, cfg.lidar, 0.01, generator=g)
            fr = {k: fr[k] for k in ("points", "ranges", "valid")}
            fr["image"] = syn.render_camera(scene, pose.compose(T_CL.inverse()),
                                            cfg.camera)
            frames.append(fr)
        return {k: torch.stack([f[k] for f in frames]) for k in frames[0]}

    system = SlamSystem(cfg, device=dev)
    for c in range(warm):
        system.process_chunk(chunk(c), t0=c * n * 0.1)
    last = chunk(warm, last_n)
    torch.cuda.synchronize()
    loops0, kf0, reads0 = system.n_loops, system.keyframes_processed, system.readbacks
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            _tracing(system):
        t0 = time.perf_counter()
        out = system.process_chunk(last, t0=warm * n * 0.1)
        system._reap_loops()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3 / last_n
    fields = {**_window(prof, last_n, prof_wall, "knn"),
              **_window(prof, last_n, prof_wall, "lk"),
              **_range_fields(prof, SYSTEM_RANGES, last_n, prof_wall)}
    say("profile-system-kitti", frames=last_n, first_frame=warm * n,
        profiled_wall_ms_per_frame=f"{prof_wall:.3f}",
        closures=system.n_loops - loops0,
        keyframes_processed=system.keyframes_processed - kf0,
        system_readbacks=system.readbacks - reads0,
        estimator_readbacks=int(out["readbacks"].sum()),
        graph_capacity=system.graph.t.shape[0], **fields)


def _idle_ns(gaps: list, gap_t0: list, a: int, b: int) -> int:
    """Length of [a, b] that falls into the sorted idle intervals `gaps`
    (`gap_t0` their starts)."""
    import bisect

    i, got = max(0, bisect.bisect_right(gap_t0, a) - 1), 0
    while i < len(gaps) and gaps[i][0] < b:
        got += max(0, min(b, gaps[i][1]) - max(a, gaps[i][0]))
        i += 1
    return got


def _span_device(prof, records: list, frames: int) -> dict:
    """Device ops of a profile of traced frames, each counted against the
    innermost span open at its launch (the runtime call with the same
    correlation id, on the profiler's clock), and the card's idle share
    inside each span name (idle: `slambench`'s gaps between the device
    intervals, and the time before the first and after the last)."""
    import bisect

    from slambench.harness import _device_stats

    start = prof.profiler.kineto_results.trace_start_ns()
    ev = prof.events()
    dev_ops = [e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    launch = {e.id: start + int(e.time_range.start * 1e3) for e in ev
              if e.device_type == torch.autograd.DeviceType.CPU
              and e.name.startswith("cuda")}
    frames_of: dict = {}
    for r in records:
        frames_of.setdefault(r.frame, []).append(r)
    roots = sorted((r.t0, r.t1, r.frame) for r in records if r.name == "frame")
    root_t0 = [r[0] for r in roots]
    launches, unmatched, outside = {}, 0, 0
    for e in dev_ops:
        t = launch.get(e.id)
        if t is None:
            unmatched += 1
            continue
        k = bisect.bisect_right(root_t0, t) - 1
        if k < 0 or roots[k][1] < t:
            outside += 1
            continue
        best = None
        for r in frames_of[roots[k][2]]:
            if r.t0 <= t <= r.t1 and (best is None or r.t0 >= best.t0):
                best = r
        launches[best.name] = launches.get(best.name, 0) + 1
    ns = lambda us: start + int(us * 1e3)                # noqa: E731
    stats = _device_stats(prof, 0.0)
    last = max((e.time_range.end for e in dev_ops), default=stats["first_us"])
    gaps = ([(-1 << 62, ns(stats["first_us"]))]
            + [(ns(a), ns(b)) for a, b in stats["gaps_us"]] + [(ns(last), 1 << 62)])
    gap_t0 = [g[0] for g in gaps]
    idle = {}
    for r in records:
        i = idle.setdefault(r.name, [0, 0])
        i[0] += r.t1 - r.t0
        i[1] += _idle_ns(gaps, gap_t0, r.t0, r.t1)
    n = len(dev_ops)
    return {"device_ops_per_frame": n / frames,
            "launches_per_frame": {k: v / frames for k, v in sorted(launches.items())},
            "inside_frame_share": (n - unmatched - outside) / n if n else None,
            "ops_without_launch_record": unmatched, "ops_outside_frames": outside,
            "idle_pct": {k: 100.0 * b / a for k, (a, b) in sorted(idle.items()) if a}}


def _range_offsets(prof, records: list) -> dict:
    """How far each span's profiler range lies outside the tracer's own
    [t0, t1] (ns; <= 0 inside), placed by the profile's trace_start_ns."""
    start = prof.profiler.kineto_results.trace_start_ns()
    marks: dict = {}
    for e in prof.events():
        if e.is_user_annotation and e.device_type == torch.autograd.DeviceType.CPU:
            marks.setdefault(e.name, []).append(
                (start + int(e.time_range.start * 1e3), start + int(e.time_range.end * 1e3)))
    worst, n = None, 0
    for name, got in marks.items():
        mine = sorted((r.t0, r.t1) for r in records if r.name == name)
        for (t0, t1), (a, b) in zip(mine, sorted(got)):
            d = max(t0 - a, b - t1)
            worst = d if worst is None else max(worst, d)
            n += 1
    return {"ranges": n, "spans": len(records), "worst_outside_ns": worst}


def _host_table(recs: list, frames: set) -> dict:
    """Host ms and spans a frame by span name over `frames`, and the
    frame's account as `slambench`'s span metrics read it: its direct
    children, what none of them owns, and what is left of the frame after
    both (0 but for rounding)."""
    from slambench import spans

    by_frame: dict = {}
    for r in recs:
        if r.frame in frames:
            by_frame.setdefault(r.frame, []).append(r)
    traced = spans.frames(list(by_frame.values()))
    nf = max(1, len(traced))
    ms, n, child = {}, {}, {}
    for rs in traced:
        root = next(r for r in rs if r.name == "frame")
        for r in rs:
            ms[r.name] = ms.get(r.name, 0) + (r.t1 - r.t0) * 1e-6 / nf
            n[r.name] = n.get(r.name, 0) + 1 / nf
            if r.parent == root.id:
                child[r.name] = child.get(r.name, 0) + (r.t1 - r.t0) * 1e-6 / nf
    frame_ms = spans.per_frame(traced, lambda rs: spans.ms(rs, "frame")) or 0.0
    unspanned = spans.per_frame(traced, spans.unspanned_ms) or 0.0
    kids = sum(child.values())
    return {"frames": len(traced), "frame_ms": frame_ms, "children_ms": kids,
            "unspanned_ms": unspanned, "rest_ms": frame_ms - kids - unspanned,
            "host_ms": dict(sorted(ms.items())), "spans": dict(sorted(n.items())),
            "direct_children_ms": dict(sorted(child.items()))}


# `--spans`: each run's window (s), the unprofiled window frames before the
# profiles, and the frames of the CUDA-only profile
SPAN_SECONDS, SPAN_SKIP, SPAN_PROFILED = 100.0, 30, 12
POSEGRAPH_CAPS = (512, 1024, 2048, 4096)


def span_table(dev, cells: list) -> None:
    """The port's spans over whole benchmark runs (`slambench`, its own
    profiler off, the port's tracer on for every window frame): host ms and
    spans a frame by span name and the frame's account (its direct children
    and what none of them owns) beside the frames' wall time, over the
    unprofiled window frames (the first SPAN_SKIP and those after the
    profiles) and over the profiled ones.  Over SPAN_PROFILED frames
    profiled as the benchmark's traced runs profile (CUDA activity alone,
    the tracer opening no ranges): device ops by the innermost span open at
    their launch, the card's idle share inside each span, and where the
    profile's clock starts against the host clock read after it opens.
    Over 2 frames more with CPU activity and ranges too: the spans'
    profiler ranges against the tracer's clock.  The profiles are read
    after the run."""
    import json
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    from slambench import harness
    from slambench.manifest import Cell

    root = Path(os.path.dirname(os.path.abspath(__file__)))
    for name in cells:
        warm = Cell(root, name).traffic["warmup_frames"]
        stretches = ((SPAN_SKIP, SPAN_PROFILED, [ProfilerActivity.CUDA]),
                     (SPAN_SKIP + SPAN_PROFILED, 2,
                      [ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        st = {"n": 0, "wall": {}, "profs": []}

        def hook(process):
            system = st["system"] = process.__self__

            def wrapped(scan, image):
                i = st["n"] - warm
                st["n"] += 1
                tr = system.tracer
                if i == 0:
                    system.trace = True
                for first, n, acts in stretches:
                    if i == first:
                        torch.cuda.synchronize()
                        tr.ranges = ProfilerActivity.CPU in acts
                        prof = profile(activities=acts)
                        prof.__enter__()
                        st["profs"].append((prof, system.frame_idx, n, tr.now()))
                t0 = time.perf_counter()
                out = process(scan, image)
                torch.cat([out["pose"].t, out["pose"].q]).cpu()
                if i >= 0:
                    st["wall"][system.frame_idx - 1] = time.perf_counter() - t0
                for first, n, _ in stretches:
                    if i == first + n - 1:
                        torch.cuda.synchronize()
                        st["profs"][-1][0].__exit__(None, None, None)
                        st["closed"] = len(st["profs"])
                        tr.ranges = False
                return out
            return wrapped

        out = harness.run_cell(root, name, 20261018, SPAN_SECONDS, False,
                               process_hook=hook)
        if len(st["profs"]) > st.get("closed", 0):      # the window ended inside one
            st["profs"].pop()[0].__exit__(None, None, None)
        recs = list(st.pop("system").tracer.spans)
        profiled = []
        row = {"cell": name, "e2e": out["e2e"], "correct": out["result"]["correct"],
               "device": None, "ranges": None}
        for k, (prof, f0, n, t_prof) in enumerate(st["profs"]):
            frames = set(range(f0, f0 + n))
            profiled.append(frames)
            mine = [r for r in recs if r.frame in frames]
            if k == 0:
                row["device"] = _span_device(prof, mine, n)
                row["device"]["trace_start_minus_host_ms"] = (
                    prof.profiler.kineto_results.trace_start_ns() - t_prof) / 1e6
            else:
                row["ranges"] = _range_offsets(prof, mine)
        st["profs"] = None
        plain = set(st["wall"]) - set().union(*profiled)
        for key, frames in (("unprofiled", plain),
                            ("profiled", profiled[0] if profiled else set())):
            row[key] = _host_table(recs, frames)
            row[key]["wall_ms"] = 1e3 * sum(st["wall"][f] for f in frames) / max(1, len(frames))
        u = row["unprofiled"]
        say("spans", cell=name, frames=u["frames"], frame_ms=f"{u['frame_ms']:.3f}",
            wall_ms=f"{u['wall_ms']:.3f}", unspanned_ms=f"{u['unspanned_ms']:.3f}",
            rest_ms=f"{u['rest_ms']:.6f}", read_ms=f"{u['host_ms'].get('read', 0.0):.3f}",
            inside_frame_share=(row["device"] or {}).get("inside_frame_share"),
            correct=row["correct"])
        print(json.dumps(row), flush=True)


def capture_loop(dev, path: str) -> None:
    """system-kitti as `chip_smoke.py` runs it, recording its graph lane's
    inputs into `path` (see the module docstring)."""
    import numpy as np

    import chip_smoke
    from lmono_tpu_torch.config import kitti_scale_config
    from lmono_tpu_torch.loop import detector as det_mod
    from lmono_tpu_torch.utils.lie import pose_stack

    nodes, regs, holder = [], [], {}

    def observe(system):
        add = system._add_node

        def add_node(corr_pose, raw_cam, res, time, pos, frame_idx):
            nodes.append((raw_cam, res, time, frame_idx))
            return add(corr_pose, raw_cam, res, time, pos, frame_idx)

        system._add_node = add_node
        holder["system"] = system

    register = det_mod.register

    def recorded(init_pose, *banks_and_cfg):
        out, diag = register(init_pose, *banks_and_cfg)
        regs.append((init_pose, banks_and_cfg[:8], out, diag["inliers"][-1]))
        return out, diag

    det_mod.register = recorded
    try:
        res = chip_smoke.system_phase("system-kitti", kitti_scale_config(), dev, 800,
                                      observe=observe)
    finally:
        det_mod.register = register
    system = holder["system"]
    cpu = lambda x: x.detach().cpu().numpy()
    raw = pose_stack(system._raw_poses)
    est = system.final_trajectory()
    out = {"frames": np.int64(chip_smoke.SYS_FRAMES), "chunk": np.int64(chip_smoke.CHUNK),
           "seed": np.int64(800), "ate_m": np.float64(res["ate"]),
           "raw_pose_t": cpu(raw.t), "raw_pose_q": cpu(raw.q),
           "est_t": cpu(est.t), "est_q": cpu(est.q),
           "node_frame": np.array([n[3] for n in nodes], np.int64),
           "node_time": np.array([n[2] for n in nodes], np.float64),
           "node_cam_t": np.stack([cpu(n[0].t) for n in nodes]),
           "node_cam_q": np.stack([cpu(n[0].q) for n in nodes])}
    for f in ("found", "old_seq", "rel_t", "rel_q", "refined"):
        out[f"res_{f}"] = np.stack([cpu(getattr(n[1], f)) for n in nodes])
    names = ("edge", "edge_mask", "planar", "planar_mask",
             "bank_edge", "bank_edge_mask", "bank_planar", "bank_planar_mask")
    for k, (init, banks, o, inl) in enumerate(regs):
        out[f"reg{k}_init_t"], out[f"reg{k}_init_q"] = cpu(init.t), cpu(init.q)
        out[f"reg{k}_out_t"], out[f"reg{k}_out_q"] = cpu(o.t), cpu(o.q)
        out[f"reg{k}_inliers"] = cpu(inl)
        for nm, b in zip(names, banks):
            out[f"reg{k}_{nm}"] = cpu(b)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, n_regs=np.int64(len(regs)), **out)
    say("capture-loop", path=path, keyframes=len(nodes), register_calls=len(regs),
        closures=system.n_loops, ate_m=f"{res['ate']:.6f}")


def calib_study(dev, seeds: list, fine_times: list, path: str) -> None:
    """calib-online's row (`eval_sweep.run_preset(2, 300)`: KITTI 02's
    preset from the identity extrinsic on the figure-8) for each noise seed
    g (the pipeline's generator seed g, the sweeps' noise seed 693 + g:
    seed 7 is `chip_smoke.py`'s run) and each fine_times; the hand-eye's
    pair ring of each seed (it stops filling at adoption, before fine_times
    matters) saved in `path` for a CPU replay (`tests/handeye_replay.py`)."""
    import numpy as np

    from lmono_tpu_torch import eval_sweep
    from lmono_tpu_torch.io import synthetic as syn

    scene = syn.make_city_scene(device=dev)
    traj8 = syn.figure8_trajectory(eval_sweep.MODE2_MIN_FRAMES, device=dev)
    base, noise_seed = eval_sweep.FusedPipeline, eval_sweep.NOISE_SEED
    made, rings = [], {}
    try:
        for ft in fine_times:
            for g in seeds:
                class Seeded(base):
                    def __init__(self, cfg, cam, T_CL=None, device=None, generator=None):
                        super().__init__(cfg, cam, T_CL, device,
                                         torch.Generator(device=device).manual_seed(g))
                        made.append(self)

                eval_sweep.FusedPipeline = Seeded
                eval_sweep.NOISE_SEED = 693 + g
                row = eval_sweep.run_preset(2, eval_sweep.MODE2_MIN_FRAMES, scene, traj8,
                                            traj_excite=traj8, device=dev, fine_times=ft)
                he = made[-1].state.est.handeye
                for k in ("q_cam", "q_las", "mask", "q_ex"):
                    rings[f"{k}_{g}"] = getattr(he, k).cpu().numpy()
                say("calib-study", fine_times=ft, seed=g,
                    adoption_frame=row["adoption_frame"],
                    err_at_adoption_deg=row["handeye_rot_err_at_adoption_deg"],
                    err_at_end_deg=f"{row['handeye_rot_err_deg']:.6f}",
                    ate_m=f"{row['ate_m']:.6f}", laser_ate_m=f"{row['laser_ate_m']:.6f}",
                    fps_before=row["fps_before_adoption"], fps_after=row["fps_after_adoption"],
                    non_keyframes=row["non_keyframes"])
    finally:
        eval_sweep.FusedPipeline, eval_sweep.NOISE_SEED = base, noise_seed
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, seeds=np.array(seeds, np.int64), **rings)
    say("calib-study", path=path)


def calib_capture(dev, path: str) -> None:
    """calib-online as `chip_smoke.py` runs it, recording what each frame
    hands the fusion estimator (the tracker's output and the laser pose)
    into `path`, for a CPU replay of both packages' estimators on the same
    inputs (`tests/handeye_replay.py --teacher`)."""
    import numpy as np

    import chip_smoke
    from lmono_tpu_torch import eval_sweep, fused
    from lmono_tpu_torch.io import synthetic as syn

    frames = []
    step = fused.fusion_step

    def recorded(state, track, laser, cfg, count, gumbel=None):
        frames.append([x.detach().cpu().numpy() for x in (*track, laser.t, laser.q)])
        return step(state, track, laser, cfg, count, gumbel)

    fused.fusion_step = recorded
    try:
        traj8 = syn.figure8_trajectory(chip_smoke.CALIB_FRAMES, device=dev)
        row = eval_sweep.run_preset(2, chip_smoke.CALIB_FRAMES, syn.make_city_scene(device=dev),
                                    traj8, traj_excite=traj8, device=dev,
                                    fine_times=chip_smoke.CALIB_FINE_TIMES)
    finally:
        fused.fusion_step = step
    names = ("ids", "uv", "norm", "velocity", "track_cnt", "alive", "laser_t", "laser_q")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    adopt = row["adoption_frame"]
    np.savez_compressed(path, adoption_frame=np.int64(-1 if adopt is None else adopt),
                        **{k: np.stack([f[i] for f in frames]) for i, k in enumerate(names)})
    say("calib-capture", path=path, frames=len(frames), adoption_frame=row["adoption_frame"],
        err_at_adoption_deg=row["handeye_rot_err_at_adoption_deg"])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                    help="checkout whose lmono_tpu_torch is measured")
    ap.add_argument("--capture-loop", metavar="FILE",
                    help="only record system-kitti's graph lane into FILE (.npz)")
    ap.add_argument("--calib-seeds", metavar="G,G,...",
                    help="only run calib-online for these noise seeds")
    ap.add_argument("--calib-fine-times", metavar="N,N,...", default="3,1000",
                    help="with --calib-seeds: the fine_times values to run")
    ap.add_argument("--calib-out", metavar="FILE", default="handeye_rings.npz",
                    help="with --calib-seeds: where the hand-eye rings go (.npz)")
    ap.add_argument("--calib-capture", metavar="FILE",
                    help="only record calib-online's estimator inputs into FILE (.npz)")
    ap.add_argument("--spans", metavar="CELL,CELL",
                    help="only the span table of these slambench cells")
    ap.add_argument("--graph", action="store_true",
                    help="only the window solve's CUDA graph against its eager loop")
    ap.add_argument("--posegraph", action="store_true",
                    help="only the pose-graph solve's time and memory by capacity")
    ap.add_argument("--attempts", metavar="CELL,CELL",
                    help="only these cells' runs on --root, each frame's attempts and reads")
    ap.add_argument("--seed", type=int, default=20261018, help="with --attempts")
    ap.add_argument("--attempts-out", metavar="DIR", default="attempts",
                    help="with --attempts: where the per-frame lists go")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_perf: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.abspath(a.root))
    import lmono_tpu_torch

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
        flush=True)
    say("root", package=os.path.dirname(lmono_tpu_torch.__file__))
    dev = torch.device("cuda", 0)
    if a.capture_loop:
        capture_loop(dev, a.capture_loop)
        return
    if a.calib_capture:
        calib_capture(dev, a.calib_capture)
        return
    if a.spans:
        torch.set_num_threads(1)        # as slambench/run.py runs
        span_table(dev, a.spans.split(","))
        return
    if a.graph:
        graph_study(dev)
        return
    if a.posegraph:
        posegraph_study(dev)
        return
    if a.attempts:
        torch.set_num_threads(1)        # as slambench/run.py runs
        attempts_study(dev, os.path.abspath(a.root), a.attempts.split(","), a.seed,
                       a.attempts_out)
        return
    if a.calib_seeds:
        calib_study(dev, [int(g) for g in a.calib_seeds.split(",")],
                    [int(n) for n in a.calib_fine_times.split(",")], a.calib_out)
        return
    knn_times(dev)
    lk_times(dev)
    profile_windows(dev)
    profile_pipeline(dev)
    profile_system(dev)


if __name__ == "__main__":
    main()
