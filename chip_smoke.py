#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`lmono_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two slices through their entry points,
`LidarOdometry.process_chunk` and `FeatureTracker.process`, and checks every
kernel on their paths against its plain PyTorch version:

1. device: the card, its power limit and the toolchain;
2. build: compiles the CUDA kernels (`lmono_tpu_torch/csrc/knn.cu`, K1, and
   `lmono_tpu_torch/csrc/lk.cu`, K2), one `nvcc` each, started together;
3. knn: K1 against `knn_plain` at the odometry's shapes and a ragged case,
   with times of both;
4. lk: K2 against `lk_level_plain` at the four KITTI pyramid levels (N=150)
   and at 512×1024 (N=256), both LK semantics, on a smooth random texture
   shifted by a known sub-pixel flow, with times of both;
5. synthetic / kitti: the odometry slice at `synthetic_config().lidar` and
   `kitti_scale_config().lidar`, 120 simulated frames in chunks of 20 (as
   `bench.py` runs the JAX package): ATE gate 0.5 m, fps, drift and peak
   memory, exactly 2 K1 launches per outer iteration and frame with no
   plain KNN call, and (synthetic) the first frames again on the CPU;
6. tracker-synthetic / tracker-kitti: the KLT front-end at
   `synthetic_config()` (512×256, 96 slots, 3 levels) and
   `kitti_scale_config()` (1241×376, 150 slots, 4 levels), 120 frames
   rendered on the card along the circuit: exactly 2 × levels K2 launches
   per frame and no plain LK call, median frame-to-frame track error
   against the simulator's geometry under 0.6 px, mean tracks carried at
   least half the slots, frames/s and peak memory, and (synthetic) the
   first frames again on the CPU.

Prints one JSON line of kernel results, the `nvidia-smi` name and power
limit, and last `{"ok": true, "device": {...}}`.  Any failed check raises,
so the exit code is non-zero and the last line is not printed.  Needs a
CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_FRAMES = 120
CHUNK = 20
WARMUP_CHUNKS = 1
ATE_GATE_M = 0.5          # bench.py's odometry gate
NOISE_STD_M = 0.01        # range noise of the simulated sweeps
KNN_K = 5
KNN_RTOL, KNN_ATOL = 1e-5, 1e-4      # d² of kernel vs plain (both exact f32)
KNN_GAP = 1e-4            # index sets compared where d²_(k+1) − d²_k exceeds this
CPU_CHECK_FRAMES = 4
# CUDA vs CPU pose, as tests/test_torch_odometry.py holds the port to the
# JAX package: f32 sums in another order move the reference's
# ill-conditioned plane fits, by millimetres of pose
CPU_ATOL_T, CPU_ATOL_Q = 1e-2, 1e-3
DRIFT_LENGTHS_M = (20.0, 40.0, 60.0, 80.0)  # a 120-frame run covers 96 m
TIMING_CALLS = 20
TIMING_REPS = 5
# K2 against its plain version: the two sum the patch in another order
LK_ATOL_PX = 1e-3
LK_OK_AGREE = 0.99
LK_FLOW = (1.37, -0.61)       # img1(x) = img0(x + flow): LK finds -flow
LK_CASES = [(376, 1241, 150), (188, 620, 150), (94, 310, 150), (47, 155, 150),
            (512, 1024, 256)]  # KITTI levels at 150 slots; KERNELS.json's lk
LK_PATCH, LK_ITERS = 21, 10
TRACK_ERR_GATE_PX = 0.6      # twice the reference's 0.30 px median
CARRIED_SHARE = 0.5          # mean tracks carried per frame / max_features
TRACK_WARMUP = 10            # frames before the tracker's timed window
# CUDA vs CPU tracker on the first frames: same noise, sums in another order
TRACK_CPU_ALIVE_AGREE = 0.97
TRACK_CPU_ATOL_PX = 1e-2


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from lmono_tpu_torch.ops.cuda._build import nvcc as nvcc_path

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    say("device", name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=repr(nvcc.splitlines()[-1]), python=sys.version.split()[0])
    return name


def build_phase() -> None:
    from lmono_tpu_torch.ops.cuda import knn as knn_cuda_mod
    from lmono_tpu_torch.ops.cuda import lk as lk_cuda_mod

    def timed(mod):
        t0 = time.perf_counter()
        report = mod.build()
        return report, time.perf_counter() - t0

    kernels = {"knn": knn_cuda_mod, "lk": lk_cuda_mod}
    with ThreadPoolExecutor(len(kernels)) as pool:
        futures = {k: pool.submit(timed, m) for k, m in kernels.items()}
        results = {k: f.result() for k, f in futures.items()}
    for name, (report, seconds) in results.items():
        say("build", kernel=name, seconds=f"{seconds:.2f}")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas: " + line.strip(), flush=True)


def _median_ms(fn) -> float:
    """Median ms per call over TIMING_REPS runs of TIMING_CALLS back-to-back
    calls, each run between two CUDA events (so host launch overhead is
    hidden behind the queued work wherever the work is the longer)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMING_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TIMING_CALLS):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / TIMING_CALLS)
    return statistics.median(times)


def knn_phase(dev) -> dict:
    """Kernel vs plain version on the card, at world-scale coordinates."""
    from lmono_tpu_torch.ops.cuda.knn import knn_cuda
    from lmono_tpu_torch.ops.knn import knn_plain

    g = torch.Generator(device=dev).manual_seed(1)
    center = torch.tensor([100.0, 0.0, 0.0], device=dev)
    # (Q, M, kept share of bank rows); the last is ragged (Q, M not
    # multiples of the block or tile) with fewer than k valid rows
    cases = [(1536, 32768, 0.9), (4096, 65536, 0.9), (512, 8192, 0.9),
             (777, 3001, 3.0 / 3001)]
    max_err = 0.0
    ms = plain_ms = None
    for Q, M, keep in cases:
        q = center + 20.0 * torch.randn(Q, 3, generator=g, device=dev)
        t = center + 20.0 * torch.randn(M, 3, generator=g, device=dev)
        if keep < 0.5:
            mask = torch.zeros(M, dtype=torch.bool, device=dev)
            mask[torch.randperm(M, generator=g, device=dev)[:3]] = True
        else:
            mask = torch.rand(M, generator=g, device=dev) < keep
        d_k, i_k = knn_cuda(q, t, mask, KNN_K)
        d_p, i_p = knn_plain(q, t, mask, KNN_K + 1)
        torch.cuda.synchronize()
        d_k, i_k, d_p, i_p = (x.cpu() for x in (d_k, i_k, d_p, i_p))
        torch.testing.assert_close(d_k, d_p[:, :KNN_K], rtol=KNN_RTOL, atol=KNN_ATOL)
        found = d_k < 1e11
        if not torch.equal(found, d_p[:, :KNN_K] < 1e11):
            raise AssertionError(f"knn ({Q},{M}): missing entries differ")
        gap = (d_p[:, KNN_K] - d_p[:, KNN_K - 1]) > KNN_GAP
        sk = torch.sort(torch.where(found, i_k, -1), dim=1).values[gap]
        sp = torch.sort(torch.where(found, i_p[:, :KNN_K], -1), dim=1).values[gap]
        if not torch.equal(sk, sp):
            bad = int((sk != sp).any(dim=1).sum())
            raise AssertionError(f"knn ({Q},{M}): index sets differ on {bad} rows")
        err = float((d_k - d_p[:, :KNN_K]).abs()[found].max()) if found.any() else 0.0
        max_err = max(max_err, err)
        k_ms = _median_ms(lambda: knn_cuda(q, t, mask, KNN_K))
        p_ms = _median_ms(lambda: knn_plain(q, t, mask, KNN_K))
        say("knn", Q=Q, M=M, valid=int(mask.sum()), max_abs_err=err,
            rows_with_gap=int(gap.sum()), kernel_ms=f"{k_ms:.4f}",
            plain_ms=f"{p_ms:.4f}")
        if (Q, M) == (4096, 65536):
            ms, plain_ms = k_ms, p_ms
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def _texture(H: int, W: int, g: torch.Generator, dev) -> torch.Tensor:
    """Smooth random texture in [0, 1] with corners at two scales."""
    import torch.nn.functional as F

    def octave(div):
        base = torch.randn(H // div + 2, W // div + 2, generator=g, device=dev)
        return F.interpolate(base[None, None], size=(H, W), mode="bicubic",
                             align_corners=False)[0, 0]

    img = octave(8) + 0.3 * octave(2)
    return (img - img.min()) / (img.max() - img.min())


def lk_phase(dev) -> dict:
    """K2 vs plain version on the card, both semantics, at the tracker's
    level shapes and KERNELS.json's."""
    from lmono_tpu_torch.ops.cuda.lk import lk_level_cuda
    from lmono_tpu_torch.ops.image import bilinear_sample, scharr_gradients
    from lmono_tpu_torch.ops.lk import lk_level_plain

    g = torch.Generator(device=dev).manual_seed(2)
    max_err = 0.0
    ms = plain_ms = None
    for H, W, N in LK_CASES:
        img0 = _texture(H, W, g, dev)
        flat = LK_PATCH + 4                # a flat corner: det ≈ 0 there
        img0[:flat, -flat:] = 0.5
        yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                                torch.arange(W, dtype=torch.float32, device=dev),
                                indexing="ij")
        img1 = bilinear_sample(img0, torch.stack([xx + LK_FLOW[0],
                                                  yy + LK_FLOW[1]], -1))
        ix0, iy0 = scharr_gradients(img0)
        # slots anywhere, the four corners and the flat patch included
        pts = torch.rand(N, 2, generator=g, device=dev) * torch.tensor(
            [W - 1.0, H - 1.0], device=dev)
        pts[:5] = torch.tensor([[0.5, 0.5], [W - 1.5, 0.5], [0.5, H - 1.5],
                                [W - 1.5, H - 1.5], [W - flat / 2, flat / 2]],
                               device=dev)
        args = (img0, ix0, iy0, img1, pts, pts.clone())
        for pallas in (True, False):
            thresh = 0.1
            p_k, ok_k = lk_level_cuda(*args, LK_PATCH, LK_ITERS, pallas, thresh)
            p_p, ok_p = lk_level_plain(*args, LK_PATCH, LK_ITERS, pallas)
            torch.cuda.synchronize()
            both = ok_k & ok_p
            agree = float((ok_k == ok_p).float().mean())
            err = float((p_k - p_p).abs()[both].max()) if both.any() else 0.0
            # the flow, on slots whose patch lies inside the image
            r = LK_PATCH // 2 + 2
            m = both & (pts[:, 0] > r) & (pts[:, 0] < W - 1 - r) \
                & (pts[:, 1] > r) & (pts[:, 1] < H - 1 - r)
            flow = (p_k - pts)[m].median(0).values.tolist() if m.any() else [0, 0]
            max_err = max(max_err, err)
            fields = dict(H=H, W=W, N=N, pallas=pallas, ok=int(ok_k.sum()),
                          ok_agree=f"{agree:.4f}", max_abs_err_px=err,
                          median_flow=f"({flow[0]:.4f},{flow[1]:.4f})")
            if pallas:
                k_ms = _median_ms(lambda: lk_level_cuda(
                    *args, LK_PATCH, LK_ITERS, True, thresh))
                p_ms = _median_ms(lambda: lk_level_plain(
                    *args, LK_PATCH, LK_ITERS, True))
                fields.update(kernel_ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}")
                if (H, W) == LK_CASES[0][:2]:
                    ms, plain_ms = k_ms, p_ms
            say("lk", **fields)
            if agree < LK_OK_AGREE:
                raise AssertionError(f"lk ({H},{W}) pallas={pallas}: ok agrees "
                                     f"on {agree:.4f} of rows")
            if not err <= LK_ATOL_PX:
                raise AssertionError(f"lk ({H},{W}) pallas={pallas}: pt1 "
                                     f"differs by {err} px")
            if int(m.sum()) < N // 4 or max(abs(flow[0] + LK_FLOW[0]),
                                            abs(flow[1] + LK_FLOW[1])) > 0.05:
                raise AssertionError(f"lk ({H},{W}) pallas={pallas}: median "
                                     f"flow {flow} on {int(m.sum())} slots")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def _stage(cfg, dev, seed: int):
    from lmono_tpu_torch.io import synthetic as syn
    from lmono_tpu_torch.utils.lie import Pose

    scene = syn.make_city_scene(device=dev)
    traj = syn.circuit_trajectory(N_FRAMES, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    frames = [syn.simulate_lidar(scene, Pose(traj.t[i], traj.q[i]), cfg,
                                 NOISE_STD_M, generator=g)
              for i in range(N_FRAMES)]
    chunks = [{k: torch.stack([f[k] for f in frames[c:c + CHUNK]])
               for k in ("points", "ranges", "valid")}
              for c in range(0, N_FRAMES, CHUNK)]
    torch.cuda.synchronize()
    return chunks, traj


def slice_phase(name: str, cfg, dev, seed: int, compare_cpu: bool) -> dict:
    from lmono_tpu_torch.eval.ate import ate_rmse
    from lmono_tpu_torch.eval.kitti_metrics import kitti_odometry_errors
    from lmono_tpu_torch.lidar.odometry import LidarOdometry
    from lmono_tpu_torch.ops import knn as knn_mod
    from lmono_tpu_torch.ops.cuda import knn as knn_cuda_mod
    from lmono_tpu_torch.utils.lie import Pose

    chunks, traj = _stage(cfg, dev, seed)
    staged = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    odo = LidarOdometry(cfg, device=dev)
    knn_cuda_mod.knn_kernel_launches = 0
    knn_mod.knn_plain_calls = 0
    outs = [odo.process_chunk(c) for c in chunks[:WARMUP_CHUNKS]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in chunks[WARMUP_CHUNKS:]:
        outs.append(odo.process_chunk(c))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = knn_cuda_mod.knn_kernel_launches
    plain_calls = knn_mod.knn_plain_calls
    peak = torch.cuda.max_memory_allocated()

    est = Pose(torch.cat([o["pose"].t for o in outs]),
               torch.cat([o["pose"].q for o in outs]))
    if est.t.shape != (N_FRAMES, 3) or est.q.shape != (N_FRAMES, 4):
        raise AssertionError(f"{name}: pose shapes {est.t.shape}, {est.q.shape}")
    if not (torch.isfinite(est.t).all() and torch.isfinite(est.q).all()):
        raise AssertionError(f"{name}: non-finite poses")
    ate = ate_rmse(est, traj)
    drift = kitti_odometry_errors(est, traj, lengths=DRIFT_LENGTHS_M)
    fps = (len(chunks) - WARMUP_CHUNKS) * CHUNK / dt
    per_frame = outs[-1]["inliers"].float().mean().item()
    say(name, frames=N_FRAMES, fps=f"{fps:.3f}", ate_m=f"{ate:.6f}",
        drift_pct_20_80m=f"{drift['t_err_pct']:.4f}",
        knn_launches=launches, knn_plain_calls=plain_calls,
        mean_inliers_last_chunk=f"{per_frame:.1f}",
        peak_mem_bytes=peak, staged_frames_bytes=staged)
    if not ate < ATE_GATE_M:
        raise AssertionError(f"{name}: ATE {ate} m fails the {ATE_GATE_M} m gate")
    n_outer = max(1, (cfg.scan_to_map_iters + 1) // 2)
    if launches != 2 * n_outer * N_FRAMES:
        raise AssertionError(f"{name}: {launches} kernel launches, "
                             f"expected {2 * n_outer * N_FRAMES}")
    if plain_calls != 0:
        raise AssertionError(f"{name}: {plain_calls} plain KNN calls on CUDA")

    if compare_cpu:
        # the same first frames through the CPU path (plain KNN)
        cpu = LidarOdometry(cfg, device="cpu")
        first = {k: v[:CPU_CHECK_FRAMES].cpu() for k, v in chunks[0].items()}
        ref = cpu.process_chunk(first)["pose"]
        dt_ = (est.t[:CPU_CHECK_FRAMES].cpu() - ref.t).abs().max().item()
        dq_ = (est.q[:CPU_CHECK_FRAMES].cpu() - ref.q).abs().max().item()
        say(name + "-vs-cpu", frames=CPU_CHECK_FRAMES, max_dt_m=dt_, max_dq=dq_)
        if not (dt_ < CPU_ATOL_T and dq_ < CPU_ATOL_Q):
            raise AssertionError(f"{name}: CUDA and CPU poses differ "
                                 f"(dt {dt_} m, dq {dq_})")
    return {"launches": launches, "fps": fps, "ate": ate}


def _track_errors(scene, poses, cam_cfg, outs) -> torch.Tensor:
    """Frame-to-frame error (px) of every track carried from frame i-1 to
    i, against where the simulator puts the point seen at frame i-1."""
    from lmono_tpu_torch.io.synthetic import reproject_pixels

    errs = []
    for i in range(1, len(outs)):
        carried = outs[i].alive & (outs[i].track_cnt >= 2)
        truth, hit = reproject_pixels(scene, poses[i - 1], poses[i], cam_cfg,
                                      outs[i - 1].uv)
        m = carried & hit
        errs.append(torch.linalg.norm(outs[i].uv - truth, dim=-1)[m])
    return torch.cat(errs)


def tracker_phase(name: str, cfg, dev, seed: int, compare_cpu: bool) -> dict:
    from lmono_tpu_torch.camera import camera_from_config
    from lmono_tpu_torch.estimator.tracker import FeatureTracker
    from lmono_tpu_torch.io import synthetic as syn
    from lmono_tpu_torch.ops import lk as lk_mod
    from lmono_tpu_torch.ops.cuda import lk as lk_cuda_mod
    from lmono_tpu_torch.utils.lie import Pose

    cam_cfg, tcfg = cfg.camera, cfg.tracker
    H, W = cam_cfg.height, cam_cfg.width
    scene = syn.make_city_scene(device=dev)
    traj = syn.circuit_trajectory(N_FRAMES, device=dev)
    T_LC = syn.synthetic_T_CL(device=dev).inverse()
    poses = [Pose(traj.t[i], traj.q[i]).compose(T_LC) for i in range(N_FRAMES)]
    frames = [syn.render_camera(scene, p, cam_cfg) for p in poses]
    torch.cuda.synchronize()
    cam = camera_from_config(cam_cfg)
    torch.cuda.reset_peak_memory_stats()
    tracker = FeatureTracker(cam, tcfg, H, W, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(seed))
    lk_cuda_mod.lk_kernel_launches = 0
    lk_mod.lk_plain_calls = 0
    outs = [tracker.process(f) for f in frames[:TRACK_WARMUP]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs += [tracker.process(f) for f in frames[TRACK_WARMUP:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = lk_cuda_mod.lk_kernel_launches
    plain_calls = lk_mod.lk_plain_calls
    peak = torch.cuda.max_memory_allocated()

    for o in outs:
        if o.uv.shape != (tcfg.max_features, 2):
            raise AssertionError(f"{name}: uv shape {tuple(o.uv.shape)}")
    alive = torch.stack([o.alive for o in outs])
    uv = torch.stack([o.uv for o in outs])
    if not torch.isfinite(uv[alive]).all():
        raise AssertionError(f"{name}: non-finite positions of live slots")
    errs = _track_errors(scene, poses, cam_cfg, outs)
    carried = torch.stack([(o.alive & (o.track_cnt >= 2)).sum() for o in outs[1:]])
    med = float(errs.median())
    p90 = float(torch.quantile(errs, 0.9))
    mean_carried = float(carried.float().mean())
    fps = (N_FRAMES - TRACK_WARMUP) / dt
    say(name, frames=N_FRAMES, size=f"{W}x{H}", slots=tcfg.max_features,
        levels=tcfg.pyramid_levels, fps=f"{fps:.3f}", median_err_px=f"{med:.4f}",
        p90_err_px=f"{p90:.4f}", tracks_scored=errs.numel(),
        mean_carried=f"{mean_carried:.2f}", min_carried=int(carried.min()),
        lk_launches=launches, lk_plain_calls=plain_calls, peak_mem_bytes=peak)
    want = 2 * tcfg.pyramid_levels * N_FRAMES
    if launches != want:
        raise AssertionError(f"{name}: {launches} K2 launches, expected {want}")
    if plain_calls != 0:
        raise AssertionError(f"{name}: {plain_calls} plain LK calls on CUDA")
    if not med < TRACK_ERR_GATE_PX:
        raise AssertionError(f"{name}: median track error {med} px")
    if not mean_carried >= CARRIED_SHARE * tcfg.max_features:
        raise AssertionError(f"{name}: {mean_carried} tracks carried per frame")

    if compare_cpu:
        # the first frames on both paths, with the same RANSAC noise
        gpu = FeatureTracker(cam, tcfg, H, W, device=dev)
        cpu = FeatureTracker(cam, tcfg, H, W, device="cpu")
        worst_alive, worst_uv = 1.0, 0.0
        for f in frames[:CPU_CHECK_FRAMES]:
            noise = gpu.gumbel()
            a = gpu.process(f, noise)
            b = cpu.process(f.cpu(), noise.cpu())
            a_alive, a_uv = a.alive.cpu(), a.uv.cpu()
            agree = float((a_alive == b.alive).float().mean())
            both = a_alive & b.alive
            d = float((a_uv - b.uv).abs()[both].max()) if both.any() else 0.0
            worst_alive, worst_uv = min(worst_alive, agree), max(worst_uv, d)
        say(name + "-vs-cpu", frames=CPU_CHECK_FRAMES,
            min_alive_agree=f"{worst_alive:.4f}", max_uv_diff_px=worst_uv)
        if worst_alive < TRACK_CPU_ALIVE_AGREE or not worst_uv < TRACK_CPU_ATOL_PX:
            raise AssertionError(f"{name}: CUDA and CPU trackers differ "
                                 f"(alive {worst_alive}, uv {worst_uv} px)")
    return {"launches": launches, "fps": fps, "median_err": med}


def main() -> None:
    name = device_phase()
    from lmono_tpu_torch.config import kitti_scale_config, synthetic_config

    dev = torch.device("cuda", 0)
    build_phase()
    knn = knn_phase(dev)
    lk = lk_phase(dev)
    slice_phase("synthetic", synthetic_config().lidar, dev, seed=100,
                compare_cpu=True)
    kitti = slice_phase("kitti", kitti_scale_config().lidar, dev, seed=200,
                        compare_cpu=False)
    tracker_phase("tracker-synthetic", synthetic_config(), dev, seed=300,
                  compare_cpu=True)
    tracker_kitti = tracker_phase("tracker-kitti", kitti_scale_config(), dev,
                                  seed=400, compare_cpu=False)
    print(json.dumps({"kernels": [{
        "name": "knn", "route": "cuda",
        "source": "lmono_tpu_torch/csrc/knn.cu",
        "replaces": "lmono_tpu/ops/pallas/knn.py:90",
        "launches": kitti["launches"],
        "max_abs_err": knn["max_abs_err"],
        "ms": knn["ms"], "plain_ms": knn["plain_ms"]}, {
        "name": "lk", "route": "cuda",
        "source": "lmono_tpu_torch/csrc/lk.cu",
        "replaces": "lmono_tpu/ops/pallas/lk.py:109",
        "launches": tracker_kitti["launches"],
        "max_abs_err": lk["max_abs_err"],
        "ms": lk["ms"], "plain_ms": lk["plain_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
