#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`lmono_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's LiDAR-odometry slice through `LidarOdometry.process_chunk`
and checks every kernel on its path against its plain PyTorch version:

1. device: the card, its power limit and the toolchain;
2. build: compiles the CUDA KNN kernel (`lmono_tpu_torch/csrc/knn.cu`);
3. knn: kernel against `knn_plain` at the odometry's shapes and a ragged
   case, with times of both;
4. synthetic: `synthetic_config().lidar`, 120 simulated frames in chunks of
   20 (as `bench.py` runs the JAX package), ATE gate 0.5 m, and the first
   frames again on the CPU (plain KNN) to compare poses;
5. kitti: `kitti_scale_config().lidar` (64×2048 scans, 1536/4096 feature
   slots, 32768/65536-point banks), 120 frames: ATE gate, fps, drift and
   peak memory, and exactly 6 kernel launches per frame with no plain KNN
   call.

Prints one JSON line of kernel results, the `nvidia-smi` name and power
limit, and last `{"ok": true, "device": {...}}`.  Any failed check raises,
so the exit code is non-zero and the last line is not printed.  Needs a
CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
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


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from lmono_tpu_torch.ops.cuda import knn as knn_cuda_mod

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    nvcc = subprocess.run([knn_cuda_mod._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    say("device", name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=repr(nvcc.splitlines()[-1]), python=sys.version.split()[0])
    return name


def build_phase() -> None:
    from lmono_tpu_torch.ops.cuda import knn as knn_cuda_mod

    t0 = time.perf_counter()
    report = knn_cuda_mod.build()
    say("build", kernel="knn", seconds=f"{time.perf_counter() - t0:.2f}")
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


def main() -> None:
    name = device_phase()
    from lmono_tpu_torch.config import kitti_scale_config, synthetic_config

    dev = torch.device("cuda", 0)
    build_phase()
    knn = knn_phase(dev)
    slice_phase("synthetic", synthetic_config().lidar, dev, seed=100,
                compare_cpu=True)
    kitti = slice_phase("kitti", kitti_scale_config().lidar, dev, seed=200,
                        compare_cpu=False)
    print(json.dumps({"kernels": [{
        "name": "knn", "route": "cuda",
        "source": "lmono_tpu_torch/csrc/knn.cu",
        "replaces": "lmono_tpu/ops/pallas/knn.py:90",
        "launches": kitti["launches"],
        "max_abs_err": knn["max_abs_err"],
        "ms": knn["ms"], "plain_ms": knn["plain_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
