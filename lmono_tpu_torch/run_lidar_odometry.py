"""Run LiDAR-only odometry end to end and report ATE and throughput.

Port of `examples/run_lidar_odometry.py` (BASELINE.json's config 1, "KITTI
00 LiDAR-only odometry"): `LidarOdometry.process` once per sweep, on a
KITTI sequence when `--kitti-root` is given (`io/kitti.py:KittiSequence`),
else on sweeps simulated along the synthetic circuit on the device.  Prints
the ATE and frames/s (the simulator and the file reads excluded) and writes
the TUM trajectory into `--out`.  Runs on the CUDA card unless `--device`
names another device.

Usage:
    python -m lmono_tpu_torch.run_lidar_odometry [--frames N]
        [--kitti-root DIR --seq 0] [--out DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from lmono_tpu_torch import default_device
from lmono_tpu_torch.config import kitti_config, synthetic_config
from lmono_tpu_torch.eval.ate import ate_rmse, save_tum
from lmono_tpu_torch.lidar.odometry import LidarOdometry
from lmono_tpu_torch.utils.lie import Pose, pose_stack

NOISE_STD_M = 0.01      # range noise of the simulated sweeps
NOISE_SEED = 100


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(odo: LidarOdometry, scan: dict) -> tuple[dict, float]:
    _sync(odo.device)
    t0 = time.perf_counter()
    out = odo.process(scan)
    _sync(odo.device)
    return out, time.perf_counter() - t0


def _host(p: Pose) -> Pose:
    return Pose(p.t.cpu(), p.q.cpu())


def run_synthetic(n_frames: int, out_dir: str, device=None) -> dict:
    """Odometry over `n_frames` sweeps of the circuit, simulated on the
    device with NOISE_STD_M range noise from a generator seeded NOISE_SEED."""
    from lmono_tpu_torch.io import synthetic as syn

    dev = default_device(device)
    cfg = synthetic_config()
    scene = syn.make_city_scene(device=dev)
    traj = syn.circuit_trajectory(n_frames, device=dev)
    g = torch.Generator(device=dev).manual_seed(NOISE_SEED)
    odo = LidarOdometry(cfg.lidar, device=dev)
    est, t_total = [], 0.0
    for i in range(n_frames):
        scan = syn.simulate_lidar(scene, Pose(traj.t[i], traj.q[i]), cfg.lidar,
                                  NOISE_STD_M, generator=g)
        out, dt = _timed(odo, scan)
        t_total += dt if i > 0 else 0.0
        est.append(out["pose"])
        if i % 10 == 0:
            print(f"frame {i:4d}  inliers={int(out['inliers'])} "
                  f"cost={float(out['cost']):.4f}", flush=True)
    est_traj = _host(pose_stack(est))
    ate = ate_rmse(est_traj, _host(traj))
    fps = (n_frames - 1) / max(t_total, 1e-9)
    print(f"ATE RMSE: {ate:.4f} m over {n_frames} frames")
    print(f"throughput: {fps:.2f} frames/s (excl. simulator)")
    path = os.path.join(out_dir, "lidar_odometry.txt")
    save_tum(path, est_traj)
    return {"ate": ate, "fps": fps, "trajectory": est_traj, "tum": path}


def run_kitti(root: str, seq: int, n_frames: int, out_dir: str,
              device=None) -> dict:
    """Odometry over a KITTI sequence's sweeps at `kitti_config(seq)`."""
    from lmono_tpu_torch.io.kitti import KittiSequence

    dev = default_device(device)
    cfg = kitti_config(seq)
    ds = KittiSequence(root, seq, cfg.lidar)
    n = min(n_frames, len(ds)) if n_frames else len(ds)
    odo = LidarOdometry(cfg.lidar, device=dev)
    est, t_total = [], 0.0
    for i in range(n):
        out, dt = _timed(odo, ds.frame(i)["scan"])
        t_total += dt if i > 0 else 0.0
        est.append(out["pose"])
    est_traj = _host(pose_stack(est))
    fps = (n - 1) / max(t_total, 1e-9)
    print(f"throughput: {fps:.2f} frames/s")
    ate = None
    if ds.gt_poses is not None:
        # the ground truth is in the camera frame: translations compared
        # after alignment
        ate = ate_rmse(est_traj, Pose(ds.gt_poses.t[:n], ds.gt_poses.q[:n]))
        print(f"ATE RMSE: {ate:.4f} m")
    path = os.path.join(out_dir, f"kitti{seq:02d}_lidar.txt")
    save_tum(path, est_traj)
    return {"ate": ate, "fps": fps, "trajectory": est_traj, "tum": path}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--kitti-root", type=str, default=None)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--out", type=str, default=tempfile.gettempdir(),
                    help="directory of the TUM trajectory")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.kitti_root:
        return run_kitti(args.kitti_root, args.seq, args.frames, args.out,
                         args.device)
    return run_synthetic(args.frames, args.out, args.device)


if __name__ == "__main__":
    main()
