"""Run the full SLAM system on a KITTI odometry sequence.

Port of `examples/run_kitti.py`: frames stream from the KITTI files through
the native prefetching loader (`native.py`) and the port's PNG codec into
`SlamSystem.process`, one frame per call; the outputs are the TUM and KITTI
trajectories, ATE/RPE/KITTI drift against the ground truth, the per-stage
timings and a colored PLY map.  Runs on the CUDA card unless `--device`
names another device (`--device cpu`); without a card and without
`--device` it raises.

Usage:
    python -m lmono_tpu_torch.run_kitti --root /data/kitti_odometry --seq 0 \\
        [--frames N] [--ply out.ply] [--no-loop] [--no-map] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

from lmono_tpu_torch import default_device
from lmono_tpu_torch.config import kitti_config
from lmono_tpu_torch.eval.ate import ate_rmse, rpe, save_tum
from lmono_tpu_torch.eval.kitti_metrics import (kitti_odometry_errors,
                                                save_kitti_poses)
from lmono_tpu_torch.io.kitti import KittiSequence
from lmono_tpu_torch.native import NativeScanLoader
from lmono_tpu_torch.pipeline import SlamSystem
from lmono_tpu_torch.utils.lie import Pose, pose_stack


def sequence_config(root: str, seq: int, rings: int = 0, horiz_res: int = 0):
    """(sequence, SystemConfig) as `main` builds them: `kitti_config(seq)`
    with the sequence's calibration and image size, and the scan grid
    overridden for non-HDL-64 or synthetic trees."""
    lidar_cfg = kitti_config().lidar
    if rings:
        lidar_cfg = dataclasses.replace(
            lidar_cfg, num_rings=rings,
            horiz_res=horiz_res or lidar_cfg.horiz_res,
            ring_mode="uniform" if rings != 64 else "auto")
    ds = KittiSequence(root, seq, lidar_cfg)
    return ds, ds.system_config().replace(lidar=lidar_cfg)


def main(argv=None) -> dict:
    """Returns the run's results: the SlamSystem, the streamed trajectory
    (on the host) and the throughput."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=str, required=True)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--ply", type=str, default=None)
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--no-map", action="store_true")
    ap.add_argument("--out", type=str, default=tempfile.gettempdir())
    ap.add_argument("--rings", type=int, default=0,
                    help="override scan rings (non-HDL64 / synthetic trees)")
    ap.add_argument("--horiz-res", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = default_device(args.device)

    # intrinsics + T_CL straight from the sequence's calib.txt, plus the
    # per-sequence knob deltas from kitti_config(seq)
    ds, cfg = sequence_config(args.root, args.seq, args.rings, args.horiz_res)
    n = min(args.frames, len(ds)) if args.frames else len(ds)
    print(f"KITTI seq {args.seq:02d}: {n} frames")

    loader = NativeScanLoader(ds.velo_dir, n, cfg.lidar)
    system = SlamSystem(cfg, enable_loop=not args.no_loop,
                        enable_mapping=not args.no_map, device=device, trace=True)

    est = []
    t_total = 0.0
    try:
        for i in range(n):
            scan = loader.next()
            if scan is None:
                break
            image = ds.image(i)
            if image is None:
                raise SystemExit(f"image_0/{i:06d}.png not found under {ds.img_dir}")
            t0 = time.perf_counter()
            out = system.process(
                {k: scan[k] for k in ("points", "ranges", "valid")},
                image, time=ds.time(i))
            t_total += time.perf_counter() - t0
            est.append(out["pose"])
            if i % 100 == 0:
                print(f"frame {i:5d} kf={int(out['is_keyframe'])} "
                      f"loops={system.n_loops}", flush=True)
    finally:
        loader.close()

    dev_traj = pose_stack(est)
    est_traj = Pose(dev_traj.t.cpu(), dev_traj.q.cpu())
    fps = (len(est) - 1) / max(t_total, 1e-9)
    print(f"throughput: {fps:.2f} frames/s")
    save_tum(os.path.join(args.out, f"kitti{args.seq:02d}_fused.txt"),
             est_traj)
    if ds.gt_poses is not None:
        gt = Pose(ds.gt_poses.t[: len(est)], ds.gt_poses.q[: len(est)])
        print(f"ATE RMSE: {ate_rmse(est_traj, gt, align=True):.4f} m")
        r = rpe(est_traj, gt, delta=10)
        print(f"RPE(10): {r['trans_rmse']:.4f} m / {r['rot_rmse_deg']:.3f}°")
        k = kitti_odometry_errors(est_traj, gt)
        if k["segments"]:
            print(f"KITTI drift: {k['t_err_pct']:.3f} %  /  "
                  f"{k['r_err_deg_per_m'] * 100:.4f} deg/100m")
    save_kitti_poses(
        os.path.join(args.out, f"kitti{args.seq:02d}_fused_kitti.txt"),
        est_traj)
    for k, v in system.tracer.summary().items():
        print(f"  span {k:22s}: median {v['median_ms']:8.2f} ms  "
              f"mean {v['mean_ms']:8.2f} ms × {v['count']}")
    if args.ply and not args.no_map:
        print(f"saved {system.save_map(args.ply)} points to {args.ply}")
    return {"system": system, "trajectory": est_traj, "fps": fps}


if __name__ == "__main__":
    main()
