"""Drive the full SLAM system (odometry + fusion + loop + dense map) on the
synthetic world; prints ATE, throughput, loop statistics and stage timings.

Port of `examples/run_full_pipeline.py` (BASELINE.json's configs 2-4 on
synthetic data): `SlamSystem.process` once per frame, each frame (a sweep
with range noise and a render through the synthetic rig) simulated on the
device just before it.  Prints the streaming ATE, the retro-corrected ATE
(loop on), frames/s (the simulator excluded), closures, the extrinsic
estimate and the stage medians; writes the TUM trajectory into `--out` and,
with the map on, a PLY to `--ply`.  Runs on the CUDA card unless `--device`
names another device.

Usage:
    python -m lmono_tpu_torch.run_full_pipeline [--frames 120] [--no-loop]
        [--no-map] [--ply map.ply] [--out DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from lmono_tpu_torch import default_device
from lmono_tpu_torch.config import synthetic_config
from lmono_tpu_torch.eval.ate import ate_rmse, save_tum
from lmono_tpu_torch.io import synthetic as syn
from lmono_tpu_torch.pipeline import SlamSystem
from lmono_tpu_torch.utils.lie import Pose, pose_stack

NOISE_STD_M = 0.01      # range noise of the simulated sweeps
NOISE_SEED = 0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _host(p: Pose) -> Pose:
    return Pose(p.t.cpu(), p.q.cpu())


def run(n_frames: int, loop: bool = True, mapping: bool = True,
        save_ply: str | None = None, out_dir: str = ".", device=None) -> dict:
    """The drive; returns the system, the streamed and (loop on) retro-
    corrected trajectories on the host, their ATEs, frames/s and the count
    of map points written (None without a PLY)."""
    dev = default_device(device)
    cfg = synthetic_config()
    scene = syn.make_city_scene(device=dev)
    traj = syn.circuit_trajectory(n_frames, device=dev)
    T_CL = syn.synthetic_T_CL(device=dev)
    T_LC = T_CL.inverse()
    cfg = cfg.replace(laser_to_camera=tuple(
        T_CL.to_mat4().reshape(-1).cpu().tolist()))
    g = torch.Generator(device=dev).manual_seed(NOISE_SEED)

    system = SlamSystem(cfg, enable_loop=loop, enable_mapping=mapping, device=dev,
                        trace=True)
    est, t_total, out = [], 0.0, None
    for i in range(n_frames):
        pose_wl = Pose(traj.t[i], traj.q[i])
        scan = syn.simulate_lidar(scene, pose_wl, cfg.lidar, NOISE_STD_M,
                                  generator=g)
        img = syn.render_camera(scene, pose_wl.compose(T_LC), cfg.camera)
        _sync(dev)
        t0 = time.perf_counter()
        out = system.process(scan, img)
        _sync(dev)
        t_total += time.perf_counter() - t0 if i > 0 else 0.0
        est.append(out["pose"])
        if i % 20 == 0:
            print(f"frame {i:4d} kf={int(out['is_keyframe'])} "
                  f"init={int(out['initialized'])} "
                  f"tracked={out['n_tracked']} loop={int(out['loop'])}",
                  flush=True)

    est_traj = _host(pose_stack(est))
    gt = _host(traj)
    ate = ate_rmse(est_traj, gt)
    fps = (n_frames - 1) / max(t_total, 1e-9)
    print(f"\nATE RMSE (streaming): {ate:.4f} m over {n_frames} frames")
    res = {"system": system, "trajectory": est_traj, "ate": ate, "fps": fps,
           "final_trajectory": None, "final_ate": None, "map_points": None}
    if loop:
        final = _host(system.final_trajectory())
        res.update(final_trajectory=final, final_ate=ate_rmse(final, gt))
        print(f"ATE RMSE (retro-corrected): {res['final_ate']:.4f} m")
    print(f"throughput: {fps:.2f} frames/s (full pipeline, excl. simulator)")
    print(f"loops closed: {system.n_loops}")
    ex_t = out["extrinsic"].t.cpu().numpy()
    print(f"extrinsic estimate t: {np.round(ex_t, 4)} "
          f"(true {np.round(T_CL.t.cpu().numpy(), 4)})")
    for k, v in system.tracer.summary().items():
        print(f"  span {k:22s}: median {v['median_ms']:8.2f} ms  "
              f"mean {v['mean_ms']:8.2f} ms × {v['count']}")
    res["tum"] = os.path.join(out_dir, "full_pipeline.txt")
    save_tum(res["tum"], est_traj)
    if save_ply and mapping:
        res["map_points"] = system.save_map(save_ply)
        print(f"saved {res['map_points']} map points to {save_ply}")
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--no-map", action="store_true")
    ap.add_argument("--ply", type=str, default=None)
    ap.add_argument("--out", type=str, default=tempfile.gettempdir(),
                    help="directory of the TUM trajectory")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    return run(args.frames, not args.no_loop, not args.no_map, args.ply,
               args.out, args.device)


if __name__ == "__main__":
    main()
