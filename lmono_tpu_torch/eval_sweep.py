"""Per-sequence evaluation sweep over the KITTI presets.

Port of `examples/eval_sweep.py`.  Each preset of `kitti_config(seq)` (the
reference's per-sequence YAML deltas: feature counts, factor weights,
estimate_laser modes, fine_times) drives the fused pipeline
(`FusedPipeline.process_chunk`: odometry → KLT → window fusion) over frames
simulated on the device with the synthetic rig, and records ATE, KITTI
drift and frames/s per preset.  Sequence 02 (estimate_laser 2) calibrates
the LiDAR–camera extrinsic online from identity: it runs on the
rotation-rich figure-8 for at least 300 frames, and its row adds the
hand-eye adoption frame, the rotation errors at adoption and at the end,
and the ATE and frames/s before and after adoption.

Runs on the CUDA card unless `--device` names another device; writes only
to `--out`.

Usage:
    python -m lmono_tpu_torch.eval_sweep [--frames 160] [--seqs 0,1,2,3,4,5,8]
        [--device cpu] [--out eval_sweep.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

import torch

from lmono_tpu_torch import default_device
from lmono_tpu_torch.camera import camera_from_config
from lmono_tpu_torch.config import kitti_config
from lmono_tpu_torch.eval.ate import ate_rmse
from lmono_tpu_torch.eval.kitti_metrics import kitti_odometry_errors
from lmono_tpu_torch.fused import FusedPipeline
from lmono_tpu_torch.io import synthetic as syn
from lmono_tpu_torch.utils.lie import Pose, quat_conj, quat_mul

CHUNK = 20
MODE2_MIN_FRAMES = 300    # hand-eye pairs, adoption, then window refinement
NOISE_STD_M = 0.01        # range noise of the simulated sweeps
NOISE_SEED = 700


def rotation_error_deg(q_est: torch.Tensor, q_true: torch.Tensor) -> float:
    """Angle (degrees) of q_true⁻¹ ⊗ q_est."""
    dq = quat_mul(quat_conj(q_true), q_est)
    return math.degrees(2 * math.acos(min(1.0, abs(float(dq[0])))))


def _chunk_maker(scene, traj: Pose, cfg, T_CL: Pose, generator: torch.Generator):
    """make(i0): frames i0…i0+CHUNK−1 simulated along `traj`, stacked: the
    sweep with NOISE_STD_M range noise and the render through the rig."""
    T_LC = T_CL.inverse()

    def make(i0: int) -> dict:
        frames = []
        for i in range(i0, i0 + CHUNK):
            pose = Pose(traj.t[i], traj.q[i])
            s = syn.simulate_lidar(scene, pose, cfg.lidar, NOISE_STD_M,
                                   generator=generator)
            fr = {k: s[k] for k in ("points", "ranges", "valid")}
            fr["image"] = syn.render_camera(scene, pose.compose(T_LC), cfg.camera)
            frames.append(fr)
        return {k: torch.stack([f[k] for f in frames]) for k in frames[0]}

    return make


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _fps(frames: int, seconds: float):
    return frames / seconds if seconds > 0 else None


def run_preset(seq: int, n_frames: int, scene, traj: Pose,
               traj_excite: Pose | None = None, device=None,
               fine_times: int | None = None) -> dict:
    """One preset through `FusedPipeline.process_chunk` in chunks of CHUNK
    (the first chunk excluded from frames/s); returns its row.

    The rig's extrinsic seeds the estimator, except for estimate_laser == 2
    presets: they start from identity (`laser_to_camera=None`), run on
    `traj_excite` (the figure-8) and at least MODE2_MIN_FRAMES frames.
    `traj` (and `traj_excite`) must hold the frames run, rounded up to
    whole chunks.  fine_times: replaces the preset's count of extrinsic
    refinements before the extrinsic freezes (tests/test_fusion.py keeps
    the refinement live with 1000).
    """
    dev = default_device(device)
    cfg = kitti_config(seq)
    if fine_times is not None:
        cfg = cfg.replace(estimator=dataclasses.replace(cfg.estimator,
                                                        fine_times=fine_times))
    T_CL = syn.synthetic_T_CL(device=dev)
    cfg = cfg.replace(laser_to_camera=tuple(T_CL.to_mat4().reshape(-1).tolist()))
    mode2 = cfg.estimator.estimate_laser == 2
    if mode2:
        cfg = cfg.replace(laser_to_camera=None)
        if traj_excite is not None:
            traj = traj_excite
        n_frames = max(n_frames, MODE2_MIN_FRAMES)
    cam = camera_from_config(cfg.camera)
    make = _chunk_maker(scene, traj, cfg, T_CL,
                        torch.Generator(device=dev).manual_seed(NOISE_SEED))
    fp = FusedPipeline(cfg, cam, None if mode2 else T_CL, device=dev)
    n_chunks = max(n_frames // CHUNK, 2)
    outs, seconds = [], []
    for c in range(n_chunks):
        chunk = make(c * CHUNK)
        _sync(dev)
        t0 = time.perf_counter()
        outs.append(fp.process_chunk(chunk))
        _sync(dev)
        seconds.append(time.perf_counter() - t0)
    n = n_chunks * CHUNK
    res = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    est = Pose(res["pose_t"], res["pose_q"])
    laser = Pose(res["laser_t"], res["laser_q"])
    gt = Pose(traj.t[:n], traj.q[:n])
    errs = kitti_odometry_errors(est, gt, lengths=(50.0, 100.0, 150.0))
    full = torch.arange(n) >= cfg.estimator.window_size
    keyframes = int((res["is_keyframe"].cpu() & full).sum())
    attempts = res["lm_attempts"]
    solved = int((attempts > 0).sum())
    row = {
        "seq": seq,
        "frames": n,
        "features": cfg.tracker.max_features,
        "factor_weight": cfg.estimator.factor_weight,
        "estimate_laser": cfg.estimator.estimate_laser,
        "fine_times": cfg.estimator.fine_times,
        "fps": _fps((n_chunks - 1) * CHUNK, sum(seconds[1:])),
        "ate_m": ate_rmse(est, gt),
        "laser_ate_m": ate_rmse(laser, gt),
        "drift_pct": errs["t_err_pct"],
        "rot_deg_per_m": errs["r_err_deg_per_m"],
        "keyframes": keyframes,
        "non_keyframes": int(full.sum()) - keyframes,
        "lm_attempts_per_solve": int(attempts.sum()) / max(solved, 1),
        "readbacks_per_frame": int(res["readbacks"].sum()) / n,
        "initialized": bool(res["initialized"][-1]),
    }
    if mode2:
        row.update(_calibration_row(res, est, laser, gt, T_CL, seconds))
    print(row, flush=True)
    return row


def _calibration_row(res: dict, est: Pose, laser: Pose, gt: Pose, T_CL: Pose,
                     seconds: list) -> dict:
    """The estimate_laser == 2 keys: the window extrinsic's errors at the
    end (`handeye_rot_err_deg`, the reference's key), the adoption frame and
    the hand-eye estimate's error there, and ATE and frames/s before and
    after adoption (chunks that straddle it count in neither)."""
    conv = res["handeye_converged"].cpu()
    n = conv.shape[0]
    adopt = int(torch.argmax(conv.to(torch.int32))) if bool(conv.any()) else None
    ex_q, ex_t = res["ex_q"][-1], res["ex_t"][-1]
    row = {
        "handeye_rot_err_deg": rotation_error_deg(ex_q, T_CL.q),
        "handeye_converged": bool(conv[-1]),
        "ex_trans_err_m": float(torch.linalg.vector_norm(ex_t - T_CL.t)),
        "adoption_frame": adopt,
        "handeye_rot_err_at_adoption_deg": None if adopt is None else
        rotation_error_deg(res["handeye_q"][adopt], T_CL.q),
    }
    for name, lo, hi in (("before", 0, n if adopt is None else adopt),
                         ("after", n if adopt is None else adopt, n)):
        seg = slice(lo, hi)
        ok = hi - lo >= 3
        row[f"ate_{name}_adoption_m"] = ate_rmse(
            Pose(est.t[seg], est.q[seg]), Pose(gt.t[seg], gt.q[seg])) if ok else None
        row[f"laser_ate_{name}_adoption_m"] = ate_rmse(
            Pose(laser.t[seg], laser.q[seg]), Pose(gt.t[seg], gt.q[seg])) if ok else None
        chunks = [c for c in range(1, len(seconds))
                  if lo <= c * CHUNK and (c + 1) * CHUNK <= hi]
        row[f"fps_{name}_adoption"] = _fps(len(chunks) * CHUNK,
                                           sum(seconds[c] for c in chunks))
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=160)
    ap.add_argument("--seqs", type=str, default="0,1,2,3,4,5,8")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", type=str, default="eval_sweep.json")
    args = ap.parse_args(argv)
    dev = default_device(args.device)

    scene = syn.make_city_scene(device=dev)
    n = max(args.frames, 2 * CHUNK)          # run_preset runs whole chunks, at least 2
    traj = syn.circuit_trajectory(n, device=dev)
    traj8 = syn.figure8_trajectory(max(n, MODE2_MIN_FRAMES), device=dev)
    rows = [run_preset(int(s), args.frames, scene, traj, traj_excite=traj8, device=dev)
            for s in args.seqs.split(",")]
    out = {"frames_per_seq": args.frames,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
           "note": ("fused pipeline (odometry + KLT + window fusion) under each "
                    "reference per-sequence preset on a simulated drive; ATE "
                    "against the simulator's truth, devkit drift over 50-150 m "
                    "segments"),
           "rows": rows}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
