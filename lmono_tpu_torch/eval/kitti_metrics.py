"""KITTI odometry benchmark metrics (devkit protocol).

Port of `lmono_tpu/eval/kitti_metrics.py`: average translational drift (%)
and rotational drift (deg/m) over all sub-sequences of the given path
lengths (the devkit's 100..800 m by default), starting every `step`-th
frame, and KITTI's 12-number pose files.
"""

from __future__ import annotations

import numpy as np
import torch

from lmono_tpu_torch.eval.ate import to_numpy
from lmono_tpu_torch.utils.lie import Pose, mat_to_quat, quat_to_mat

KITTI_LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)
_STEP = 10  # devkit evaluates every 10th frame as a sub-sequence start


def poses_to_mats(poses: Pose) -> np.ndarray:
    """(N,) Pose → (N, 4, 4) float64 homogeneous matrices."""
    q = torch.as_tensor(to_numpy(poses.q), dtype=torch.float32)
    R = quat_to_mat(q).numpy().astype(np.float64)
    t = np.asarray(to_numpy(poses.t), np.float64)
    T = np.tile(np.eye(4), (len(t), 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = t
    return T


def trajectory_distances(T: np.ndarray) -> np.ndarray:
    """Cumulative path length at each frame (devkit `trajectoryDistances`)."""
    d = np.zeros(len(T))
    steps = np.linalg.norm(T[1:, :3, 3] - T[:-1, :3, 3], axis=-1)
    d[1:] = np.cumsum(steps)
    return d


def _first_frame_from_dist(dist: np.ndarray, start: int, length: float) -> int:
    idx = np.searchsorted(dist, dist[start] + length)
    return int(idx) if idx < len(dist) else -1


def _rot_err(dT: np.ndarray) -> float:
    c = (np.trace(dT[:3, :3]) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def kitti_odometry_errors(est: Pose, gt: Pose,
                          lengths=KITTI_LENGTHS,
                          step: int = _STEP) -> dict:
    """KITTI devkit sequence errors.

    For every start frame (stride `step`) and every segment length L in
    `lengths`, find the frame where the ground-truth path length has grown by
    L, compare the relative motions, and normalize by L.  Returns the devkit
    averages plus the per-segment table; NaN when no segment fits.
    """
    T_est = poses_to_mats(est)
    T_gt = poses_to_mats(gt)
    n = min(len(T_est), len(T_gt))
    T_est, T_gt = T_est[:n], T_gt[:n]
    dist = trajectory_distances(T_gt)

    rows = []  # (first_frame, r_err per m, t_err per m, length)
    for first in range(0, n, step):
        for L in lengths:
            last = _first_frame_from_dist(dist, first, L)
            if last < 0:
                continue
            d_gt = np.linalg.inv(T_gt[first]) @ T_gt[last]
            d_est = np.linalg.inv(T_est[first]) @ T_est[last]
            err = np.linalg.inv(d_est) @ d_gt
            rows.append((first,
                         _rot_err(err) / L,
                         float(np.linalg.norm(err[:3, 3])) / L,
                         L))
    if not rows:
        return {"t_err_pct": float("nan"), "r_err_deg_per_m": float("nan"),
                "segments": []}
    r = np.array([x[1] for x in rows])
    t = np.array([x[2] for x in rows])
    return {
        # devkit headline numbers: % translation drift, deg/m rotation drift
        "t_err_pct": float(t.mean() * 100.0),
        "r_err_deg_per_m": float(np.rad2deg(r.mean())),
        "segments": rows,
    }


def save_kitti_poses(path: str, poses: Pose) -> None:
    """Write KITTI 12-number rows (row-major 3x4 [R|t] per line)."""
    T = poses_to_mats(poses)
    with open(path, "w") as f:
        for Ti in T:
            f.write(" ".join(f"{v:.9e}" for v in Ti[:3].reshape(-1)) + "\n")


def load_kitti_poses(path: str) -> Pose:
    """Read KITTI 12-number rows → Pose of f32 CPU tensors."""
    data = torch.tensor(np.loadtxt(path, ndmin=2).reshape(-1, 3, 4),
                        dtype=torch.float32)
    return Pose(data[:, :, 3].contiguous(), mat_to_quat(data[:, :, :3]))
