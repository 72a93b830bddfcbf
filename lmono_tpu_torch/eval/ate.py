"""Trajectory evaluation: ATE RMSE (with optional SE(3)/Sim(3) alignment),
RPE, and TUM trajectory files.

Port of `lmono_tpu/eval/ate.py`.  The alignment arithmetic is numpy in
float64, as in the JAX package; RPE runs batched `Pose` ops in f32 on the
poses' device.  Poses may hold tensors on any device or numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from lmono_tpu_torch.utils.lie import Pose, quat_to_mat


def to_numpy(x) -> np.ndarray:
    """A tensor on any device, or an array-like, as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = False):
    """Least-squares similarity transform aligning src→dst (both (N,3)).

    Returns (s, R, t) with dst ≈ s * R @ src + t.
    """
    src = np.asarray(to_numpy(src), np.float64)
    dst = np.asarray(to_numpy(dst), np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est: Pose, gt: Pose, align: bool = True,
             with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE in meters after optional alignment."""
    p_est = np.asarray(to_numpy(est.t), np.float64)
    p_gt = np.asarray(to_numpy(gt.t), np.float64)
    n = min(len(p_est), len(p_gt))
    p_est, p_gt = p_est[:n], p_gt[:n]
    if align:
        s, R, t = umeyama_alignment(p_est, p_gt, with_scale)
        p_est = (s * (R @ p_est.T)).T + t
    err = p_est - p_gt
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def rpe(est: Pose, gt: Pose, delta: int = 1) -> dict:
    """Relative pose error over `delta`-frame steps: translational RMSE (m)
    and rotational RMSE (deg)."""
    def as_pose(p: Pose) -> Pose:
        return Pose(torch.as_tensor(p.t), torch.as_tensor(p.q))

    est, gt = as_pose(est), as_pose(gt)
    gt = Pose(gt.t.to(est.t.device), gt.q.to(est.q.device))
    m = max(min(est.t.shape[0], gt.t.shape[0]) - delta, 0)   # pairs

    def rel(p: Pose) -> Pose:
        return Pose(p.t[:m], p.q[:m]).between(
            Pose(p.t[delta:delta + m], p.q[delta:delta + m]))

    diff = rel(gt).between(rel(est))
    t_err = to_numpy(torch.linalg.vector_norm(diff.t, dim=-1))
    R = quat_to_mat(diff.q)
    cos_a = (torch.diagonal(R, dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    ang = to_numpy(torch.rad2deg(torch.arccos(torch.clamp(cos_a, -1, 1))))
    return {
        "trans_rmse": float(np.sqrt((t_err ** 2).mean())),
        "rot_rmse_deg": float(np.sqrt((ang ** 2).mean())),
    }


def save_tum(path: str, poses: Pose, times=None) -> None:
    """Write TUM-format `t x y z qx qy qz qw` rows (the reference's
    `Estimator.cc:642-644` layout; quaternions are (w,x,y,z) internally)."""
    t_arr = to_numpy(poses.t)
    q_arr = to_numpy(poses.q)
    n = len(t_arr)
    times = np.arange(n, dtype=np.float64) * 0.1 if times is None else times
    with open(path, "w") as f:
        for i in range(n):
            x, y, z = t_arr[i]
            w, qx, qy, qz = q_arr[i]
            f.write(f"{times[i]:.6f} {x:.6f} {y:.6f} {z:.6f} "
                    f"{qx:.6f} {qy:.6f} {qz:.6f} {w:.6f}\n")


def load_tum(path: str):
    """Read TUM rows → (times, Pose of f32 CPU tensors)."""
    data = np.loadtxt(path, ndmin=2)
    qxyzw = data[:, 4:8]
    q = np.stack([qxyzw[:, 3], qxyzw[:, 0], qxyzw[:, 1], qxyzw[:, 2]], -1)
    return data[:, 0], Pose(torch.tensor(data[:, 1:4], dtype=torch.float32),
                            torch.tensor(q, dtype=torch.float32))
