"""Trajectory evaluation: ATE RMSE with optional SE(3)/Sim(3) alignment.

Port of `lmono_tpu/eval/ate.py` (`umeyama_alignment`, `ate_rmse`).  The
arithmetic is numpy in float64, as in the JAX package; poses may hold
tensors on any device or numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from lmono_tpu_torch.utils.lie import Pose


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
