"""Initialization: hand-eye extrinsic rotation (AX=XB) + relative pose from
the essential matrix.

Port of `lmono_tpu/estimator/initializer.py` (the reference's `AXXBSolver`
and `MotionEstimator`): camera relative rotations come from decomposing the
fundamental matrix of an 8-point RANSAC on normalized coords; the extrinsic
rotation solves the stacked quaternion system with Huber angular
weighting, adopted on an ensemble gate (excitation, volume, fit,
stability).

The RANSAC draws come in as Gumbel noise of shape (96, 8, N), as
`ops/ransac.py:masked_categorical` takes it.  `decompose_essential`'s SVD
fixes each basis only up to signs: another LAPACK may return R1 and R2 in
the other order or flip t, and the cheirality vote then picks the same
rotation from the other slot.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from lmono_tpu_torch.ops.ransac import masked_categorical, ransac_fundamental
from lmono_tpu_torch.utils.lie import (
    mat_to_quat,
    quat_conj,
    quat_identity,
    quat_mul,
    so3_log_quat,
)
from lmono_tpu_torch.utils.timing import read

RP_ITERS = 96                      # hypotheses of relative_pose_from_tracks
RP_THRESH = (1.5 / 460.0) ** 2     # squared Sampson distance, normalized
_DEG = 180.0 / math.pi


def decompose_essential(E: torch.Tensor):
    """E → (R1, R2, t) candidates (standard SVD factorization)."""
    # svd on CUDA checks its status on the host: a wait for the device
    U, _, Vt = read(torch.linalg.svd, E)
    # enforce proper rotations
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    return U @ W @ Vt, U @ W.T @ Vt, U[:, 2]


def _cheirality_count(R, t, x0, x1, mask):
    """Count correspondences triangulating in front of both cameras for
    candidates (R (..., 3, 3), t (..., 3)) with x1 ≈ proj(R x0 + t)
    (cam1-from-cam0).  Returns (...) counts."""
    d0 = torch.cat([x0, torch.ones_like(x0[..., :1])], -1)      # (N,3)
    d1 = torch.cat([x1, torch.ones_like(x1[..., :1])], -1)
    # two-view midpoint triangulation in cam0 frame
    d1_in0 = d1 @ R                                             # rows: Rᵀ d1
    # z0·R d0 − z1·d1 = −t  ⇒  2x2 normal equations per correspondence
    a00 = torch.sum(d0 * d0, -1)
    a01 = -torch.sum(d0 * d1_in0, -1)
    a11 = torch.sum(d1_in0 * d1_in0, -1)
    Rt_t = (R.transpose(-1, -2) @ t[..., None])[..., None, :, 0]  # (...,1,3)
    rhs0 = -torch.sum(d0 * Rt_t, -1)
    rhs1 = torch.sum(d1_in0 * Rt_t, -1)
    det = a00 * a11 - a01 * a01
    det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    z0 = (rhs0 * a11 - a01 * rhs1) / det
    z1 = (a00 * rhs1 - a01 * rhs0) / det
    return torch.sum((z0 > 0) & (z1 > 0) & mask, dim=-1)


def relative_pose_from_tracks(x0: torch.Tensor, x1: torch.Tensor,
                              mask: torch.Tensor, gumbel: torch.Tensor):
    """Camera rotation q_c (cam1-from-cam0) from tracked normalized coords.

    gumbel: (RP_ITERS, 8, N) standard Gumbel noise for the RANSAC draws.
    Returns (q_c, ok): ok requires ≥ 15 inliers and a clear cheirality vote.
    """
    inl, F = ransac_fundamental(x0, x1, mask, masked_categorical(mask, gumbel),
                                thresh=RP_THRESH)
    R1, R2, t = decompose_essential(F)
    cands_R = torch.stack([R1, R1, R2, R2])
    cands_t = torch.stack([t, -t, t, -t])
    votes = _cheirality_count(cands_R, cands_t, x0, x1, inl)
    best = torch.argmax(votes)
    R = cands_R[best]
    n_inl = torch.sum(inl)
    ok = (n_inl >= 15) & (votes[best] > 0.7 * n_inl)
    # R maps cam0→cam1 directions; the relative rotation of frames is Rᵀ
    return mat_to_quat(R.T), ok


class HandEyeState(NamedTuple):
    """Fixed-capacity ring of rotation pairs and the running estimate."""
    q_cam: torch.Tensor      # (K, 4) camera relative rotations
    q_las: torch.Tensor      # (K, 4) laser relative rotations
    mask: torch.Tensor       # (K,) bool
    n: torch.Tensor          # () int32 write cursor
    q_ex: torch.Tensor       # (4,) current estimate R_CL
    converged: torch.Tensor  # () bool
    stable: torch.Tensor     # () int32 — consecutive accepted updates with
                             # the estimate moving < 1°

    @staticmethod
    def init(capacity: int = 512, device=None) -> "HandEyeState":
        """capacity: rotation-pair ring size (σ₂ of the stacked system
        grows like √K·sin(θ/2); 512 ≈ 51 s of 10 Hz pairs)."""
        ident = quat_identity(device=device)
        return HandEyeState(
            q_cam=ident.repeat(capacity, 1),
            q_las=ident.repeat(capacity, 1),
            mask=torch.zeros((capacity,), dtype=torch.bool, device=device),
            n=torch.zeros((), dtype=torch.int32, device=device),
            q_ex=ident.clone(),
            converged=torch.zeros((), dtype=torch.bool, device=device),
            stable=torch.zeros((), dtype=torch.int32, device=device),
        )


def _quat_left(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([w, -x, -y, -z], -1),
        torch.stack([x, w, -z, y], -1),
        torch.stack([y, z, w, -x], -1),
        torch.stack([z, -y, x, w], -1),
    ], dim=-2)


def _quat_right(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([w, -x, -y, -z], -1),
        torch.stack([x, w, z, -y], -1),
        torch.stack([y, -z, w, x], -1),
        torch.stack([z, y, -x, w], -1),
    ], dim=-2)


def _angle(q: torch.Tensor) -> torch.Tensor:
    v = so3_log_quat(q)
    return torch.sqrt(torch.sum(v * v, dim=-1))


def handeye_update(st: HandEyeState, q_cam: torch.Tensor, q_las: torch.Tensor,
                   pair_ok: torch.Tensor) -> HandEyeState:
    """Insert one rotation pair and re-solve the stacked AX=XB system.

    Solves q_cam ⊗ q_ex = q_ex ⊗ q_las for q_ex = R_CL via the smallest
    singular vector of Σ w_i (L(q_cam_i) − R(q_las_i)), with Huber angular
    weights from the current estimate.  Pairs whose two rotation angles
    disagree are dropped (X-conjugate rotations have equal angles).
    """
    K = st.mask.shape[0]
    th_c, th_l = _angle(q_cam), _angle(q_las)
    pair_ok = pair_ok & (torch.abs(th_c - th_l)
                         < torch.clamp(0.15 * th_l, min=0.01))
    # the ring write at slot n % K, as a mask (no host read of the cursor)
    put = (torch.arange(K, device=st.n.device) == st.n % K) & pair_ok
    q_cam_b = torch.where(put[:, None], q_cam, st.q_cam)
    q_las_b = torch.where(put[:, None], q_las, st.q_las)
    mask_b = st.mask | put
    n_b = st.n + pair_ok.to(torch.int32)

    # angular residual under the current estimate, per pair
    pred = quat_mul(quat_mul(quat_conj(st.q_ex), q_cam_b), st.q_ex)
    deg = _angle(quat_mul(quat_conj(q_las_b), pred)) * _DEG
    huber = torch.where(deg > 5.0, 5.0 / torch.clamp(deg, min=1e-6), 1.0)
    w = huber * mask_b.to(torch.float32)

    A = (w[:, None, None] * (_quat_left(q_cam_b) - _quat_right(q_las_b)))
    _, S, Vt = read(torch.linalg.svd, A.reshape(-1, 4), False)
    q_ex = Vt[-1]
    q_ex = q_ex * torch.sign(q_ex[0] + 1e-12)
    q_ex = q_ex / torch.sqrt(torch.sum(q_ex * q_ex))
    # residual-consistency gate on top of the reference's σ₂: the weighted
    # mean angular residual under the new estimate must be small
    pred_new = quat_mul(quat_mul(quat_conj(q_ex), q_cam_b), q_ex)
    ang_new = _angle(quat_mul(quat_conj(q_las_b), pred_new))
    wsum = torch.clamp(torch.sum(w), min=1e-6)
    mean_res_deg = torch.sum(w * ang_new) / wsum * _DEG
    # stability: the estimate's motion per accepted pair, in degrees
    move_deg = _angle(quat_mul(quat_conj(st.q_ex), q_ex)) * _DEG
    stable = torch.where(pair_ok,
                         torch.where(move_deg < 1.0, st.stable + 1,
                                     torch.zeros_like(st.stable)),
                         st.stable)
    # adoption gate: excitation, volume, fit and stability
    conv = ((S[-2] > 0.1) & (n_b >= 60) & (mean_res_deg < 3.0)
            & (stable >= 15))
    q_ex = torch.where(n_b >= 5, q_ex, st.q_ex)   # keep old until enough data
    return HandEyeState(q_cam=q_cam_b, q_las=q_las_b, mask=mask_b, n=n_b,
                        q_ex=q_ex, converged=st.converged | conv,
                        stable=stable)
