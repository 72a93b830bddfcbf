"""Sliding-window marginalization: Schur complement → linearized FEJ prior.

Port of `lmono_tpu/estimator/marginalization.py` (the reference's
VINS-style marginalization): gather every factor that touches the departing
oldest pose (the 0↔1 laser factor, reprojection factors of features
anchored at slot 0, the existing prior, the gauge prior), form the dense
normal equations with two `torch.func.jacfwd`s, Schur-eliminate the dropped
block in two stages (the diagonal depth block, then pose 0 from the reduced
(P, P) system), and turn the reduced information back into a √-form linear
factor by `eigh`.  The prior comes out in *post-slide* indexing (old slot
i+1 → new slot i), so `slide_old` applies right after.

The √-form (J, r0) is defined only up to eigenvector signs and rotations
inside repeated eigenvalues; what the solver sees of it, Jᵀ J, Jᵀ r0 and
r0ᵀ r0, is not.  `torch.linalg.eigh` on CUDA checks its status on the host,
a sync once per keyframe slide.  Where LAPACK fails to converge, torch
raises; the reference's `jnp.linalg.eigh` returns NaNs and the run goes on,
and so does the port's (`_eigh`).
"""

from __future__ import annotations

import torch

from lmono_tpu_torch.config import EstimatorConfig
from lmono_tpu_torch.estimator import factors
from lmono_tpu_torch.estimator.feature_manager import shift_left
from lmono_tpu_torch.estimator.window import MargPrior, WindowState
from lmono_tpu_torch.utils.timing import read


def _eigh(S: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`torch.linalg.eigh`, NaNs where it fails to converge (as JAX's)."""
    try:
        return read(torch.linalg.eigh, S)     # its status check waits
    except torch.linalg.LinAlgError:
        nan = torch.full_like(S, float("nan"))
        return nan[0], nan


def marginalize_oldest(state: WindowState, cfg: EstimatorConfig,
                       axis=None) -> MargPrior:
    """Compute the post-slide prior from marginalizing pose 0 (+ depths of
    features anchored there).  With `axis` (a mesh `Axis`), `state.feats`
    holds this rank's landmark rows, the poses are replicated, the depth
    elimination is local and the reduced (P, P) system is psum'd, so the
    prior comes out the same on every rank."""
    w1 = state.w1
    Ml = state.feats.inv_depth.shape[0]
    P = 6 * w1 + 6
    dtype, dev = state.t.dtype, state.t.device

    rw = factors.cauchy_weights(state, cfg)
    feats = state.feats
    anchored0 = (feats.anchor == 0) & feats.alive & feats.depth_ok

    def rep_resid(d, st=state, w=rw):
        """Reprojection rows of slot-0-anchored features."""
        t, q, ex_t, ex_q, inv_depth = factors.retract_window(st, d)
        r, _ = factors.reprojection_residuals(t, q, ex_t, ex_q, inv_depth, st, cfg)
        return torch.where(anchored0[:, None, None],
                           r * w[..., None], 0.0).reshape(-1)

    def pose_resid(dp, st=state):
        """Pose-only factors touching pose 0."""
        d = torch.cat([dp, torch.zeros(Ml, dtype=dp.dtype, device=dp.device)])
        t, q, ex_t, ex_q, _ = factors.retract_window(st, d)
        r_laser0 = factors.laser_residuals(t, q, st, cfg)[0]
        r_marg = factors.marg_prior_residuals(t, q, ex_t, ex_q, st)
        r_gauge = factors.gauge_residual(t, q, st)
        return torch.cat([r_laser0, r_marg, r_gauge])

    zero = torch.zeros(P + Ml, dtype=dtype, device=dev)
    r_rep = rep_resid(zero)
    J_rep = factors.jacobian(rep_resid, (state, rw), zero)  # (R_loc, P + Ml)
    zp = torch.zeros(P, dtype=dtype, device=dev)
    r_pose = pose_resid(zp)
    J_pose = factors.jacobian(pose_resid, (state,), zp)

    Jp, Jl = J_rep[:, :P], J_rep[:, P:]
    Hpp = Jp.T @ Jp
    gp = Jp.T @ r_rep
    Hpl = Jp.T @ Jl                                    # (P, Ml)
    Hll = torch.sum(Jl * Jl, dim=0)                    # diagonal depth block
    gl = Jl.T @ r_rep

    # stage 1: eliminate depths (diagonal) → reduced (P, P) system
    inv_ll = 1.0 / (Hll + 1e-8)
    S_P = Hpp - (Hpl * inv_ll[None, :]) @ Hpl.T
    b_P = gp - Hpl @ (inv_ll * gl)
    if axis is not None:
        S_P = axis.psum(S_P)
        b_P = axis.psum(b_P)
    S_P = S_P + J_pose.T @ J_pose
    b_P = b_P + J_pose.T @ r_pose

    # stage 2: eliminate pose 0 (first 6 local coords) from the reduced sys
    Hdd = S_P[:6, :6] + 1e-8 * torch.eye(6, dtype=dtype, device=dev)
    Hkd = S_P[6:, :6]
    Hdd_inv = torch.linalg.inv_ex(Hdd)[0]
    S = S_P[6:, 6:] - Hkd @ Hdd_inv @ Hkd.T
    bs = b_P[6:] - Hkd @ (Hdd_inv @ b_P[:6])

    # √-form via eigendecomposition
    S = 0.5 * (S + S.T)
    lam, U = _eigh(S)
    pos = lam > 1e-8
    sqrt_l = torch.sqrt(torch.where(pos, lam, 0.0))
    inv_sqrt_l = torch.where(pos, 1.0 / torch.sqrt(torch.clamp(lam, min=1e-8)), 0.0)
    J_lin = (U * sqrt_l[None, :]).T                    # (K, K)
    r_lin = (U * inv_sqrt_l[None, :]).T @ bs           # (K,)

    # re-index to post-slide coordinates: kept dims are [pose1..poseW | ex];
    # new pose slot i ← old slot i+1, new slot W gets no information
    K = P - 6
    pose_dims = 6 * (w1 - 1)
    J_full = torch.zeros((P, P), dtype=dtype, device=dev)
    J_full[:K, :pose_dims] = J_lin[:, :pose_dims]
    J_full[:K, 6 * w1:] = J_lin[:, pose_dims:]
    r_full = torch.zeros((P,), dtype=dtype, device=dev)
    r_full[:K] = r_lin

    return MargPrior(
        J=J_full, r0=r_full,
        lin_t=shift_left(state.t), lin_q=shift_left(state.q),
        lin_ex_t=state.ex_t, lin_ex_q=state.ex_q,
        valid=torch.ones((), dtype=torch.bool, device=dev),
    )
