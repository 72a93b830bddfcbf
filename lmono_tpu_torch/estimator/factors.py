"""Residual functions for the sliding-window fusion problem.

Port of `lmono_tpu/estimator/factors.py`.  One flat local-perturbation
vector δ parameterizes the whole window (6 per pose + 6 extrinsic + 1 per
feature depth); every factor is a function of the *retracted* state, so
`torch.func.jacfwd` at δ=0 yields the Jacobians the reference hand-derives
(laser relative pose, inverse-depth reprojection, extrinsic prior,
linearized marginalization prior).

Everything here is written for forward-mode AD under `vmap`: no `.item()`,
no in-place writes, no Python branch on a tensor.

Residual weighting matches the reference:
  laser:  sqrt_info = LASER_W · FACTOR_WEIGHT · I₆
  reproj: sqrt_info = FACTOR_WEIGHT · I₂ + Cauchy(1) IRLS (the robust scale
          applies to the *weighted* residual)
  prior:  diag(PRIOR_T·I₃, PRIOR_R·I₃)
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from lmono_tpu_torch.config import EstimatorConfig
from lmono_tpu_torch.estimator.window import WindowState
from lmono_tpu_torch.utils.lie import (
    boxminus,
    boxplus,
    quat_conj,
    quat_mul,
    quat_rotate,
    quat_rotate_inv,
)


def lift_constants(tree, delta: torch.Tensor):
    """`tree` (a tensor or nested NamedTuple) with `0·delta[0]` added to
    every float tensor: the same values and, inside `torch.func.jacfwd`,
    dual tensors with zero tangents.  Forward-mode AD runs an op on two
    duals by its own formula, but an op on a dual and a plain tensor by a
    slower path on the host; the solve is host-bound on the card, and there
    the lifted Jacobians ran faster (`PERF.md` §6)."""
    if isinstance(tree, torch.Tensor):
        return tree + 0.0 * delta[0] if tree.is_floating_point() else tree
    leaves = (lift_constants(x, delta) for x in tree)
    return type(tree)(*leaves) if hasattr(tree, "_fields") else tuple(leaves)


def jacobian(fn, consts: tuple, d0: torch.Tensor) -> torch.Tensor:
    """`torch.func.jacfwd` of `fn(d, *consts)` at `d0`, the constants lifted
    (`lift_constants`); the same values as without the lift."""
    return jacfwd(lambda d: fn(d, *lift_constants(consts, d)))(d0)


def retract_window(state: WindowState, delta: torch.Tensor):
    """Apply flat local delta: (W1*6 poses | 6 extrinsic | M depths)."""
    w1 = state.w1
    M = state.feats.inv_depth.shape[0]
    dp = delta[: w1 * 6].reshape(w1, 6)
    t = state.t + dp[:, :3]
    q = boxplus(state.q, dp[:, 3:6])
    dex = delta[w1 * 6: w1 * 6 + 6]
    ex_t = state.ex_t + dex[:3]
    ex_q = boxplus(state.ex_q, dex[3:6])
    inv_depth = state.feats.inv_depth + delta[w1 * 6 + 6: w1 * 6 + 6 + M]
    return t, q, ex_t, ex_q, inv_depth


def laser_residuals(t, q, state: WindowState, cfg: EstimatorConfig):
    """Relative-pose residuals between consecutive window frames from laser
    odometry.  (W1-1, 6), masked by window occupancy."""
    w1 = state.w1
    lq_i, lq_j = state.lq[:-1], state.lq[1:]
    dq_meas = quat_mul(quat_conj(lq_i), lq_j)
    dp_meas = quat_rotate_inv(lq_i, state.lt[1:] - state.lt[:-1])
    dp_est = quat_rotate_inv(q[:-1], t[1:] - t[:-1])
    dq_est = quat_mul(quat_conj(q[:-1]), q[1:])
    r_p = dp_est - dp_meas
    r_q = 2.0 * quat_mul(quat_conj(dq_meas), dq_est)[..., 1:4]
    r = torch.cat([r_p, r_q], dim=-1)
    j = torch.arange(1, w1, device=t.device)
    active = (j < state.count)[:, None]
    w = cfg.laser_w * cfg.factor_weight
    return torch.where(active, w * r, 0.0)


def reprojection_residuals(t, q, ex_t, ex_q, inv_depth,
                           state: WindowState, cfg: EstimatorConfig):
    """Inverse-depth reprojection residuals for every (feature, frame) obs.

    Feature m anchored at frame a with normalized obs n_a and inverse depth
    λ: 3D point in anchor camera = [n_a, 1]/λ; reprojected into every other
    observing frame j through T_W_C = T_W_L ∘ T_CL⁻¹.
    Returns ((M, W1, 2) residuals, (M, W1) active mask).
    """
    feats = state.feats
    M, W1 = feats.obs_mask.shape
    anchor = feats.anchor.long()                                # (M,)
    n_a = torch.gather(feats.obs, 1,
                       anchor[:, None, None].expand(M, 1, 2))[:, 0]  # (M,2)
    depth = 1.0 / torch.clamp(inv_depth, min=1e-4)              # (M,)
    p_anchor_cam = torch.cat(
        [n_a, torch.ones((M, 1), dtype=n_a.dtype, device=n_a.device)],
        dim=-1) * depth[:, None]

    # anchor camera → laser → world
    p_l = quat_rotate_inv(ex_q, p_anchor_cam - ex_t)
    p_w = quat_rotate(q[anchor], p_l) + t[anchor]               # (M,3)

    # world → each frame j camera
    p_lj = quat_rotate_inv(q[None, :, :], p_w[:, None, :] - t[None, :, :])
    p_cj = quat_rotate(ex_q, p_lj) + ex_t                       # (M, W1, 3)
    z = p_cj[..., 2]
    proj = p_cj[..., :2] / torch.clamp(z[..., None], min=1e-4)
    r = proj - feats.obs                                        # (M, W1, 2)

    frame_idx = torch.arange(W1, device=z.device)[None, :]
    active = (feats.obs_mask
              & feats.alive[:, None]
              & feats.depth_ok[:, None]
              & (frame_idx != anchor[:, None])
              & (frame_idx < state.count)
              & (z > 0.1))
    # sqrt_info = FACTOR_WEIGHT · I₂ (not focal-scaled), against the laser's
    # laser_w · factor_weight: the 2:1 balance of the reference
    return torch.where(active[..., None], cfg.factor_weight * r, 0.0), active


def extrinsic_prior_residual(ex_t, ex_q, state: WindowState,
                             cfg: EstimatorConfig):
    """6-dim prior pinning T_CL after FINE_TIMES refinements.  With
    estimate_laser==0 it is active from the start, freezing the extrinsic
    at its seed; while refining, a weak anchor (σ≈7 cm / 2°) keeps the
    extrinsic off the flat direction of near-constant-twist motion."""
    r_t = ex_t - state.ex_ref_t
    r_q = boxminus(state.ex_ref_q, ex_q)
    frozen = (state.ex_refines >= cfg.fine_times) | (cfg.estimate_laser == 0)
    w = torch.where(frozen, 1.0, 0.015)
    return w * torch.cat([cfg.prior_t * r_t, cfg.prior_r * r_q])


def marg_prior_residuals(t, q, ex_t, ex_q, state: WindowState):
    """r = r0 + J · (x ⊟ x0) with first-estimate Jacobians."""
    pr = state.prior
    d_pose = torch.cat([t - pr.lin_t, boxminus(pr.lin_q, q)], dim=-1).reshape(-1)
    d_ex = torch.cat([ex_t - pr.lin_ex_t, boxminus(pr.lin_ex_q, ex_q)])
    r = pr.r0 + pr.J @ torch.cat([d_pose, d_ex])
    return torch.where(pr.valid, r, 0.0)


def gauge_residual(t, q, state: WindowState, weight: float = 1e4):
    """Soft gauge fix: pin pose 0 at its current linearization value (weakly
    once a marginalization prior fixes the gauge)."""
    r = torch.cat([t[0] - state.t[0], boxminus(state.q[0], q[0])])
    return torch.where(state.prior.valid, 1e2, weight) * r


def all_residuals(delta: torch.Tensor, state: WindowState,
                  cfg: EstimatorConfig, reproj_weights: torch.Tensor):
    """Stacked residual vector for the LM solver.

    reproj_weights: (M, W1) IRLS robust weights (√Cauchy), computed outside
    the differentiated function so the robustified problem stays GN.
    """
    t, q, ex_t, ex_q, inv_depth = retract_window(state, delta)
    r_laser = laser_residuals(t, q, state, cfg).reshape(-1)
    r_rep, _ = reprojection_residuals(t, q, ex_t, ex_q, inv_depth, state, cfg)
    r_rep = (r_rep * reproj_weights[..., None]).reshape(-1)
    r_ex = extrinsic_prior_residual(ex_t, ex_q, state, cfg)
    r_marg = marg_prior_residuals(t, q, ex_t, ex_q, state)
    r_gauge = gauge_residual(t, q, state)
    return torch.cat([r_laser, r_rep, r_ex, r_marg, r_gauge])


def cauchy_weights(state: WindowState, cfg: EstimatorConfig):
    """IRLS √weights for the Cauchy loss on current reprojection residuals
    (the reference wraps its projection factor in ceres::CauchyLoss(1),
    applied to the weighted residual)."""
    r, active = reprojection_residuals(
        state.t, state.q, state.ex_t, state.ex_q, state.feats.inv_depth,
        state, cfg)
    s2 = torch.sum(r * r, dim=-1)
    w = 1.0 / torch.sqrt(1.0 + s2 / (cfg.cauchy_c ** 2))
    return torch.where(active, torch.sqrt(w), 0.0)
