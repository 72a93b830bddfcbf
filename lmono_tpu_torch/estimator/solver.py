"""Dense Levenberg-Marquardt window solver with Schur elimination of depths.

Port of `lmono_tpu/estimator/solver.py` (the reference's Ceres DENSE_SCHUR
solve): the whole Jacobian is materialized by one `torch.func.jacfwd` over
the flat local delta, and the normal equations are solved by Schur
complement on the (diagonal) depth block, then `torch.linalg.solve_ex` on
the (P, P) pose/extrinsic system, P = 6·(W+1)+6.  f32 throughout, as the
reference (H reaches ~1e8 with the 1e4 gauge).

The JAX package runs its LM attempts in a `lax.while_loop` on the device.
Here the loop is on the host: each attempt is queued on the device, and its
`done` flag is read back once (skipped after the last allowed attempt), so
a steady-state frame pays the 2–3 attempts it needs, not `gn_iters`.  The
accept/reject, λ schedule and done test stay device tensors computed as the
reference computes them.  A sync-free masked loop (capturable in a CUDA
graph) is later work.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lmono_tpu_torch.config import EstimatorConfig
from lmono_tpu_torch.estimator import factors
from lmono_tpu_torch.estimator.window import WindowState, tree_where
from lmono_tpu_torch.utils.timing import read, span


class SolveDiag(NamedTuple):
    cost0: torch.Tensor   # () cost at the first attempt's start
    cost1: torch.Tensor   # () cost after the last attempt
    iters: int            # LM attempts made
    readbacks: int        # device values read by the host


def _apply_delta(state: WindowState, delta: torch.Tensor) -> WindowState:
    t, q, ex_t, ex_q, inv_depth = factors.retract_window(state, delta)
    return state._replace(t=t, q=q, ex_t=ex_t, ex_q=ex_q,
                          feats=state.feats._replace(inv_depth=inv_depth))


def _lm_step(state: WindowState, lam: torch.Tensor, cfg: EstimatorConfig):
    """One LM attempt: assemble J at `state`, solve the λ-damped Schur
    system, and return (candidate, cost_at_state, cost_at_candidate)."""
    P = 6 * state.w1 + 6          # pose+extrinsic dims
    D = P + state.feats.inv_depth.shape[0]

    rw = factors.cauchy_weights(state, cfg)

    def resid_fn(d, st=state, w=rw):
        return factors.all_residuals(d, st, cfg, w)

    zero = torch.zeros(D, dtype=state.t.dtype, device=state.t.device)
    r = resid_fn(zero)
    with span("window_solve.jacobian"):
        J = factors.jacobian(resid_fn, (state, rw), zero)    # (R, D)
    H = J.T @ J
    g = J.T @ r
    Hd = H + torch.diag(lam * (1.0 + torch.diagonal(H)))

    # Schur complement on the depth block (diagonal): depths
    # x_l = D⁻¹(g_l − Hlpᵀ x_p)
    Hpp, Hpl = Hd[:P, :P], Hd[:P, P:]
    gp, gl = g[:P], g[P:]
    inv_ll = 1.0 / torch.clamp(torch.diagonal(Hd)[P:], min=1e-8)
    S = Hpp - (Hpl * inv_ll[None, :]) @ Hpl.T
    rhs = gp - Hpl @ (inv_ll * gl)
    dp = -torch.linalg.solve_ex(S, rhs)[0]
    dl = -inv_ll * (gl + Hpl.T @ dp)
    delta = torch.cat([dp, dl])
    delta = torch.where(torch.all(torch.isfinite(delta)), delta, 0.0)
    # safety clamp only (pathological steps); LM reject handles the rest
    norm = torch.sqrt(torch.sum(delta * delta))
    delta = delta * torch.clamp(cfg.lm_step_max / torch.clamp(norm, min=1e-12),
                                max=1.0)

    cost0 = torch.sum(r * r)
    r_new = resid_fn(delta)                     # same robust weights: fair compare
    cost1 = torch.sum(r_new * r_new)
    return _apply_delta(state, delta), cost0, cost1


def solve_window(state: WindowState, cfg: EstimatorConfig
                 ) -> tuple[WindowState, SolveDiag]:
    """Adaptive LM on the full window problem: up to cfg.gn_iters attempts,
    accept/reject with λ schedule, early exit on cost-decrease tolerance."""
    lam = torch.tensor(cfg.lm_lambda_init, dtype=state.t.dtype,
                       device=state.t.device)
    st = state
    cost_first = cost = None
    it = readbacks = 0
    while it < cfg.gn_iters:
        cand, cost0, cost1 = _lm_step(st, lam, cfg)
        accept = (cost1 < cost0) & torch.isfinite(cost1)
        st = tree_where(accept, cand, st)
        lam = torch.where(accept,
                          torch.clamp(lam * 0.33, min=cfg.lm_lambda_min),
                          torch.clamp(lam * 6.0, max=cfg.lm_lambda_max))
        # converged: accepted step barely moved the cost
        rel = (cost0 - cost1) / torch.clamp(cost0, min=1e-12)
        done = accept & (rel < cfg.lm_cost_tol)
        # stuck: λ saturated with no acceptance
        done = done | (~accept & (lam >= cfg.lm_lambda_max))
        if it == 0:
            cost_first = cost0
        cost = torch.where(accept, cost1, cost0)
        it += 1
        if it < cfg.gn_iters:
            readbacks += 1
            if read(bool, done):
                break
    return st, SolveDiag(cost0=cost_first, cost1=cost, iters=it,
                         readbacks=readbacks)


def outlier_rejection(state: WindowState, cfg: EstimatorConfig) -> WindowState:
    """Disable features whose mean reprojection error exceeds the gate
    (reference `Estimator::outliersRejection`)."""
    r, active = factors.reprojection_residuals(
        state.t, state.q, state.ex_t, state.ex_q, state.feats.inv_depth,
        state, cfg)
    # r is scaled by FACTOR_WEIGHT ⇒ pixel error at the virtual focal is
    # |r| / factor_weight · focal
    err_px = torch.sqrt(torch.sum(r * r, dim=-1)) * (cfg.focal_length
                                                     / cfg.factor_weight)
    n_act = torch.sum(active, dim=-1)
    mean_err = (torch.sum(torch.where(active, err_px, 0.0), dim=-1)
                / torch.clamp(n_act, min=1))
    bad = (mean_err > cfg.outlier_reproj_px) & (n_act > 0)
    feats = state.feats
    drop = bad | (feats.depth_ok & (feats.inv_depth < 0.0))
    return state._replace(feats=feats._replace(
        depth_ok=feats.depth_ok & ~drop, alive=feats.alive & ~drop))
