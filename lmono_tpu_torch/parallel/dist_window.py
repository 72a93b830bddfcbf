"""Landmark-sharded sliding-window LM over a mesh axis.

Port of `lmono_tpu/parallel/dist_window.py`.  The window problem's Schur
structure, depths the eliminated block and poses the reduced system,
maps onto the mesh as:

* the landmark axis M is sharded: each rank assembles the reprojection
  residuals and Jacobians of its own feature rows only;
* each rank Schur-eliminates its own depth block locally (the block is
  diagonal, so elimination never crosses ranks);
* the reduced pose system (P = 6·(W+1)+6) is psum'd and solved on every
  rank alike;
* the depth back-substitution is local.

Collectives per LM attempt: three psums, each of one packed vector: the
reduced system with the cost at the attempt's start, then the step's
finiteness and depth norm, then the cost at the candidate.  Every term
that the JAX package computes replicated and adds after its psums (the
pose-only factors) enters the psums from axis index 0 alone, so the
accept/reject, the λ schedule and `done` follow from psum'd values, which
every rank holds bit for bit, and no rank takes another branch.  The LM
loop runs on the host as `solver.solve_window`'s does, reading `done`
once per attempt.
"""

from __future__ import annotations

import torch

from lmono_tpu_torch.config import EstimatorConfig
from lmono_tpu_torch.estimator import factors
from lmono_tpu_torch.estimator.solver import SolveDiag, _apply_delta
from lmono_tpu_torch.estimator.window import (FeatureTable, MargPrior,
                                              WindowState, tree_where)
from lmono_tpu_torch.parallel.mesh import Mesh, gather_sharded, put_sharded
from lmono_tpu_torch.utils.timing import read


def window_specs(axis: str) -> WindowState:
    """Spec tree: feature rows sharded over `axis`, everything else
    replicated."""
    return WindowState(
        t=None, q=None, lt=None, lq=None,
        ex_t=None, ex_q=None, ex_ref_t=None, ex_ref_q=None,
        feats=FeatureTable(*(axis,) * len(FeatureTable._fields)),
        prior=MargPrior(*(None,) * len(MargPrior._fields)),
        count=None, initialized=None, ex_refines=None)


def _local_lm_step(st: WindowState, lam: torch.Tensor, cfg: EstimatorConfig,
                   axis):
    """One LM attempt on the landmark-sharded window problem: `st.feats`
    holds this rank's rows, the poses are replicated.  Returns
    (candidate, cost0, cost1); the costs are global."""
    Ml = st.feats.inv_depth.shape[0]
    Pd = 6 * st.w1 + 6
    dtype, dev = st.t.dtype, st.t.device
    lead = 1.0 if axis.index == 0 else 0.0      # replicated terms enter once

    rw = factors.cauchy_weights(st, cfg)                 # local rows only

    def rep_resid(d, st=st, w=rw):
        t, q, ex_t, ex_q, inv_depth = factors.retract_window(st, d)
        r, _ = factors.reprojection_residuals(t, q, ex_t, ex_q, inv_depth, st, cfg)
        return (r * w[..., None]).reshape(-1)

    def pose_resid(dp, st=st):
        d = torch.cat([dp, torch.zeros(Ml, dtype=dp.dtype, device=dp.device)])
        t, q, ex_t, ex_q, _ = factors.retract_window(st, d)
        return torch.cat([
            factors.laser_residuals(t, q, st, cfg).reshape(-1),
            factors.extrinsic_prior_residual(ex_t, ex_q, st, cfg),
            factors.marg_prior_residuals(t, q, ex_t, ex_q, st),
            factors.gauge_residual(t, q, st),
        ])

    zero = torch.zeros(Pd + Ml, dtype=dtype, device=dev)
    r_rep = rep_resid(zero)
    J_rep = factors.jacobian(rep_resid, (st, rw), zero)  # (R_loc, Pd + Ml)
    zp = torch.zeros(Pd, dtype=dtype, device=dev)
    r_pose = pose_resid(zp)
    J_pose = factors.jacobian(pose_resid, (st,), zp)

    Jp, Jl = J_rep[:, :Pd], J_rep[:, Pd:]
    Hpl = Jp.T @ Jl                                      # (Pd, Ml) local
    Hll = torch.sum(Jl * Jl, dim=0)                      # diagonal depth block
    gl = Jl.T @ r_rep
    # the damping of the depth block is local; that of the pose block needs
    # the global diagonal, so it is added after the psum
    Hll_d = Hll + lam * (1.0 + Hll)
    inv_ll = 1.0 / torch.clamp(Hll_d, min=1e-8)
    pack = axis.psum(torch.cat([
        (Jp.T @ Jp + lead * (J_pose.T @ J_pose)).reshape(-1),
        Jp.T @ r_rep + lead * (J_pose.T @ r_pose),
        ((Hpl * inv_ll[None, :]) @ Hpl.T).reshape(-1),
        Hpl @ (inv_ll * gl),
        (torch.sum(r_rep * r_rep) + lead * torch.sum(r_pose * r_pose)).reshape(1),
    ]))
    n2 = Pd * Pd
    Hpp = pack[:n2].reshape(Pd, Pd)
    gp = pack[n2:n2 + Pd]
    schur = pack[n2 + Pd:2 * n2 + Pd].reshape(Pd, Pd)
    rhs_l = pack[2 * n2 + Pd:2 * n2 + 2 * Pd]
    cost0 = pack[-1]

    Hpp_d = Hpp + torch.diag(lam * (1.0 + torch.diagonal(Hpp)))
    dp = -torch.linalg.solve_ex(Hpp_d - schur, gp - rhs_l)[0]   # replicated
    dl = -inv_ll * (gl + Hpl.T @ dp)                     # local back-substitution

    tail = axis.psum(torch.stack([(~torch.all(torch.isfinite(dl))).to(dtype),
                                  torch.sum(dl * dl)]))
    ok = torch.all(torch.isfinite(dp)) & (tail[0] == 0)
    norm = torch.sqrt(torch.sum(dp * dp) + tail[1])
    scale = torch.clamp(cfg.lm_step_max / torch.clamp(norm, min=1e-12), max=1.0)
    delta = torch.where(ok, torch.cat([dp, dl]) * scale, 0.0)

    r_rep_new = rep_resid(delta)
    r_pose_new = pose_resid(delta[:Pd])
    cost1 = axis.psum(torch.sum(r_rep_new * r_rep_new)
                      + lead * torch.sum(r_pose_new * r_pose_new))
    return _apply_delta(st, delta), cost0, cost1


def _lm_loop(st: WindowState, cfg: EstimatorConfig, axis
             ) -> tuple[WindowState, SolveDiag]:
    """Adaptive LM accept/reject loop (mirrors `solver.solve_window`); its
    decisions come from the psum'd costs only."""
    lam = torch.tensor(cfg.lm_lambda_init, dtype=st.t.dtype, device=st.t.device)
    cost_first = cost = None
    it = readbacks = 0
    while it < cfg.gn_iters:
        cand, cost0, cost1 = _local_lm_step(st, lam, cfg, axis)
        accept = (cost1 < cost0) & torch.isfinite(cost1)
        st = tree_where(accept, cand, st)
        lam = torch.where(accept,
                          torch.clamp(lam * 0.33, min=cfg.lm_lambda_min),
                          torch.clamp(lam * 6.0, max=cfg.lm_lambda_max))
        rel = (cost0 - cost1) / torch.clamp(cost0, min=1e-12)
        done = (accept & (rel < cfg.lm_cost_tol)) | (
            ~accept & (lam >= cfg.lm_lambda_max))
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


def make_sharded_solve(mesh: Mesh, cfg: EstimatorConfig, axis: str = "kf"):
    """The landmark-sharded window solver: f(state) -> (state, SolveDiag),
    `state.feats` this rank's block of rows (`window_shardings`)."""
    nd = mesh.shape[axis]
    if cfg.max_tracks % nd:
        raise ValueError(f"max_tracks={cfg.max_tracks} not divisible by mesh "
                         f"axis '{axis}' size {nd}")
    ax = mesh.axis(axis)
    return lambda state: _lm_loop(state, cfg, ax)


def window_shardings(mesh: Mesh, state: WindowState, axis: str = "kf") -> WindowState:
    """This rank's part of a global window (`window_specs`)."""
    return put_sharded(mesh, state, window_specs(axis))


def window_gathered(mesh: Mesh, state: WindowState, axis: str = "kf") -> WindowState:
    """The global window from this rank's part."""
    return gather_sharded(mesh, state, window_specs(axis))
