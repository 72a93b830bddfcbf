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
a steady-state frame pays the 4–5 attempts it needs, not `gn_iters`.  The
accept/reject, λ schedule and done test stay device tensors computed as the
reference computes them (`_attempt`).

On a CUDA tensor one attempt is a CUDA graph (`_AttemptGraph`): jacfwd
issues ~3500 small kernels an attempt, whose issue from the host cost ~20×
their device time, so the attempt is captured once over static buffers and
replayed for every attempt of every solve, with the `done` read between
replays as above.  Graphs are cached by what the input shows (device, every
leaf's dtype and shape) and by the configuration's fields that the captured
kernels hold as constants (`_GRAPH_FIELDS`), the newest `_MAX_GRAPHS` of
them.  On the CPU the loop runs the attempts eagerly
(`_solve_eager`); both give the same attempts, reads and values.
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
    replayed: int = 0     # attempts that replayed a captured CUDA graph


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


def _attempt(st: WindowState, lam: torch.Tensor, cfg: EstimatorConfig):
    """One attempt of the LM loop on the device: the step, accept/reject,
    the λ schedule and the done test; returns (state, λ, done, cost at the
    attempt's start, cost after it)."""
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
    return st, lam, done, cost0, torch.where(accept, cost1, cost0)


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for sub in tree for x in _leaves(sub)]


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(*(_tree_map(fn, sub) for sub in tree))


def _attempt_loop(attempt, cfg: EstimatorConfig
                  ) -> tuple[torch.Tensor, torch.Tensor, int, int]:
    """Up to cfg.gn_iters calls of `attempt(i)` → (done, cost0, cost), each
    `done` read back but the last allowed one's; returns (the first
    attempt's cost0, the last one's cost, attempts, reads)."""
    cost_first = cost = None
    it = readbacks = 0
    while it < cfg.gn_iters:
        done, cost0, cost = attempt(it)
        if it == 0:
            cost_first = cost0
        it += 1
        if it < cfg.gn_iters:
            readbacks += 1
            if read(bool, done):
                break
    return cost_first, cost, it, readbacks


def _solve_eager(state: WindowState, cfg: EstimatorConfig
                 ) -> tuple[WindowState, SolveDiag]:
    """`solve_window` with every attempt's kernels issued one by one."""
    st = state
    lam = torch.tensor(cfg.lm_lambda_init, dtype=state.t.dtype, device=state.t.device)

    def attempt(i):
        nonlocal st, lam
        st, lam, done, cost0, cost = _attempt(st, lam, cfg)
        return done, cost0, cost

    cost0, cost1, it, readbacks = _attempt_loop(attempt, cfg)
    return st, SolveDiag(cost0=cost0, cost1=cost1, iters=it, readbacks=readbacks)


class _AttemptGraph:
    """`_attempt` captured as one CUDA graph over static buffers: a copy of
    every `WindowState` leaf and λ, which each replay reads and overwrites
    with the attempt's accepted state and new λ; `done`, `cost0` and `cost`
    are the graph's own outputs.  Captured on a side stream after warm-up
    attempts there (cuBLAS and cuSOLVER set up their handles and workspaces
    at a first call, which a capture may not do), with its own memory pool."""

    WARMUP = 2

    def __init__(self, state: WindowState, cfg: EstimatorConfig):
        self.cfg = cfg
        self.state = _tree_map(torch.clone, state)
        self.lam = torch.full((), cfg.lm_lambda_init, dtype=state.t.dtype,
                              device=state.t.device)
        self.graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(state.t.device)
        side.wait_stream(torch.cuda.current_stream(state.t.device))
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                self._body()
        with torch.cuda.graph(self.graph, stream=side):
            self.done, self.cost0, self.cost = self._body()
        torch.cuda.current_stream(state.t.device).wait_stream(side)

    def _body(self):
        st, lam, done, cost0, cost = _attempt(self.state, self.lam, self.cfg)
        for dst, src in zip(_leaves(self.state), _leaves(st)):
            dst.copy_(src)
        self.lam.copy_(lam)
        return done, cost0, cost

    def solve(self, state: WindowState, cfg: EstimatorConfig
              ) -> tuple[WindowState, SolveDiag]:
        """The LM loop of `cfg` (its attempt budget and first λ; the rest
        of it as captured) over replays from `state`."""
        for dst, src in zip(_leaves(self.state), _leaves(state)):
            dst.copy_(src)
        self.lam.fill_(cfg.lm_lambda_init)

        def attempt(i):
            self.graph.replay()
            # the next replay overwrites the outputs
            return self.done, self.cost0.clone() if i == 0 else None, self.cost

        cost0, cost1, it, readbacks = _attempt_loop(attempt, cfg)
        return _tree_map(torch.clone, self.state), SolveDiag(
            cost0=cost0, cost1=cost1.clone(), iters=it, readbacks=readbacks,
            replayed=it)


# the configuration's fields that a captured attempt holds as constants
# (read by `_attempt`, `_lm_step` and the factors); the host loop reads
# `gn_iters` and `lm_lambda_init` from the caller's configuration
_GRAPH_FIELDS = ("laser_w", "factor_weight", "estimate_laser", "fine_times",
                 "prior_t", "prior_r", "cauchy_c", "lm_step_max",
                 "lm_lambda_min", "lm_lambda_max", "lm_cost_tol")
# captured attempts kept, the most recently used last; each holds its
# static buffers and its own pool (~84 MB reserved at KITTI widths)
_MAX_GRAPHS = 4
_GRAPHS: dict = {}


def _graph_key(state: WindowState, cfg: EstimatorConfig) -> tuple:
    return (state.t.device, tuple(getattr(cfg, f) for f in _GRAPH_FIELDS),
            tuple((x.dtype, x.shape) for x in _leaves(state)))


def solve_window(state: WindowState, cfg: EstimatorConfig
                 ) -> tuple[WindowState, SolveDiag]:
    """Adaptive LM on the full window problem: up to cfg.gn_iters attempts,
    accept/reject with λ schedule, early exit on cost-decrease tolerance.
    On CUDA every attempt replays the attempt's graph, captured at the
    first solve of its key; on the CPU the attempts run eagerly."""
    if not state.t.is_cuda:
        return _solve_eager(state, cfg)
    key = _graph_key(state, cfg)
    graph = _GRAPHS.pop(key, None)
    if graph is None:
        graph = _AttemptGraph(state, cfg)
    _GRAPHS[key] = graph
    while len(_GRAPHS) > _MAX_GRAPHS:
        # freed now, outside any capture: a graph that the garbage collector
        # destroys while another is being captured breaks that capture
        _GRAPHS.pop(next(iter(_GRAPHS))).graph.reset()
    return graph.solve(state, cfg)


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
