"""Global pose-graph optimization (4-DoF or 6-DoF).

Port of `lmono_tpu/loop/posegraph.py`: sequential odometry edges and loop
edges over all keyframes, solved by Gauss-Newton.  Each edge's residual
depends on its two nodes only, so each GN step forms J as per-edge blocks
(r × d for each end; `torch.func.jacfwd` vectorized over the edges by
`vmap`).  Jᵀ sums the loop edges' blocks into their nodes by a one-hot
(nodes × 2·loop slots) matmul instead of atomic adds, so a solve gives the
same bits on every run.

The reference solves each step's normal equations by a matrix-free
conjugate gradient of at most 50 steps (Hv = Jᵀ(Jv) by one `jvp` and one
`vjp`), which leaves the step unconverged on graphs of a lap and more:
there the robust loop weights of the next steps follow the inexact step
into another basin, and a solve can end further from the optimum than it
started (PERF.md §6).  By default the port solves each step exactly: J
assembled dense from the blocks (each block written once into its place),
JᵀJ by one matmul and one LU, a few dozen kernels a step where the CG
took ~1000.  That is dense in the node capacity N, whatever the number of
live nodes: J takes (rows × N·d) floats, JᵀJ (N·d)² and the LU
O((N·d)³) flops a step (25 MB, 17 MB at the system's first capacity, 512
nodes in 4-DoF; 1.1 GB each at 4096; PERF.md §7 has its times).  Given
`cg_iters`, `optimize_posegraph` runs the reference's matrix-free CG
instead (applying J and Jᵀ from the blocks), as the sharded optimizer
(`parallel/dist_posegraph.py`) does.

4-DoF mode optimizes (x, y, z, yaw) per keyframe, holding pitch and roll at
their odometry values; 6-DoF mode optimizes full SE(3) (position plus a
rotation tangent around the stored node rotation).

The reference's three `lax.while_loop`s (GN, and CG inside each GN step)
exit early on convergence.  Here each is a fixed-count loop whose updates
are masked once its exit condition holds, so no flag is read back: the
updates stop at the same step, so the result equals the early exit's.

The host knows the node and loop counts, so `graph_add_node` and
`graph_add_loop` take them and write in place; `n_nodes` and `n_loops` stay
as device mirrors for the converters.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.func import jacfwd, vmap

from lmono_tpu_torch.utils.lie import (
    Pose,
    mat_to_quat,
    mat_to_ypr,
    quat_conj,
    quat_mul,
    quat_rotate_inv,
    quat_to_mat,
    so3_exp_quat,
    so3_log_quat,
    ypr_to_mat,
)


class PoseGraph(NamedTuple):
    """Fixed-capacity graph state (masked)."""
    t: torch.Tensor          # (N, 3) keyframe positions
    ypr: torch.Tensor        # (N, 3) yaw/pitch/roll (pitch/roll held fixed)
    node_mask: torch.Tensor  # (N,)
    # sequential edges i→i+1 (relative in frame i), from odometry
    seq_dt: torch.Tensor     # (N, 3)
    seq_dyaw: torch.Tensor   # (N,)
    seq_dq: torch.Tensor     # (N, 4) full relative rotation (6-DoF edges)
    seq_mask: torch.Tensor   # (N,)
    # loop edges
    loop_i: torch.Tensor     # (L,) int64 older node
    loop_j: torch.Tensor     # (L,) int64 newer node
    loop_dt: torch.Tensor    # (L, 3) measured t_j in frame i
    loop_dyaw: torch.Tensor  # (L,)
    loop_dq: torch.Tensor    # (L, 4) full relative rotation (6-DoF edges)
    loop_mask: torch.Tensor  # (L,)
    loop_w: torch.Tensor     # (L,) per-edge weight (0 where unset)
    n_nodes: torch.Tensor    # () int32, device mirror of the host count
    n_loops: torch.Tensor    # () int32

    @staticmethod
    def empty(capacity: int, max_loops: int = 256, device=None) -> "PoseGraph":
        f32, b = dict(device=device), dict(dtype=torch.bool, device=device)
        ident = torch.tensor([1.0, 0, 0, 0], device=device)
        return PoseGraph(
            t=torch.zeros((capacity, 3), **f32),
            ypr=torch.zeros((capacity, 3), **f32),
            node_mask=torch.zeros((capacity,), **b),
            seq_dt=torch.zeros((capacity, 3), **f32),
            seq_dyaw=torch.zeros((capacity,), **f32),
            seq_dq=ident.repeat(capacity, 1),
            seq_mask=torch.zeros((capacity,), **b),
            loop_i=torch.zeros((max_loops,), dtype=torch.int64, device=device),
            loop_j=torch.zeros((max_loops,), dtype=torch.int64, device=device),
            loop_dt=torch.zeros((max_loops, 3), **f32),
            loop_dyaw=torch.zeros((max_loops,), **f32),
            loop_dq=ident.repeat(max_loops, 1),
            loop_mask=torch.zeros((max_loops,), **b),
            loop_w=torch.zeros((max_loops,), **f32),
            n_nodes=torch.zeros((), dtype=torch.int32, device=device),
            n_loops=torch.zeros((), dtype=torch.int32, device=device),
        )

    def grown(self, capacity: int) -> "PoseGraph":
        """The same graph in a node capacity of `capacity` (≥ the current);
        the loop-edge arrays are capacity-independent."""
        fresh = PoseGraph.empty(capacity, self.loop_mask.shape[0],
                                self.t.device)
        c = self.t.shape[0]
        for name in ("t", "ypr", "node_mask", "seq_dt", "seq_dyaw", "seq_dq",
                     "seq_mask"):
            getattr(fresh, name)[:c] = getattr(self, name)
        keep = ("loop_i", "loop_j", "loop_dt", "loop_dyaw", "loop_dq",
                "loop_mask", "loop_w", "n_nodes", "n_loops")
        return fresh._replace(**{k: getattr(self, k) for k in keep})


def graph_add_node(g: PoseGraph, pose: Pose, i: int) -> PoseGraph:
    """Write keyframe node `i` (the host's node count) in place; the
    sequential edge from node i−1 is derived from the supplied (odometry)
    pose.  Returns `g`."""
    ypr = mat_to_ypr(quat_to_mat(pose.q))
    if i > 0:
        prev = i - 1
        # relative measurement in the previous node's (full-rotation) frame
        R_prev = ypr_to_mat(g.ypr[prev])
        g.seq_dt[prev] = R_prev.T @ (pose.t - g.t[prev])
        g.seq_dyaw[prev] = ypr[0] - g.ypr[prev, 0]
        g.seq_dq[prev] = quat_mul(quat_conj(mat_to_quat(R_prev)), pose.q)
        g.seq_mask[prev] = True
    g.t[i] = pose.t
    g.ypr[i] = ypr
    g.node_mask[i] = True
    g.n_nodes.fill_(i + 1)
    return g


def graph_add_loop(g: PoseGraph, i: int, j: int, rel: Pose, k: int,
                   weight: float = 5.0) -> PoseGraph:
    """Write loop edge number `k` (the host's loop count; a ring over the
    L edge slots) in place: rel = T_ci_cj, newer node j seen from older i.
    The yaw measurement predicts node j's world pose through node i and
    takes the world-yaw difference (ypr of `rel` itself mixes the axes of
    camera frames).  Returns `g`."""
    s = k % g.loop_mask.shape[0]
    R_i = ypr_to_mat(g.ypr[i])
    R_j_pred = R_i @ quat_to_mat(rel.q)
    g.loop_i[s] = i
    g.loop_j[s] = j
    g.loop_dt[s] = rel.t
    g.loop_dyaw[s] = _wrap(mat_to_ypr(R_j_pred)[0] - g.ypr[i, 0])
    g.loop_dq[s] = rel.q
    g.loop_mask[s] = True
    g.loop_w[s] = weight
    g.n_loops.fill_(k + 1)
    return g


# robust loop-edge kernel: a Geman-McClure IRLS weight from the edge's
# current combined error (metres + yaw-equivalent), frozen at each GN
# iterate (the reference's stop_gradient), so one gross loop edge is
# switched off instead of dragging the chain
ROBUST_C = 0.3
# graduated non-convexity: the kernel scale anneals from wide down to
# ROBUST_C over the first GNC_STEPS GN iterations
GNC_STEPS = 6
# GN exit: the normal-equation gradient's ∞-norm under this, after the GNC
# window
_GN_GRAD_TOL = 1e-4


def _robust_w(e_t, e_r, c):
    return 1.0 / (1.0 + ((e_t + 3.0 * e_r) / c) ** 2)


def _gnc_c(it: int) -> float:
    """Kernel scale at GN iteration `it`."""
    return ROBUST_C * 2.0 ** min(max(GNC_STEPS - it, 0), 10)


def _wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def _rot4(x, g):
    yaw = x[:, 3]
    return yaw, ypr_to_mat(torch.stack([yaw, g.ypr[:, 1], g.ypr[:, 2]], -1))


def _loop_weights4(x, g, c):
    """Robust loop-edge weights at x (4-DoF), held fixed while linearizing."""
    yaw, R = _rot4(x, g)
    t = x[:, :3]
    li, lj = g.loop_i, g.loop_j
    raw_t = (R[li].transpose(1, 2) @ (t[lj] - t[li])[..., None])[..., 0] - g.loop_dt
    raw_y = _wrap(yaw[lj] - yaw[li] - g.loop_dyaw)
    return g.loop_w * g.loop_mask * _robust_w(
        torch.linalg.vector_norm(raw_t, dim=-1), torch.abs(raw_y), c)


def _edge4(xi, xj, pr_i, dt, dyaw, s):
    """One 4-DoF edge's residual (t, yaw) × s: node j seen from node i,
    whose rotation is (yaw_i, pitch_i, roll_i)."""
    R = ypr_to_mat(torch.cat([xi[3:], pr_i]))
    return torch.cat([R.T @ (xj[:3] - xi[:3]) - dt, _wrap(xj[3:] - xi[3:] - dyaw)]) * s


def _rel6(x, g, q0):
    t = x[:, :3]
    q = quat_mul(q0, so3_exp_quat(x[:, 3:]))
    li, lj = g.loop_i, g.loop_j
    raw_t = quat_rotate_inv(q[li], t[lj] - t[li]) - g.loop_dt
    raw_r = so3_log_quat(quat_mul(quat_conj(g.loop_dq), quat_mul(quat_conj(q[li]), q[lj])))
    return raw_t, raw_r


def _loop_weights6(x, g, q0, c):
    raw_t, raw_r = _rel6(x, g, q0)
    return g.loop_w * g.loop_mask * _robust_w(
        torch.linalg.vector_norm(raw_t, dim=-1),
        torch.linalg.vector_norm(raw_r, dim=-1), c)


def _edge6(xi, xj, q0i, q0j, dt, dq, s):
    """One SE(3) edge's residual (t, log R) × s; a node's rotation is
    q0·exp(δθ) around its stored rotation q0."""
    qi = quat_mul(q0i, so3_exp_quat(xi[3:]))
    qj = quat_mul(q0j, so3_exp_quat(xj[3:]))
    r_t = quat_rotate_inv(qi, xj[:3] - xi[:3]) - dt
    r_r = so3_log_quat(quat_mul(quat_conj(dq), quat_mul(quat_conj(qi), qj)))
    return torch.cat([r_t, r_r]) * s


def _blocks(edge_fn, xi, xj, *aux):
    """Residuals (E, r) and Jacobian blocks (E, r, d) with respect to each
    edge's two nodes: forward mode, vectorized over the edges."""
    f = lambda a, b, *c: (edge_fn(a, b, *c),) * 2
    (Ji, Jj), r = vmap(jacfwd(f, argnums=(0, 1), has_aux=True))(xi, xj, *aux)
    return r, Ji, Jj


class _Linearization(NamedTuple):
    """J at one GN iterate, as the per-edge blocks of the sequential chain
    (edge k joins nodes k and k+1) and of the loop edges, plus the gauge
    residual 100·(x₀ − anchor)."""
    r_seq: torch.Tensor      # (N-1, r)
    Ji_seq: torch.Tensor     # (N-1, r, d)
    Jj_seq: torch.Tensor
    r_loop: torch.Tensor     # (L, r)
    Ji_loop: torch.Tensor    # (L, r, d)
    Jj_loop: torch.Tensor
    loop_i: torch.Tensor     # (L,)
    loop_j: torch.Tensor
    onehot_T: torch.Tensor   # (N, 2L): node ← (loop edge, end) incidence
    r_fix: torch.Tensor      # (d,)

    def residuals(self):
        return (self.r_seq, self.r_loop, self.r_fix)

    def J(self, v):
        """J v, as (seq, loop, fix) residual blocks."""
        seq = _bmv(self.Ji_seq, v[:-1]) + _bmv(self.Jj_seq, v[1:])
        loop = _bmv(self.Ji_loop, v[self.loop_i]) + _bmv(self.Jj_loop, v[self.loop_j])
        return seq, loop, 100.0 * v[0]

    def JT(self, u):
        """Jᵀ u for u = (seq, loop, fix) residual blocks.  The loop edges'
        contributions are summed per node by a one-hot matmul, so the
        result does not depend on the order of atomic adds."""
        u_seq, u_loop, u_fix = u
        a = _bmv(self.Ji_seq.transpose(1, 2), u_seq)
        b = _bmv(self.Jj_seq.transpose(1, 2), u_seq)
        out = F.pad(a, (0, 0, 0, 1)) + F.pad(b, (0, 0, 1, 0))
        ends = torch.cat([_bmv(self.Ji_loop.transpose(1, 2), u_loop),
                          _bmv(self.Jj_loop.transpose(1, 2), u_loop)])
        out = out + self.onehot_T @ ends
        return torch.cat([out[:1] + 100.0 * u_fix, out[1:]])

    def dense(self):
        """J as one (rows, N·d) matrix, rows in the order (seq, loop, fix)
        and columns node by node.  Every block is written once into its own
        place (the chain's by index, edge k at nodes k and k+1; the loop
        edges' by their one-hot incidence), so no two writes meet and every
        run gives the same bits; the largest temporary is J itself."""
        n, L = self.onehot_T.shape[0], self.loop_i.shape[0]
        E, r, d = self.Ji_seq.shape
        k = torch.arange(E, device=self.Ji_seq.device)
        seq = self.Ji_seq.new_zeros(E, r, n, d)
        seq[k, :, k] = self.Ji_seq
        seq[k, :, k + 1] = self.Jj_seq
        oi, oj = self.onehot_T[:, :L].T, self.onehot_T[:, L:].T
        loop = (self.Ji_loop[:, :, None, :] * oi[:, None, :, None]
                + self.Jj_loop[:, :, None, :] * oj[:, None, :, None])
        fix = self.Ji_seq.new_zeros(d, n, d)
        fix[:, 0] = 100.0 * torch.eye(d, dtype=fix.dtype, device=fix.device)
        return torch.cat([seq.reshape(-1, n * d), loop.reshape(-1, n * d),
                          fix.reshape(d, n * d)])


def _bmv(A, v):
    return (A @ v[..., None])[..., 0]


def _incidence(g):
    """(N, 2L) one-hot: column e is loop edge e's node i, column L+e its j."""
    n = g.t.shape[0]
    return F.one_hot(torch.cat([g.loop_i, g.loop_j]), n).T.to(g.t.dtype)


def _linearize4(x, g, w, onehot_T) -> _Linearization:
    """The 4-DoF residuals' blocks at x = (t, yaw) per node (N, 4), loop
    weights w held fixed."""
    pr = g.ypr[:, 1:]
    li, lj = g.loop_i, g.loop_j
    r_s, Ji_s, Jj_s = _blocks(_edge4, x[:-1], x[1:], pr[:-1], g.seq_dt[:-1],
                              g.seq_dyaw[:-1, None], g.seq_mask[:-1].to(x.dtype))
    r_l, Ji_l, Jj_l = _blocks(_edge4, x[li], x[lj], pr[li], g.loop_dt,
                              g.loop_dyaw[:, None], w)
    # gauge: pin node 0 at its stored (pre-optimization) pose
    anchor = torch.cat([g.t[0], g.ypr[0, :1]])
    return _Linearization(r_s, Ji_s, Jj_s, r_l, Ji_l, Jj_l, li, lj, onehot_T,
                          100.0 * (x[0] - anchor))


def _linearize6(x, g, q0, w, onehot_T) -> _Linearization:
    """The SE(3) residuals' blocks at x = (t, δθ) per node (N, 6) around
    the node rotations q0, loop weights w held fixed."""
    li, lj = g.loop_i, g.loop_j
    r_s, Ji_s, Jj_s = _blocks(_edge6, x[:-1], x[1:], q0[:-1], q0[1:], g.seq_dt[:-1],
                              g.seq_dq[:-1], g.seq_mask[:-1].to(x.dtype))
    r_l, Ji_l, Jj_l = _blocks(_edge6, x[li], x[lj], q0[li], q0[lj], g.loop_dt,
                              g.loop_dq, w)
    # gauge: pin node 0 at its stored pose (position and rotation tangent)
    r_fix = 100.0 * torch.cat([x[0, :3] - g.t[0], x[0, 3:]])
    return _Linearization(r_s, Ji_s, Jj_s, r_l, Ji_l, Jj_l, li, lj, onehot_T, r_fix)


def _gn_step(lin: _Linearization, x, node_mask, cg_iters):
    """One GN step from linearization `lin` at x: (masked dx, gradient
    ∞-norm).  The damped normal equations (JᵀJ + 1e-4·I) dx = −Jᵀr are
    solved exactly with cg_iters None (J dense, one LU), else by cg_iters
    matrix-free CG steps."""
    grad = lin.JT(lin.residuals())
    if cg_iters is None:
        J = lin.dense()
        H = J.T @ J + 1e-4 * torch.eye(J.shape[1], dtype=J.dtype, device=J.device)
        dx = torch.linalg.solve_ex(H, -grad.reshape(-1))[0].reshape(grad.shape)
    else:
        def Hv(v):
            return lin.JT(lin.J(v)) + 1e-4 * v                 # LM damping

        dx = _cg(Hv, -grad, cg_iters)
    mask = node_mask[:, None]
    zero = torch.zeros_like(dx)
    return torch.where(mask, dx, zero), torch.amax(torch.abs(torch.where(mask, grad, zero)))


def optimize_posegraph(g: PoseGraph, iters: int = 10, cg_iters: int | None = None,
                       four_dof: bool = True) -> PoseGraph:
    """Damped GN over the graph.  Each step's normal equations are solved
    exactly (`_gn_step`), or with `cg_iters` by that many matrix-free CG
    steps, as the JAX package and the sharded optimizer solve them.  A GN
    iteration past the GNC window runs only while the previous one's
    gradient ∞-norm exceeds _GN_GRAD_TOL (masked, see the module
    docstring).  Returns a new graph with the optimized node poses."""
    onehot_T = _incidence(g)
    if not four_dof:
        return _optimize_posegraph6(g, iters, cg_iters, onehot_T)
    x = torch.cat([g.t, g.ypr[:, :1]], dim=-1)                 # (N, 4)
    live = torch.ones((), dtype=torch.bool, device=x.device)
    gnorm = None
    for it in range(iters):
        if it > GNC_STEPS:
            live = live & (gnorm > _GN_GRAD_TOL)
        w = _loop_weights4(x, g, _gnc_c(it))
        dx, gnorm = _gn_step(_linearize4(x, g, w, onehot_T), x, g.node_mask, cg_iters)
        x = torch.where(live, x + dx, x)
    new_ypr = torch.stack([x[:, 3], g.ypr[:, 1], g.ypr[:, 2]], -1)
    return g._replace(t=x[:, :3], ypr=new_ypr)


def _optimize_posegraph6(g: PoseGraph, iters: int, cg_iters: int | None,
                         onehot_T) -> PoseGraph:
    """6-DoF variant over (N, 6) local coordinates; each GN iteration folds
    the rotation tangent into q0 (q0 ← q0·exp(δθ), δθ ← 0)."""
    q0 = mat_to_quat(ypr_to_mat(g.ypr))                        # (N, 4)
    t = g.t
    zero3 = torch.zeros_like(t)
    live = torch.ones((), dtype=torch.bool, device=t.device)
    gnorm = None
    for it in range(iters):
        if it > GNC_STEPS:
            live = live & (gnorm > _GN_GRAD_TOL)
        x = torch.cat([t, zero3], dim=-1)
        w = _loop_weights6(x, g, q0, _gnc_c(it))
        dx, gnorm = _gn_step(_linearize6(x, g, q0, w, onehot_T), x, g.node_mask,
                             cg_iters)
        x = x + dx
        t = torch.where(live, x[:, :3], t)
        q0 = torch.where(live, quat_mul(q0, so3_exp_quat(x[:, 3:])), q0)
    return g._replace(t=t, ypr=mat_to_ypr(quat_to_mat(q0)))


def _cg(Av, b, iters: int, rtol: float = 1e-3):
    """Conjugate gradient for SPD Av; a step runs only while the residual
    exceeds rtol relative to the start (masked, no read-back)."""
    x = torch.zeros_like(b)
    r, p = b, b
    rs = rs0 = torch.sum(b * b)
    live = torch.ones((), dtype=torch.bool, device=b.device)
    for _ in range(iters):
        live = live & (rs > rtol * rtol * rs0)
        Ap = Av(p)
        alpha = rs / torch.clamp(torch.sum(p * Ap), min=1e-12)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        rs_n = torch.sum(r_n * r_n)
        p_n = r_n + (rs_n / torch.clamp(rs, min=1e-12)) * p
        x, r, p, rs = (torch.where(live, a, b_) for a, b_ in
                       ((x_n, x), (r_n, r), (p_n, p), (rs_n, rs)))
    return x


def graph_poses(g: PoseGraph) -> Pose:
    """Current optimized keyframe poses as a batched Pose."""
    return Pose(g.t, mat_to_quat(ypr_to_mat(g.ypr)))
