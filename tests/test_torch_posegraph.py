"""The port's pose graph (`lmono_tpu_torch.loop.posegraph`) against
`lmono_tpu.loop.posegraph`, on graphs built from the same numpy poses: a
circuit of keyframes with random-walk drift, two loop edges that agree with
the ground truth and one outlier edge metres off.

Tolerances:
* node and edge construction within 1e-6 (the same f32 formulas);
* residuals within 1e-5, the gradient Jᵀr and the products JᵀJv within
  1e-4 relative of the reference's jvp/vjp (the port applies J and Jᵀ from
  per-edge Jacobian blocks);
* `optimize_posegraph` (4-DoF and 6-DoF): poses within 1e-4 m / 1e-4 plus
  twice the reference's own spread under a one-ulp change of its input.
  Its GN stops after `iters` steps far from convergence on such chains and
  its CG exits at a 1e-3 relative residual, so where that exit falls moves
  its result (ROADMAP Queue 3);
* the fixed-count masked loops equal the early exit bit for bit: a CG that
  runs on past its exit, and a GN given more steps than it takes;
* the default solve (each GN step exact: dense J, one LU) against a plain
  f64 dense Gauss-Newton within 1e-4, its dense J against the block
  products within 1e-5 of their scale.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmono_tpu.loop import posegraph as jp
from lmono_tpu.utils import lie as jl
from lmono_tpu.utils.lie import Pose as JPose
from lmono_tpu_torch.convert import posegraph_from_numpy
from lmono_tpu_torch.loop import posegraph as tp
from lmono_tpu_torch.utils.lie import Pose as TPose
from torch_estimator_cases import one_torch_thread  # noqa: F401

N, CAP = 8, 8
# 4-DoF at the default budget; 6-DoF at a cut one (its eager Hv products
# cost ~1500 ops on the CPU)
BUDGET = {True: (20, 50), False: (12, 30)}
_opt = jax.jit(jp.optimize_posegraph, static_argnames=("iters", "cg_iters", "four_dof"))


def _circuit(n, drift=0.005, ydrift=0.0003, seed=0, radius=3.0):
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi * 1.1, n)
    gt = np.stack([radius * np.cos(th), radius * np.sin(th), 0.1 * np.sin(3 * th)], -1)
    yaw = th + np.pi / 2
    ypr = np.stack([yaw + np.cumsum(rng.normal(0, ydrift, n)),
                    np.full(n, 0.01), np.full(n, 0.02)], -1).astype(np.float32)
    q = np.asarray(jl.mat_to_quat(jl.ypr_to_mat(jnp.asarray(ypr))))
    t = (gt + np.cumsum(rng.normal(0, drift, (n, 3)), 0)).astype(np.float32)
    return gt.astype(np.float32), yaw.astype(np.float32), t, q


def _rel(gt, yaw, i, j, err=0.0):
    R = [np.asarray(jl.ypr_to_mat(jnp.asarray(np.array([yaw[k], 0.01, 0.02], np.float32))))
         for k in (i, j)]
    dt = (R[0].T @ (gt[j] - gt[i]) + err).astype(np.float32)
    return dt, np.asarray(jl.mat_to_quat(jnp.asarray(R[0].T @ R[1])))


@functools.lru_cache(maxsize=None)
def _graphs(outlier=True, n=N, cap=CAP, drift=0.005):
    """The same graph built by both packages: (reference, port)."""
    gt, yaw, t, q = _circuit(n, drift=drift, ydrift=0.06 * drift)
    g = jp.PoseGraph.empty(cap)
    G = tp.PoseGraph.empty(cap)
    for i in range(n):
        g = jp.graph_add_node(g, JPose(jnp.asarray(t[i]), jnp.asarray(q[i])))
        tp.graph_add_node(G, TPose(torch.tensor(t[i]), torch.tensor(q[i])), i)
    edges = [(0, n - 2, 0.0, 5.0), (1, n - 1, 0.0, 1.5)]
    if outlier:
        edges.append((2, n - 2, np.array([8.0, -6.0, 1.0], np.float32), 1.5))
    for k, (i, j, err, w) in enumerate(edges):
        dt, dq = _rel(gt, yaw, i, j, err)
        g = jp.graph_add_loop(g, i, j, JPose(jnp.asarray(dt), jnp.asarray(dq)), weight=w)
        tp.graph_add_loop(G, i, j, TPose(torch.tensor(dt), torch.tensor(dq)), k,
                          weight=w)
    return jax.device_get(g), G


def test_graph_construction_matches():
    g, G = _graphs()
    for f in tp.PoseGraph._fields:
        np.testing.assert_allclose(getattr(G, f).numpy(), np.asarray(getattr(g, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
    h, n_nodes, n_loops = posegraph_from_numpy(g, "cpu")
    assert (n_nodes, n_loops) == (N, 3)
    bigger = G.grown(2 * CAP)
    assert bigger.t.shape == (2 * CAP, 3) and torch.equal(bigger.t[:CAP], G.t)
    assert torch.equal(bigger.loop_w, G.loop_w) and int(bigger.n_nodes) == N


def _stacked(lin):
    """The port's residual blocks in the reference's order: the sequential
    edges' translations then their rotations, the loop edges' likewise,
    then the gauge."""
    parts = []
    for b in lin[:2]:
        parts += [b[:, :3].reshape(-1), b[:, 3:].reshape(-1)]
    return torch.cat(parts + [lin[2].reshape(-1)])


@pytest.mark.parametrize("four_dof", [True, False])
def test_residuals_and_products_match(four_dof):
    g, G = _graphs()
    g = jax.tree.map(jnp.asarray, g)
    rng = np.random.default_rng(1)
    c = jp._gnc_c(2)
    onehot = tp._incidence(G)
    if four_dof:
        x = np.concatenate([np.asarray(g.t), np.asarray(g.ypr[:, :1])], -1)
        x = (x + rng.normal(0, 0.01, x.shape)).astype(np.float32)
        f = lambda xx: jp._residuals(xx, g, c)
        tx = torch.from_numpy(x)
        lin = tp._linearize4(tx, G, tp._loop_weights4(tx, G, tp._gnc_c(2)), onehot)
    else:
        q0 = jl.mat_to_quat(jl.ypr_to_mat(g.ypr))
        x = np.concatenate([np.asarray(g.t), rng.normal(0, 0.01, (CAP, 3))], -1).astype(np.float32)
        f = lambda xx: jp._residuals6(xx, g, q0, c)
        tq0 = torch.from_numpy(np.asarray(q0))
        tx = torch.from_numpy(x)
        lin = tp._linearize6(tx, G, tq0, tp._loop_weights6(tx, G, tq0, tp._gnc_c(2)),
                             onehot)
    v = rng.normal(size=x.shape).astype(np.float32)

    @jax.jit
    def products(x, v):
        r, vjp = jax.vjp(f, x)
        return r, vjp(r)[0], vjp(jax.jvp(f, (x,), (v,))[1])[0]

    r, grad, hv = products(jnp.asarray(x), jnp.asarray(v))
    np.testing.assert_allclose(_stacked(lin.residuals()).numpy(), np.asarray(r),
                               rtol=0, atol=1e-5)
    tv = torch.from_numpy(v)
    for a, b in ((lin.JT(lin.residuals()), grad), (lin.JT(lin.J(tv)), hv)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).max()
    # Jv itself: the reference's jvp, stacked the same way
    jv = jax.jvp(f, (jnp.asarray(x),), (jnp.asarray(v),))[1]
    np.testing.assert_allclose(_stacked(lin.J(tv)).numpy(), np.asarray(jv), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(jv)).max()))


def _spread(g, four_dof):
    """The reference's own spread: its result moved by one ulp of input."""
    iters, cg = BUDGET[four_dof]
    a = _opt(g, iters=iters, cg_iters=cg, four_dof=four_dof)
    d = 0.0
    for s in (1 + 2 ** -23, 1 - 2 ** -23):
        b = _opt(g._replace(t=g.t * s), iters=iters, cg_iters=cg, four_dof=four_dof)
        pa, pb = jp.graph_poses(a), jp.graph_poses(b)
        d = max(d, float(jnp.abs(pa.t - pb.t).max()), float(jnp.abs(pa.q - pb.q).max()))
    return a, d


@pytest.mark.parametrize("four_dof", [True, False])
def test_optimize_posegraph_matches(four_dof):
    g, G = _graphs()
    ref, spread = _spread(g, four_dof)
    iters, cg = BUDGET[four_dof]
    out = tp.optimize_posegraph(G, iters=iters, cg_iters=cg, four_dof=four_dof)
    pj, pt = jp.graph_poses(ref), tp.graph_poses(out)
    dt = np.abs(pt.t.numpy() - np.asarray(pj.t))[:N].max()
    dq = np.abs(pt.q.numpy() - np.asarray(pj.q))[:N].max()
    print(f"4dof={four_dof}: dt {dt:.3g} m, dq {dq:.3g}, reference spread {spread:.3g}")
    assert dt <= 1e-4 + 2 * spread and dq <= 1e-4 + 2 * spread
    # the outlier edge is switched off: the graph moved by centimetres, not metres
    moved = np.abs(pt.t.numpy() - G.t.numpy())[:N].max()
    assert 1e-3 < moved < 0.1


def test_cg_fixed_count_equals_early_exit():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(24, 24)).astype(np.float32)
    A = torch.from_numpy(A @ A.T / 24 + np.eye(24, dtype=np.float32))
    b = torch.from_numpy(rng.normal(size=24).astype(np.float32))
    Av = lambda v: A @ v
    # the reference's loop with a host exit, in the port's arithmetic
    x, r, p = torch.zeros_like(b), b, b
    rs = rs0 = torch.sum(b * b)
    it = 0
    while it < 200 and bool(rs > 1e-3 * 1e-3 * rs0):
        Ap = Av(p)
        alpha = rs / torch.clamp(torch.sum(p * Ap), min=1e-12)
        x, r = x + alpha * p, r - alpha * Ap
        rs_n = torch.sum(r * r)
        p = r + (rs_n / torch.clamp(rs, min=1e-12)) * p
        rs, it = rs_n, it + 1
    assert 3 < it < 200
    assert torch.equal(tp._cg(Av, b, 200), x)
    jx = jp._cg(lambda v: jnp.asarray(A.numpy()) @ v, jnp.asarray(b.numpy()), 200)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-5)


@pytest.mark.parametrize("four_dof", [True, False])
def test_gn_fixed_count_equals_early_exit(four_dof):
    """A graph without an outlier converges right after the GNC window
    (the 6-DoF one, slower, with exact odometry): more GN steps change
    nothing, bit for bit, and the reference agrees."""
    g, G = _graphs(outlier=False, n=6, cap=8, drift=0.005 if four_dof else 0.0)
    cg = 20 if four_dof else 12
    a = tp.optimize_posegraph(G, iters=9, cg_iters=cg, four_dof=four_dof)
    b = tp.optimize_posegraph(G, iters=12, cg_iters=cg, four_dof=four_dof)
    assert torch.equal(a.t, b.t) and torch.equal(a.ypr, b.ypr)
    ref = _opt(g, iters=12, cg_iters=cg, four_dof=four_dof)
    np.testing.assert_allclose(b.t.numpy(), np.asarray(ref.t), rtol=0, atol=1e-4)


@pytest.mark.parametrize("four_dof", [True, False])
def test_optimize_at_a_grown_capacity(four_dof):
    """The graph as `SlamSystem` grows it (512 → 4096 nodes by doubling),
    here at 2048: the same live nodes and edges in the larger capacity
    solve to the poses of the small capacity within 1e-5 (dead nodes add
    zero blocks; only the reductions' lengths change), and to the
    reference's at that capacity within 1e-4.  The graph is one that
    converges (no outlier, as in `test_gn_fixed_count_equals_early_exit`),
    so the CG's exit does not move the result."""
    n, cap = 6, 2048
    g, G = _graphs(outlier=False, n=n, cap=cap)
    _, small = _graphs(outlier=False, n=n, cap=8)
    iters, cg = BUDGET[four_dof]
    a = tp.graph_poses(tp.optimize_posegraph(small, iters=iters, cg_iters=cg,
                                             four_dof=four_dof))
    b = tp.graph_poses(tp.optimize_posegraph(G, iters=iters, cg_iters=cg,
                                             four_dof=four_dof))
    ref = jp.graph_poses(_opt(g, iters=iters, cg_iters=cg, four_dof=four_dof))
    for x, y, tol in ((b.t, a.t, 1e-5), (b.q, a.q, 1e-5),
                      (b.t, ref.t, 1e-4), (b.q, ref.q, 1e-4)):
        np.testing.assert_allclose(x[:n].numpy(), np.asarray(y)[:n], rtol=0, atol=tol)
    assert torch.equal(b.t[n:], G.t[n:])


def _f64_solve6(G, iters: int):
    """A plain f64 dense Gauss-Newton of a 6-DoF graph's live nodes, the
    rotations as matrices: at each iterate the loop edges' robust weights
    under the port's annealed kernel, the whole residual vector (chain
    edges × their mask, loop edges × their weights, the gauge 100·(t₀ −
    stored t₀, δθ₀)), J by jacfwd over every node's (δt, δθ) at once,
    (JᵀJ + 1e-4·I) dx = −Jᵀr by LU, then t ← t + δt, R ← R·Exp(δθ).
    Returns (t, R)."""
    from lmono_tpu_torch.utils import lie

    f = lambda a: a.to(torch.float64)                       # noqa: E731
    n = int(G.n_nodes)
    t, R = f(G.t[:n]), lie.ypr_to_mat(f(G.ypr[:n]))
    anchor = t[0].clone()
    k = torch.arange(n - 1)
    chain = (k, k + 1, f(G.seq_dt[:n - 1]), lie.quat_to_mat(f(G.seq_dq[:n - 1])))
    on = G.loop_mask
    loops = (G.loop_i[on], G.loop_j[on], f(G.loop_dt[on]), lie.quat_to_mat(f(G.loop_dq[on])))

    def edges(t, R, i, j, dt, dR):
        Ri_T = R[i].transpose(1, 2)
        return torch.cat([(Ri_T @ (t[j] - t[i])[..., None])[..., 0] - dt,
                          lie.so3_log_mat(dR.transpose(1, 2) @ Ri_T @ R[j])], -1)

    def residuals(x, w):
        tt, RR = t + x[:, :3], R @ lie.so3_exp_mat(x[:, 3:])
        return torch.cat([(edges(tt, RR, *chain) * f(G.seq_mask[:n - 1])[:, None]).reshape(-1),
                          (edges(tt, RR, *loops) * w[:, None]).reshape(-1),
                          100.0 * (tt[0] - anchor), 100.0 * x[0, 3:]])

    for it in range(iters):
        c = tp.ROBUST_C * 2.0 ** min(max(tp.GNC_STEPS - it, 0), 10)
        e = edges(t, R, *loops)
        err = torch.linalg.vector_norm(e[:, :3], dim=-1) + 3.0 * torch.linalg.vector_norm(
            e[:, 3:], dim=-1)
        w = f(G.loop_w[on]) / (1.0 + (err / c) ** 2)
        zero = torch.zeros((n, 6), dtype=torch.float64)
        r = residuals(zero, w)
        J = torch.func.jacfwd(lambda x: residuals(x, w))(zero).reshape(r.shape[0], -1)
        H = J.T @ J + 1e-4 * torch.eye(J.shape[1], dtype=torch.float64)
        dx = torch.linalg.solve(H, -(J.T @ r)).reshape(n, 6)
        t, R = t + dx[:, :3], R @ lie.so3_exp_mat(dx[:, 3:])
    return t, R


@pytest.mark.parametrize("four_dof", [True, False])
def test_exact_solve_matches_a_plain_f64_gauss_newton(four_dof):
    """The default solve (each GN step's normal equations exact) on the
    circuit with its outlier edge, against the same damped, annealed
    Gauss-Newton written plainly in f64 over the live nodes: the
    benchmark's `slambench.steps.graph_solve` in 4-DoF, `_f64_solve6` in
    6-DoF.  Positions within 1e-4 m, rotation matrices within 1e-4; the
    outlier switched off as in `test_optimize_posegraph_matches`."""
    from lmono_tpu_torch.utils import lie
    from slambench.steps import graph_solve

    _, G = _graphs()
    out = tp.optimize_posegraph(G, iters=20, four_dof=four_dof)
    if four_dof:
        x = graph_solve(G._asdict())
        t_ref = x[:, :3]
        R_ref = lie.ypr_to_mat(torch.cat([x[:, 3:], G.ypr[:N, 1:].double()], -1))
    else:
        t_ref, R_ref = _f64_solve6(G, 20)
    dt = (out.t[:N].double() - t_ref).abs().max().item()
    dR = (lie.ypr_to_mat(out.ypr[:N].double()) - R_ref).abs().max().item()
    print(f"4dof={four_dof}: dt {dt:.3g} m, dR {dR:.3g}")
    assert dt <= 1e-4 and dR <= 1e-4
    moved = np.abs(out.t.numpy() - G.t.numpy())[:N].max()
    assert 1e-3 < moved < 0.1


@pytest.mark.parametrize("four_dof", [True, False])
def test_dense_jacobian_matches_the_products(four_dof):
    """`_Linearization.dense()` (what the exact step factors) against the
    block products that the CG applies: J v and Jᵀ u within 1e-5 of their
    scale, on a graph grown to 4× its nodes (dead nodes: zero columns)."""
    _, G = _graphs()
    G = G.grown(4 * CAP)
    rng = np.random.default_rng(3)
    onehot = tp._incidence(G)
    if four_dof:
        x = torch.cat([G.t, G.ypr[:, :1]], -1)
        lin = tp._linearize4(x, G, tp._loop_weights4(x, G, tp._gnc_c(2)), onehot)
    else:
        q0 = tp.mat_to_quat(tp.ypr_to_mat(G.ypr))
        x = torch.cat([G.t, torch.zeros_like(G.t)], -1)
        lin = tp._linearize6(x, G, q0, tp._loop_weights6(x, G, q0, tp._gnc_c(2)), onehot)
    J = lin.dense()
    n, d = x.shape
    v = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    jv = torch.cat([b.reshape(-1) for b in lin.J(v)])
    assert J.shape == (jv.shape[0], n * d)
    assert (J @ v.reshape(-1) - jv).abs().max() <= 1e-5 * jv.abs().max()
    u = lin.J(v)
    jtu = lin.JT(u).reshape(-1)
    assert (J.T @ jv - jtu).abs().max() <= 1e-5 * jtu.abs().max()
    assert torch.all(J[:, N * d:] == 0)


def test_exact_solve_reaches_the_f64_optimum():
    """A graph from a reap of the benchmark's revisit (75 nodes at the
    512-node capacity, 18 loop edges, seed 20261018:
    `tests/data/posegraph_optimal_start.npz`).  The default solve ends at
    the benchmark's dense f64 optimum (`slambench.steps.graph_solve`):
    under that optimum's loop weights its cost is no more than 1e-6 above
    the optimum's, and its nodes lie within 1e-3 of it.  (The budgeted CG,
    `cg_iters=50`, ends 2.6% above, 0.89 m away.)"""
    from slambench.steps import (ROBUST_C, _graph, _loop_weights, _residuals,
                                 graph_solve)

    raw = {k: torch.from_numpy(v) for k, v in
           np.load(Path(__file__).parent / "data" / "posegraph_optimal_start.npz").items()}
    cap, L = raw["t"].shape[0], raw["loop_i"].shape[0]
    ident = torch.tensor([1.0, 0, 0, 0])
    G = tp.PoseGraph(**raw, node_mask=torch.arange(cap) < int(raw["n_nodes"]),
                     seq_dq=ident.repeat(cap, 1), loop_dq=ident.repeat(L, 1),
                     n_loops=raw["loop_mask"].sum().to(torch.int32))
    out = tp.optimize_posegraph(G, iters=20)
    x_ref = graph_solve(raw)
    ref = _graph(raw, torch.float64)
    n = ref["n"]
    x = torch.cat([out.t[:n], out.ypr[:n, :1]], -1).double()
    w = _loop_weights(x_ref, ref, ROBUST_C)
    f_out, f_ref = (float(torch.sum(_residuals(y, ref, w) ** 2)) for y in (x, x_ref))
    print(f"cost {f_out!r} against {f_ref!r}, nodes {float((x - x_ref).abs().max()):.3g} apart")
    assert f_out <= f_ref * (1 + 1e-6)
    assert (x - x_ref).abs().max() <= 1e-3
    assert torch.equal(out.t[n:], G.t[n:])
