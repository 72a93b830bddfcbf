"""Plain step references: each follows one stage of the program from the
inputs the program handed that stage, and says how far the program's
answer lies from its own.

* the hand-eye's relative pose (`relpose_gaps`): the 8-point RANSAC over
  the program's tracks and its own draws (the Gumbel noise it turns into
  sample indices), the essential matrix's four poses and the cheirality
  vote; per frame the angle between the program's rotation and the nearest
  of the reference's best accepting hypotheses, 0 where both refuse the
  pair, and 180° where one side accepts it and the other refuses it;
* marginalization (`marg_gap`): the Schur complement of the oldest pose and
  of the depths anchored at it, formed densely from the program's residuals
  and Jacobians at its linearization point, against the information JᵀJ and
  vector Jᵀr of the prior the program made from them;
* the pose-graph solve (`graph_excess`): a dense Gauss-Newton of the 4-DoF
  graph the program handed its solve, with the same robust kernel and
  annealing, run to convergence; per solve the share of the cost reduction
  from the graph before to the reference's optimum that the program's
  optimum leaves unmade (0: as low as the reference; 1: unchanged).

`dtype` is the arithmetic: float64 for the reference, the control's
bfloat16 (the SVDs and linear solves, which bfloat16 lacks, take float32
on bfloat16 operands and round back).
"""

from __future__ import annotations

import math

import torch

RP_THRESH = (1.5 / 460.0) ** 2     # squared Sampson distance, normalized
ROBUST_C = 0.3                     # the pose graph's robust kernel scale
GNC_STEPS = 6                      # ... annealed over the first GN steps
GRAPH_ITERS = 20                   # the reference's GN steps (converged)


def _exact(dtype) -> bool:
    return dtype in (torch.float32, torch.float64)


def _svd(A, dtype):
    if _exact(dtype):
        return torch.linalg.svd(A)
    U, S, Vh = torch.linalg.svd(A.float())
    return U.to(dtype), S.to(dtype), Vh.to(dtype)


def _solve(A, b, dtype, damp: float = 0.0):
    """A x = b, damp·I added in float32 at least; least squares where A is
    singular (a bfloat16 matrix can round to one)."""
    work = A.dtype if _exact(dtype) else torch.float32
    A = A.to(work) + damp * torch.eye(A.shape[0], dtype=work, device=A.device)
    x, info = torch.linalg.solve_ex(A, b.to(work))
    if int(info) != 0:
        x = torch.linalg.lstsq(A, b.to(work)).solution
    return x.to(dtype)


def _det_sign(M):
    return torch.sign(torch.linalg.det(M.double())).to(M.dtype)


# --------------------------------------------------------------------------
# Relative pose of the hand-eye
# --------------------------------------------------------------------------

def quat_to_mat(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _rot_angle_deg(R):
    """Angle of a rotation matrix, stable near 0."""
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.rad2deg(torch.atan2(0.5 * torch.linalg.vector_norm(v, dim=-1),
                                     0.5 * (tr - 1.0)))


NEAR_BEST = 2                      # inlier counts within this of the best


def relative_pose(x0, x1, mask, gumbel, dtype=torch.float64):
    """Every hypothesis of an 8-point RANSAC on normalized coordinates x0,
    x1 (N, 2), valid `mask` (N,), its samples drawn as argmax(logits +
    gumbel) over the valid rows (gumbel (iters, 8, N)): a hypothesis is the
    null vector of its 8×9 system made rank 2, its inliers the valid rows
    within RP_THRESH of squared Sampson distance (all valid rows where fewer
    than 9 are valid).  Returns (counts (I,), R (I, 3, 3) the rotation of
    frames, cam1 from cam0, of the pose the cheirality vote picks among the
    essential matrix's four, ok (I,): 15 inliers and 70% of them in front
    of both cameras under that pose, best: the first of the most inliers)."""
    logits = torch.where(mask, 0.0, -1e9).to(gumbel.dtype)
    samples = torch.argmax(logits + gumbel, dim=-1)                  # (I, 8)
    x0, x1 = x0.to(dtype), x1.to(dtype)
    a, b = x0[samples], x1[samples]
    u0, v0, u1, v1 = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    A = torch.stack([u1 * u0, u1 * v0, u1, v1 * u0, v1 * v0, v1, u0, v0,
                     torch.ones_like(u0)], -1)                       # (I, 8, 9)
    F = _svd(A, dtype)[2][..., -1, :].reshape(-1, 3, 3)
    U, S, Vh = _svd(F, dtype)
    S = S * torch.tensor([1.0, 1.0, 0.0], dtype=dtype, device=S.device)
    F = U @ torch.diag_embed(S) @ Vh
    ones = torch.ones_like(x0[:, :1])
    p0, p1 = torch.cat([x0, ones], -1), torch.cat([x1, ones], -1)
    Fx0 = p0 @ F.transpose(-1, -2)
    Ftx1 = p1 @ F
    num = torch.sum(p1 * Fx0, -1) ** 2
    den = Fx0[..., 0] ** 2 + Fx0[..., 1] ** 2 + Ftx1[..., 0] ** 2 + Ftx1[..., 1] ** 2
    inl = (num / torch.clamp(den, min=1e-12) < RP_THRESH) & mask[None]
    if int(mask.sum()) < 9:
        inl = mask[None].expand_as(inl)
    counts = inl.sum(-1)
    U, _, Vh = _svd(F, dtype)
    U, Vh = U * _det_sign(U)[:, None, None], Vh * _det_sign(Vh)[:, None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=dtype, device=U.device)
    R1, R2, t = U @ W @ Vh, U @ W.T @ Vh, U[..., 2]
    cands_R = torch.stack([R1, R1, R2, R2], 1)                       # (I, 4, 3, 3)
    cands_t = torch.stack([t, -t, t, -t], 1)                         # (I, 4, 3)
    d1_in0 = p1 @ cands_R                                            # (I, 4, N, 3)
    a00 = torch.sum(p0 * p0, -1)
    a01 = -torch.sum(p0 * d1_in0, -1)
    a11 = torch.sum(d1_in0 * d1_in0, -1)
    Rt_t = (cands_R.transpose(-1, -2) @ cands_t[..., None])[..., None, :, 0]
    rhs0 = -torch.sum(p0 * Rt_t, -1)
    rhs1 = torch.sum(d1_in0 * Rt_t, -1)
    det = a00 * a11 - a01 * a01
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    z0 = (rhs0 * a11 - a01 * rhs1) / det
    z1 = (a00 * rhs1 - a01 * rhs0) / det
    votes = torch.sum((z0 > 0) & (z1 > 0) & inl[:, None], -1)        # (I, 4)
    k = torch.argmax(votes, -1)
    R = cands_R[torch.arange(k.shape[0], device=k.device), k].transpose(-1, -2)
    ok = (counts >= 15) & (votes.amax(-1) > 0.7 * counts)
    return counts, R.double(), ok, int(torch.argmax(counts))


def relpose_gaps(calls: list, dtype=torch.float64, control: bool = False) -> list:
    """Per call (x0, x1, mask, gumbel, q, ok) of the program: where it
    accepts the pair, the smallest angle in degrees between its rotation q
    and that of an accepting hypothesis of the reference's whose inliers
    number within NEAR_BEST of the most (a borderline row moves a count by
    one on either side), 180 where there is none; where it refuses, 0 if
    the reference's best refuses too, else 180.  control: the reference's
    best in `dtype` answers in the program's place."""
    gaps = []
    for x0, x1, mask, gumbel, q, ok in calls:
        counts, R_ref, ok_ref, best = relative_pose(x0, x1, mask, gumbel)
        if control:
            _, R_lo, ok_lo, b_lo = relative_pose(x0, x1, mask, gumbel, dtype)
            R, ok = R_lo[b_lo], bool(ok_lo[b_lo])
        else:
            R, ok = quat_to_mat(q.double()), bool(ok)
        near = (counts >= counts.max() - NEAR_BEST) & ok_ref
        if not ok:
            gaps.append(0.0 if not bool(ok_ref[best]) else 180.0)
        elif not bool(near.any()):
            gaps.append(180.0)
        else:
            ang = _rot_angle_deg(R.T.to(R_ref.device)[None] @ R_ref[near])
            gaps.append(float(ang.min()))
    return gaps


# --------------------------------------------------------------------------
# Marginalization
# --------------------------------------------------------------------------

def marg_schur(m: dict, dtype=torch.float64):
    """The prior's information S and vector b over the kept coordinates
    [poses 1..W | extrinsic] from the program's rows: m holds `w1`,
    `J_rep` (R, P + M) and `r_rep` (R,) of the reprojection factors at the
    linearization point, `J_pose` (Rp, P) and `r_pose` (Rp,) of the pose
    factors touching pose 0.  Pose 0 (coordinates 0..5) and every depth
    are eliminated by one dense Schur complement, 1e-8 on the eliminated
    block's diagonal."""
    w1 = int(m["w1"])
    P = 6 * w1 + 6
    J_rep, J_pose = m["J_rep"].to(dtype), m["J_pose"].to(dtype)
    R, C = J_rep.shape
    J = torch.zeros((R + J_pose.shape[0], C), dtype=dtype, device=J_rep.device)
    J[:R] = J_rep
    J[R:, :P] = J_pose
    r = torch.cat([m["r_rep"], m["r_pose"]]).to(dtype)
    H, g = J.T @ J, J.T @ r
    dev = J.device
    drop = torch.cat([torch.arange(6, device=dev), torch.arange(P, C, device=dev)])
    keep = torch.arange(6, P, device=dev)
    Hmm = H[drop][:, drop] + 1e-8 * torch.eye(drop.numel(), dtype=dtype, device=dev)
    Hkm = H[keep][:, drop]
    X = _solve(Hmm, torch.cat([Hkm.T, g[drop, None]], 1), dtype)
    S = H[keep][:, keep] - Hkm @ X[:, :-1]
    b = g[keep] - Hkm @ X[:, -1]
    return S.double(), b.double()


def prior_info(m: dict):
    """The program's prior (J (P, P), r0 (P,), post-slide) as S = JᵀJ and
    b = Jᵀr over the kept coordinates, in marg_schur's order."""
    w1 = int(m["w1"])
    P = 6 * w1 + 6
    K, pose_dims = P - 6, 6 * (w1 - 1)
    Jf = m["J"].double()
    J = torch.cat([Jf[:K, :pose_dims], Jf[:K, 6 * w1:]], 1)
    r = m["r0"].double()[:K]
    return J.T @ J, J.T @ r


def marg_gap(m: dict, dtype=torch.float64, control: bool = False) -> float:
    """The larger of the relative gaps ‖S − S_ref‖/‖S_ref‖ (Frobenius) and
    ‖b − b_ref‖/‖b_ref‖ between the program's prior (or, with control, the
    reference's in `dtype`) and the reference's; 1e9 where the program
    made its prior without the two sets of rows the reference follows."""
    if "J_rep" not in m:
        return 1e9
    S_ref, b_ref = marg_schur(m)
    S, b = marg_schur(m, dtype) if control else prior_info(m)
    gs = torch.linalg.matrix_norm(S - S_ref) / torch.linalg.matrix_norm(S_ref)
    gb = torch.linalg.vector_norm(b - b_ref) / torch.clamp(
        torch.linalg.vector_norm(b_ref), min=1e-300)
    return float(torch.maximum(gs, gb))


# --------------------------------------------------------------------------
# Pose graph
# --------------------------------------------------------------------------

def _wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def ypr_to_mat(yaw, pitch, roll):
    """Rz(yaw) Ry(pitch) Rx(roll)."""
    cy, sy, cp, sp = torch.cos(yaw), torch.sin(yaw), torch.cos(pitch), torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    return torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
        torch.stack([-sp, cp * sr, cp * cr], -1),
    ], -2)


def _edges4(xi, xj, pr_i, dt, dyaw):
    """4-DoF edge residuals (E, 4): node j seen from node i, whose rotation
    is (yaw_i, pitch_i, roll_i), less the measurement (dt, dyaw)."""
    R = ypr_to_mat(xi[:, 3], pr_i[:, 0], pr_i[:, 1])
    d = (R.transpose(1, 2) @ (xj[:, :3] - xi[:, :3])[..., None])[..., 0]
    return torch.cat([d - dt, _wrap(xj[:, 3:] - xi[:, 3:] - dyaw[:, None])], -1)


def _loop_weights(x, g, c):
    r = _edges4(x[g["loop_i"]], x[g["loop_j"]], g["pr"][g["loop_i"]], g["loop_dt"],
                g["loop_dyaw"])
    e = torch.linalg.vector_norm(r[:, :3], dim=-1) + 3.0 * torch.abs(r[:, 3])
    return g["loop_w"] * g["loop_mask"] / (1.0 + (e / c) ** 2)


def _residuals(x, g, w):
    """Every residual of the graph at x (n, 4): the sequential edges scaled
    by their mask, the loop edges by their weights w, the gauge 100·(x₀ −
    anchor)."""
    n = x.shape[0]
    seq = _edges4(x[:-1], x[1:], g["pr"][:-1], g["seq_dt"][:n - 1],
                  g["seq_dyaw"][:n - 1]) * g["seq_mask"][:n - 1, None]
    loop = _edges4(x[g["loop_i"]], x[g["loop_j"]], g["pr"][g["loop_i"]], g["loop_dt"],
                   g["loop_dyaw"]) * w[:, None]
    return torch.cat([seq.reshape(-1), loop.reshape(-1), 100.0 * (x[0] - g["anchor"])])


def _graph(g: dict, dtype):
    """The live part of a captured graph in `dtype`: nodes 0..n-1, the loop
    slots that are set."""
    n = int(g["n_nodes"])
    live = g["loop_mask"].bool() & (g["loop_i"] < n) & (g["loop_j"] < n)
    f = lambda k: g[k].to(dtype)   # noqa: E731
    return {"n": n, "pr": f("ypr")[:n, 1:], "seq_dt": f("seq_dt")[:n],
            "seq_dyaw": f("seq_dyaw")[:n], "seq_mask": f("seq_mask")[:n],
            "loop_i": g["loop_i"][live], "loop_j": g["loop_j"][live],
            "loop_dt": f("loop_dt")[live], "loop_dyaw": f("loop_dyaw")[live],
            "loop_mask": f("loop_mask")[live], "loop_w": f("loop_w")[live],
            "anchor": torch.cat([f("t")[0], f("ypr")[0, :1]]),
            "x": torch.cat([f("t")[:n], f("ypr")[:n, :1]], -1)}


def graph_solve(g: dict, dtype=torch.float64):
    """The reference's optimum of captured graph g: GRAPH_ITERS damped GN
    steps with dense normal equations, the loop weights recomputed at each
    iterate under the kernel annealed from ROBUST_C·2⁶ to ROBUST_C."""
    G = _graph(g, dtype)
    x = G["x"]
    for it in range(GRAPH_ITERS):
        c = ROBUST_C * 2.0 ** min(max(GNC_STEPS - it, 0), 10)
        w = _loop_weights(x, G, c)
        r = _residuals(x, G, w)
        J = torch.func.jacfwd(lambda y: _residuals(y, G, w))(x).reshape(r.shape[0], -1)
        dx = _solve(J.T @ J, -(J.T @ r), dtype, damp=1e-4)
        x = (x + dx.reshape(x.shape)).to(dtype)
    return x


def graph_excess(solve: dict, control: bool = False, dtype=torch.float64) -> float:
    """Share of the cost reduction left unmade by one solve: (F(out) −
    F(ref)) / |F(in) − F(ref)|, F the squared residuals under the loop
    weights of the reference's optimum x_ref at the final kernel.  solve
    holds the graph before (`g`) and the program's optimized nodes (`t`,
    `ypr`); with control the reference's optimum in `dtype` stands in for
    the program's.  Where the annealed kernel leaves x_ref above the graph
    before under F (a start that was already optimal), the program is held
    to the reference's answer on the scale of that gap, so that the
    reference's own answer reads 0 there too.  0.0 where the two costs tie,
    unless the program ends above the graph before."""
    g = solve["g"]
    G = _graph(g, torch.float64)
    x_ref = graph_solve(g)
    n = G["n"]
    if control:
        x_out = graph_solve(g, dtype).double()
    else:
        x_out = torch.cat([solve["t"][:n], solve["ypr"][:n, :1]], -1).double()
    w = _loop_weights(x_ref, G, ROBUST_C)
    cost = lambda x: float(torch.sum(_residuals(x, G, w) ** 2))   # noqa: E731
    f_in, f_out, f_ref = cost(G["x"]), cost(x_out), cost(x_ref)
    room = abs(f_in - f_ref)
    if not room > 1e-9 * max(f_ref, 1.0):
        return 0.0 if math.isfinite(f_out) and f_out <= f_in * (1 + 1e-6) + 1e-12 else 1e9
    return (f_out - f_ref) / room
