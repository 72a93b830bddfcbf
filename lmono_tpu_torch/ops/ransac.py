"""Batched-hypothesis RANSAC solvers: fundamental matrix and PnP.

Port of `lmono_tpu/ops/ransac.py`.  All hypotheses are solved as one
batched program (8-point / DLT), scored in parallel, and the best refit on
its inliers.  The reference's `vmap` over hypotheses is a leading batch
dimension here; `ransac_pnp` takes further leading dimensions (the loop
detector's candidates).

The reference draws its samples from a JAX key, which torch cannot replay,
so `ransac_fundamental` takes the sample indices and `ransac_pnp` the
Gumbel noise; `masked_categorical` turns that noise into indices exactly as
`jax.random.categorical` does.  The PnP Gauss-Newton step takes its
Jacobian in closed form where the reference differentiates with `jacfwd`,
and solves the damped 6×6 system with `solve_ex` where the reference
unrolls a Cholesky: the same step up to rounding.
"""

from __future__ import annotations

import torch

from lmono_tpu_torch.utils.lie import Pose, mat_to_quat, quat_rotate, quat_to_mat, skew


def gumbel_noise(shape: tuple, generator: torch.Generator,
                 device=None) -> torch.Tensor:
    """Standard Gumbel noise of `shape` drawn from `generator`."""
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def masked_categorical(mask: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """Indices drawn uniformly among `mask`'s set entries: mask (N,) bool,
    gumbel (..., N) standard Gumbel noise → (...) int64.

    `jax.random.categorical(key, logits[None], shape=s)` is
    `argmax(logits + gumbel(key, s + (N,)), -1)` with logits 0 on valid
    entries and −1e9 elsewhere; given the same noise, this is equal.
    """
    logits = torch.where(mask, 0.0, -1e9).to(gumbel.dtype)
    return torch.argmax(logits + gumbel, dim=-1)


def _eight_point(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Normalized 8-point: x0,x1 (..., 8, 2) normalized coords → F (..., 3, 3)."""
    u0, v0 = x0[..., 0], x0[..., 1]
    u1, v1 = x1[..., 0], x1[..., 1]
    A = torch.stack([u1 * u0, u1 * v0, u1, v1 * u0, v1 * v0, v1, u0, v0,
                     torch.ones_like(u0)], dim=-1)          # (..., 8, 9)
    # nullspace via unrolled Householder QR; rank-2 projection removes the
    # smallest right-singular component: F(I − nnᵀ) with n = argmin ‖F n‖
    F = _qr_nullvec(A).reshape(A.shape[:-2] + (3, 3))
    n = _nullvec(F, iters=24)
    Fn = (F @ n[..., None])[..., 0]
    return F - Fn[..., :, None] * n[..., None, :]


def _sampson(F: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Sampson distance of each correspondence under each F:
    F (..., 3, 3), x0/x1 (N, 2) normalized coords → (..., N)."""
    ones = torch.ones_like(x0[..., :1])
    p0 = torch.cat([x0, ones], -1)
    p1 = torch.cat([x1, ones], -1)
    Fx0 = p0 @ F.transpose(-1, -2)      # (..., N, 3)
    Ftx1 = p1 @ F                       # (..., N, 3)
    num = torch.sum(p1 * Fx0, dim=-1) ** 2
    den = Fx0[..., 0] ** 2 + Fx0[..., 1] ** 2 + Ftx1[..., 0] ** 2 + Ftx1[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def ransac_fundamental(x0: torch.Tensor, x1: torch.Tensor, mask: torch.Tensor,
                       samples: torch.Tensor, thresh: float = 1e-4
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """RANSAC F-matrix on normalized coords.

    x0,x1: (N,2); mask: (N,) valid correspondences; samples: (iters, 8)
    indices (see `masked_categorical`).  thresh is the squared Sampson
    distance in normalized units ((px/f)²).
    Returns (inlier_mask (N,), best_F (3,3)).
    """
    Fs = _eight_point(x0[samples], x1[samples])             # (iters,3,3)
    d = _sampson(Fs, x0, x1)                                # (iters,N)
    inl = (d < thresh) & mask[None, :]
    best = torch.argmax(inl.sum(dim=-1))
    # guard: degenerate sample sets (few valid) → accept everything valid
    enough = mask.sum() >= 9
    return torch.where(enough, inl[best], mask), Fs[best]


def _nullvec(A: torch.Tensor, iters: int = 48) -> torch.Tensor:
    """Unit vector minimizing ‖A v‖ when the spectral gap is healthy (e.g.
    projecting a near-rank-2 3×3 F): power iteration on M = c·I − AᵀA with
    c = tr(AᵀA) ≥ λmax."""
    AtA = A.transpose(-1, -2) @ A
    n = AtA.shape[-1]
    c = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    M = c * torch.eye(n, dtype=A.dtype, device=A.device) - AtA
    # deterministic full-spectrum init (no zero component in any basis dir)
    v = (torch.ones(AtA.shape[:-2] + (n,), dtype=A.dtype, device=A.device)
         + 0.1 * torch.arange(n, dtype=A.dtype, device=A.device))
    for _ in range(iters):
        v = (M @ v[..., None])[..., 0]
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)
    return v


def _qr_nullvec(A: torch.Tensor) -> torch.Tensor:
    """Nullspace vector of A (..., m, n) with m ∈ {n−1, n} and nullity 1:
    unrolled Householder QR, then back-substitution with the last variable
    pinned to 1 (`x[n-1] = 1`, as the reference does; ROADMAP Queue 3).
    Returns a unit (..., n) vector."""
    m, n = A.shape[-2], A.shape[-1]
    batch = A.shape[:-2]
    R = A
    r = min(m, n - 1)              # columns to eliminate
    for k in range(r):
        col = R[..., k:, k]                              # (..., m-k)
        nrm = torch.sqrt(torch.sum(col * col, dim=-1, keepdim=True))
        s = torch.where(col[..., :1] >= 0, 1.0, -1.0)
        e0 = torch.zeros(m - k, dtype=A.dtype, device=A.device)
        e0[0] = 1.0
        v = col + s * nrm * e0
        vn2 = torch.clamp(torch.sum(v * v, dim=-1, keepdim=True), min=1e-30)
        sub = R[..., k:, :]                              # (..., m-k, n)
        proj = (v[..., None, :] @ sub)[..., 0, :]        # (..., n)
        sub = sub - (2.0 / vn2)[..., None] * v[..., :, None] * proj[..., None, :]
        R = torch.cat([R[..., :k, :], sub], dim=-2)
    # back-substitution: x[n-1] = 1, solve the r×r upper block
    x = [torch.ones(batch, dtype=A.dtype, device=A.device)
         for _ in range(r, n)]
    x = [None] * r + x
    for i in reversed(range(r)):
        s = torch.zeros(batch, dtype=A.dtype, device=A.device)
        for j2 in range(i + 1, n):
            s = s + R[..., i, j2] * x[j2]
        d = R[..., i, i]
        tiny = torch.where(d < 0, -1e-12, 1e-12).to(A.dtype)
        d = torch.where(torch.abs(d) < 1e-12, tiny, d)
        x[i] = -s / d
    v = torch.stack(x, dim=-1)
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)


def _det3(M: torch.Tensor) -> torch.Tensor:
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _inv3(M: torch.Tensor) -> torch.Tensor:
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    adj = torch.stack([torch.stack([A, B, C], -1),
                       torch.stack([D, E, F], -1),
                       torch.stack([G, H, I], -1)], -2)
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    return adj / det[..., None, None]


def _sign_or_one(v: torch.Tensor) -> torch.Tensor:
    s = torch.sign(v)
    return torch.where(s == 0, torch.ones_like(s), s)


def _polar3(M: torch.Tensor, iters: int = 9) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest rotation (polar factor) of 3×3 M with det(R) = +1, plus the
    mean singular value (the DLT scale), by the Newton iteration
    R ← (R + R⁻ᵀ)/2."""
    Ms = M * _sign_or_one(_det3(M))[..., None, None]
    nrm = torch.sqrt(torch.sum(Ms * Ms, dim=(-2, -1), keepdim=True) / 3.0)
    R = Ms / torch.clamp(nrm, min=1e-12)
    for _ in range(iters):
        R = 0.5 * (R + _inv3(R).transpose(-1, -2))
    return R, torch.sum(R * Ms, dim=(-2, -1)) / 3.0


def _dlt_pnp(X: torch.Tensor, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Hartley-normalized DLT pose from 6 3D-2D correspondences: X (..., 6, 3),
    x (..., 6, 2) normalized → (R (..., 3, 3), t (..., 3)), x ~ project(R X + t).
    The nullspace's projective sign is fixed by det(M) > 0."""
    ctr = torch.mean(X, dim=-2)
    scale = torch.sqrt(torch.mean(torch.sum((X - ctr[..., None, :]) ** 2, -1), -1)) + 1e-9
    Xn = (X - ctr[..., None, :]) / scale[..., None, None]
    Xh = torch.cat([Xn, torch.ones_like(Xn[..., :1])], -1)        # (..., 6, 4)
    zeros = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zeros, -x[..., 0:1] * Xh], -1)
    r2 = torch.cat([zeros, Xh, -x[..., 1:2] * Xh], -1)
    A = torch.cat([r1, r2], -2)                                     # (..., 12, 12)
    P = _qr_nullvec(A).reshape(A.shape[:-2] + (3, 4))
    M = P[..., :3]
    R, pscale = _polar3(M)
    pscale = torch.where(torch.abs(pscale) < 1e-12, torch.full_like(pscale, 1e-12), pscale)
    t_n = _sign_or_one(_det3(M))[..., None] * P[..., 3] / pscale[..., None]
    t = scale[..., None] * t_n - (R @ ctr[..., None])[..., 0]
    return R, t


def _reproj_err2(R, t, X, x) -> torch.Tensor:
    """Squared reprojection error of X (..., N, 3) against x (..., N, 2)
    under (R, t) (..., 3, 3), (..., 3); points behind the camera cost 1e9."""
    Pc = X @ R.transpose(-1, -2) + t[..., None, :]
    z = torch.clamp(Pc[..., 2], min=1e-6)
    e2 = torch.sum((Pc[..., :2] / z[..., None] - x) ** 2, dim=-1)
    return torch.where(Pc[..., 2] <= 1e-6, torch.full_like(e2, 1e9), e2)


def _pnp_gn_refine(R, t, X, x, w, iters: int = 5) -> Pose:
    """Damped Gauss-Newton on SE(3) minimizing the w-weighted reprojection
    error; batched over the leading dimensions of (R, t, w), which X (..., N,
    3) and x (..., N, 2) broadcast against.  The pose is retracted as
    `Pose.retract` does (t + dp, q ⊗ exp(dθ)), whose Jacobian at 0 is
    [I, −R[X]×] on the camera point."""
    pose = Pose(t, mat_to_quat(R))
    sk = skew(X)                                                # (..., N, 3, 3)
    eye6 = 1e-6 * torch.eye(6, dtype=t.dtype, device=t.device)
    for _ in range(iters):
        Rm = quat_to_mat(pose.q)
        Pc = quat_rotate(pose.q[..., None, :], X) + pose.t[..., None, :]
        front = Pc[..., 2] > 1e-6
        z = torch.clamp(Pc[..., 2], min=1e-6)
        proj = Pc[..., :2] / z[..., None]
        r = (proj - x) * w[..., None]                           # (..., N, 2)
        # d proj / d Pc: the clamped depth has no derivative behind the camera
        inv_z = (w / z)[..., None]
        dz = -proj * (inv_z * front[..., None].to(z.dtype))
        zero = torch.zeros_like(dz[..., :1])
        Jp = torch.stack([torch.cat([inv_z, zero, dz[..., :1]], -1),
                          torch.cat([zero, inv_z, dz[..., 1:]], -1)], -2)   # (..., N, 2, 3)
        J = torch.cat([Jp, -(Jp @ Rm[..., None, :, :]) @ sk], -1)          # (..., N, 2, 6)
        H = torch.einsum("...nai,...naj->...ij", J, J) + eye6
        g = torch.einsum("...nai,...na->...i", J, r)
        delta, _ = torch.linalg.solve_ex(H, -g)
        ok = torch.all(torch.isfinite(delta), dim=-1, keepdim=True)
        pose = pose.retract(torch.where(ok, delta, torch.zeros_like(delta)))
    return pose


def ransac_pnp(X: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
               gumbel: torch.Tensor, thresh: float = 1e-4, min_inliers: int = 5,
               prior_pose: Pose | None = None
               ) -> tuple[Pose, torch.Tensor, torch.Tensor]:
    """RANSAC PnP: world points X (..., N, 3) ↔ normalized obs x (..., N, 2),
    mask (..., N); gumbel (..., iters, 6, N) draws the minimal samples (see
    `masked_categorical`).  Leading dimensions batch independent problems.

    Each 6-point sample gives a DLT pose refined by GN on the sample; the
    optional `prior_pose` (..., camera-from-world) competes raw and after a
    wide-gate LO refine; the best-scoring hypothesis is LO-refined at a
    shrinking gate.  Returns (camera-from-world Pose, inlier_mask, ok flag).
    """
    X = X.expand(mask.shape + (3,))
    x = x.expand(mask.shape + (2,))
    samp = masked_categorical(mask[..., None, None, :], gumbel)   # (..., iters, 6)
    X_ = X[..., None, :, :]                                       # (..., 1, N, 3)
    x_ = x[..., None, :, :]

    def take(v):  # (..., N, c) → (..., iters, 6, c)
        idx = samp.reshape(samp.shape[:-2] + (-1,))[..., None]
        out = torch.gather(v, -2, idx.expand(idx.shape[:-1] + (v.shape[-1],)))
        return out.reshape(samp.shape + (v.shape[-1],))

    R, t = _dlt_pnp(take(X), take(x))
    w = torch.zeros(samp.shape[:-1] + (X.shape[-2],), dtype=X.dtype, device=X.device)
    w = w.scatter(-1, samp, 1.0)
    hyp = _pnp_gn_refine(R, t, X_, x_, w, iters=8)
    Rs, ts = quat_to_mat(hyp.q), hyp.t

    def apply(pose, X):
        return quat_rotate(pose.q[..., None, :], X) + pose.t[..., None, :]

    def lo_refine(R, t, widen):
        """LO-RANSAC: re-estimate the inliers at a shrinking gate and
        GN-refine on them, for poses batched like `mask`."""
        pose = Pose.from_Rt(R, t)
        for f in widen:
            Pc = apply(pose, X)
            z = torch.clamp(Pc[..., 2], min=1e-6)
            e2 = torch.sum((Pc[..., :2] / z[..., None] - x) ** 2, dim=-1)
            w = ((e2 < f * thresh) & mask & (Pc[..., 2] > 1e-6)).to(X.dtype)
            pose = _pnp_gn_refine(quat_to_mat(pose.q), pose.t, X, x, w)
        return pose

    if prior_pose is not None:
        Rp = quat_to_mat(prior_pose.q)
        pri = lo_refine(Rp, prior_pose.t, (16.0, 4.0))
        Rs = torch.cat([Rs, Rp[..., None, :, :], quat_to_mat(pri.q)[..., None, :, :]], -3)
        ts = torch.cat([ts, prior_pose.t[..., None, :], pri.t[..., None, :]], -2)
    e2 = _reproj_err2(Rs, ts, X_, x_)                              # (..., H, N)
    scores = torch.sum((e2 < thresh) & mask[..., None, :], dim=-1)
    best = torch.argmax(scores, dim=-1, keepdim=True)              # first of the best
    R_b = torch.gather(Rs, -3, best[..., None, None].expand(best.shape + (3, 3)))[..., 0, :, :]
    t_b = torch.gather(ts, -2, best[..., None].expand(best.shape + (3,)))[..., 0, :]
    pose = lo_refine(R_b, t_b, (4.0, 2.0, 1.0))
    Pc = apply(pose, X)
    z = torch.clamp(Pc[..., 2], min=1e-6)
    e2f = torch.sum((Pc[..., :2] / z[..., None] - x) ** 2, dim=-1)
    inlier_mask = (e2f < thresh) & mask & (Pc[..., 2] > 1e-6)
    return pose, inlier_mask, torch.sum(inlier_mask, dim=-1) >= min_inliers
