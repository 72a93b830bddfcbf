"""Scan registration: point-to-line / point-to-plane Gauss-Newton.

Port of `lmono_tpu/lidar/registration.py`.  Correspondences come from the
exact brute-force KNN (`lmono_tpu_torch.ops.knn`, kernel K1 on CUDA
tensors), line and plane fits are closed-form batched
3×3 eigendecompositions, and the 6-DoF damped Gauss-Newton runs as a host
loop of fixed length over fixed-shape masked tensors.  Nothing in it reads
a device value back to the host.

With `axis` (a mesh `Axis`, `parallel/mesh.py`) the map banks are this
rank's shard of the global bank: K1 runs on the shard, and the per-shard
candidates are gathered over the axis and merged into the global top-k.
The JAX package leaves its Pallas kernel out inside `shard_map`; the port
keeps K1 there, since it is exact and the merge's result is the same.

Both residual kinds use the unified form r = A·(T·p − c), so edges and
planes share one batched Jacobian/normal-equation assembly:
  edge point  p with line (c, d̂):  A = I − d̂d̂ᵀ (rank-2 projector)
  planar point p with plane (n̂, ρ): A = n̂n̂ᵀ, c = −ρ·n̂
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from lmono_tpu_torch.config import LidarConfig
from lmono_tpu_torch.ops.knn import knn
from lmono_tpu_torch.utils.lie import Pose, quat_mul, quat_normalize, quat_rotate, so3_exp_quat


# --------------------------------------------------------------------------
# Closed-form batched symmetric 3×3 eigendecomposition
# --------------------------------------------------------------------------

def _det3(B: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of (..., 3, 3)."""
    return (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0]))


def _sym3x3_eigvals(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues (descending) of symmetric (..., 3, 3), analytic
    (trigonometric/Smith method) — no iteration, pure elementwise ops."""
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    I = torch.eye(3, dtype=A.dtype, device=A.device)
    B = A - q[..., None, None] * I
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    # clamp keeps p³ ≥ 1e-30 — representable in f32, so the degenerate
    # (isotropic/empty) case yields r = 0/(tiny) = 0, never 0/0 = NaN
    p = torch.sqrt(torch.clamp(p2, min=1e-20))
    r = _det3(B) / (2.0 * p ** 3)
    r = torch.clamp(r, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    l1 = q + 2.0 * p * torch.cos(phi)
    l3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    l2 = 3.0 * q - l1 - l3
    return torch.stack([l1, l2, l3], dim=-1)


def _eigvec_for(A: torch.Tensor, lam_a: torch.Tensor,
                lam_b: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of symmetric A for the eigenvalue NOT in {lam_a,
    lam_b}: columns of (A−λₐI)(A−λᵦI) span it; pick the largest column."""
    I = torch.eye(3, dtype=A.dtype, device=A.device)
    M = torch.matmul(A - lam_a[..., None, None] * I,
                     A - lam_b[..., None, None] * I)
    n2 = torch.sum(M * M, dim=-2)                    # (..., 3) column norms²
    col = torch.argmax(n2, dim=-1)
    v = torch.gather(M, -1, col[..., None, None].expand(M.shape[:-1] + (1,)))[..., 0]
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)


def _weighted_cov(nbrs: torch.Tensor, nbr_ok: torch.Tensor):
    w = nbr_ok.to(nbrs.dtype)[..., None]
    cnt = torch.clamp(torch.sum(w, dim=1), min=1.0)
    c = torch.sum(nbrs * w, dim=1) / cnt
    x = (nbrs - c[:, None, :]) * w
    cov = torch.einsum("qki,qkj->qij", x, x) / cnt[..., None]
    return c, cov


def fit_lines(nbrs: torch.Tensor, nbr_ok: torch.Tensor):
    """Line fit per query: nbrs (Q, k, 3), nbr_ok (Q, k).

    Returns (centroid (Q,3), dir (Q,3) unit, line_ok (Q,)).
    Line-ness gate: dominant eigenvalue ≥ 1.5× the rest.
    """
    c, cov = _weighted_cov(nbrs, nbr_ok)
    lam = _sym3x3_eigvals(cov)
    v = _eigvec_for(cov, lam[..., 1], lam[..., 2])   # dominant
    lam1 = lam[..., 0]
    lam_rest = torch.clamp(lam[..., 1] + lam[..., 2], min=0.0)
    line_ok = ((torch.sum(nbr_ok, dim=1) >= 3) & (lam1 > 1.5 * lam_rest)
               & (lam1 > 1e-6))
    return c, v, line_ok


def fit_planes(nbrs: torch.Tensor, nbr_ok: torch.Tensor, plane_tol: float = 0.2):
    """Plane fit per query: normal = smallest-eigenvalue direction of the
    neighbour covariance.

    Returns (normal (Q,3) unit, rho (Q,), plane_ok (Q,)) with the plane
    n·x + rho = 0.  plane_ok requires every inlier within `plane_tol`.
    """
    c, cov = _weighted_cov(nbrs, nbr_ok)
    lam = _sym3x3_eigvals(cov)
    n_unit = _eigvec_for(cov, lam[..., 0], lam[..., 1])  # smallest
    rho = -torch.einsum("qi,qi->q", n_unit, c)
    d = torch.abs(torch.einsum("qki,qi->qk", nbrs, n_unit) + rho[:, None])
    d = torch.where(nbr_ok, d, torch.zeros_like(d))
    plane_ok = ((torch.sum(nbr_ok, dim=1) >= 3)
                & (torch.amax(d, dim=1) < plane_tol))
    return n_unit, rho, plane_ok


# --------------------------------------------------------------------------
# Correspondence targets (recomputed between GN iterations)
# --------------------------------------------------------------------------

class EdgeCorr(NamedTuple):
    centroid: torch.Tensor   # (Qe, 3)
    direction: torch.Tensor  # (Qe, 3)
    ok: torch.Tensor         # (Qe,)


class PlaneCorr(NamedTuple):
    normal: torch.Tensor     # (Qp, 3)
    rho: torch.Tensor        # (Qp,)
    ok: torch.Tensor         # (Qp,)


def _knn_nbrs(query_w, bank, bank_mask, cfg: LidarConfig, center, axis=None):
    """k nearest neighbour distances and coords: (d2 (Q,k), nbrs (Q,k,3)).

    Every `knn_impl` value means the same KNN here; `knn_select` picks the
    selection key (`ops/knn.py:knn`): "exact" returns the neighbours by
    ascending d², "bf16x3" and "bf16" in selection order with exact d², as
    the JAX package's TPU route does.  Another value raises ValueError.

    axis: `bank` is this rank's shard; the shards' candidates, gathered in
    shard-major order, are merged by a stable sort on d², so a tie goes to
    the lower shard and then the lower index, the lower global index, as in
    the single-device KNN.  The global winners are among the union of the
    per-shard winners, so the merge is exact.  A one-rank axis skips the
    merge in exact mode, where the picks are sorted already.
    """
    d2, idx = knn(query_w, bank, bank_mask, cfg.knn_k, center=center,
                  select=cfg.knn_select)
    nbrs = bank[idx]
    if axis is None or (axis.size == 1 and cfg.knn_select == "exact"):
        return d2, nbrs
    # one gather of (d², x, y, z) per candidate: (Q, D·k, 4)
    packed = axis.all_gather(torch.cat([d2[..., None], nbrs], -1), 1, tiled=True)
    d2_all, sel = torch.sort(packed[..., 0], dim=1, stable=True)
    sel = sel[:, :cfg.knn_k]
    return d2_all[:, :cfg.knn_k], torch.gather(
        packed[..., 1:], 1, sel[..., None].expand(-1, -1, 3))


def find_edge_corr(query_w: torch.Tensor, qmask: torch.Tensor,
                   bank: torch.Tensor, bank_mask: torch.Tensor,
                   cfg: LidarConfig, center: torch.Tensor | None = None,
                   axis=None) -> EdgeCorr:
    d2, nbrs = _knn_nbrs(query_w, bank, bank_mask, cfg, center, axis)
    nbr_ok = (d2 < cfg.corr_max_dist ** 2) & qmask[:, None]
    c, v, ok = fit_lines(nbrs, nbr_ok)
    return EdgeCorr(c, v, ok & qmask)


def find_plane_corr(query_w: torch.Tensor, qmask: torch.Tensor,
                    bank: torch.Tensor, bank_mask: torch.Tensor,
                    cfg: LidarConfig, center: torch.Tensor | None = None,
                    axis=None) -> PlaneCorr:
    d2, nbrs = _knn_nbrs(query_w, bank, bank_mask, cfg, center, axis)
    nbr_ok = (d2 < cfg.corr_max_dist ** 2) & qmask[:, None]
    n, rho, ok = fit_planes(nbrs, nbr_ok)
    return PlaneCorr(n, rho, ok & qmask)


# --------------------------------------------------------------------------
# Damped Gauss-Newton over SE(3)
# --------------------------------------------------------------------------

def _transform(pose: Pose, pts: torch.Tensor) -> torch.Tensor:
    return quat_rotate(pose.q[None, :], pts) + pose.t


def _huber_w(r_norm: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight for the Huber loss."""
    return torch.where(r_norm <= delta, torch.ones_like(r_norm),
                       delta / torch.clamp(r_norm, min=1e-12))


def _unified_targets(ec: EdgeCorr, pc: PlaneCorr):
    """Stack edge and plane correspondences into one (Q, ...) batch of the
    unified residual r = A(Tp − c)."""
    I = torch.eye(3, dtype=ec.centroid.dtype, device=ec.centroid.device)
    A_e = I - torch.einsum("qi,qj->qij", ec.direction, ec.direction)
    A_p = torch.einsum("qi,qj->qij", pc.normal, pc.normal)
    c_p = -pc.rho[:, None] * pc.normal
    A = torch.cat([A_e, A_p], dim=0)
    c = torch.cat([ec.centroid, c_p], dim=0)
    ok = torch.cat([ec.ok, pc.ok], dim=0)
    return A, c, ok


def _skew_batch(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def build_normal_equations(pose: Pose, pts: torch.Tensor,
                           A: torch.Tensor, c: torch.Tensor, ok: torch.Tensor,
                           huber_delta: float):
    """Assemble H (6,6), b (6,), cost, inliers for the unified batch.

    Jacobians are analytic w.r.t. the local delta (dp global, dθ right-mul):
      T(δ)·p = R·exp(dθ)·p + t + dp ⇒ ∂(T·p)/∂dp = I, ∂(T·p)/∂dθ = −R[p]×,
      so ∂r/∂[dp dθ] = A · [I  −R[p]×].
    """
    Rm = pose.R
    pw = _transform(pose, pts)                              # (Q,3)
    r = torch.einsum("qij,qj->qi", A, pw - c)               # (Q,3)
    # hard-zero masked rows BEFORE any product: masked garbage (e.g. huge
    # rho from degenerate fits) would otherwise poison sums via inf*0=nan
    r = torch.where(ok[:, None], r, torch.zeros_like(r))
    Rp = -torch.einsum("ij,qjk->qik", Rm, _skew_batch(pts))  # (Q,3,3)
    J = torch.cat([A, torch.einsum("qij,qjk->qik", A, Rp)], dim=-1)
    rn = torch.linalg.vector_norm(r, dim=-1)
    w = _huber_w(rn, huber_delta) * ok.to(r.dtype)
    H = torch.einsum("qai,q,qaj->ij", J, w, J)
    b = torch.einsum("qai,q,qa->i", J, w, r)
    cost = torch.sum(w * rn ** 2)
    n_inlier = torch.sum(ok)
    return H, b, cost, n_inlier


def register(init_pose: Pose,
             edge_pts: torch.Tensor, edge_mask: torch.Tensor,
             plane_pts: torch.Tensor, plane_mask: torch.Tensor,
             edge_bank: torch.Tensor, edge_bank_mask: torch.Tensor,
             plane_bank: torch.Tensor, plane_bank_mask: torch.Tensor,
             cfg: LidarConfig, iters: int, axis=None) -> tuple[Pose, dict]:
    """Register a feature scan against target banks.

    Correspondences are re-found every two GN updates (LOAM practice; the
    KNN is the expensive half), so there are max(1, (iters+1)//2) outer
    iterations, each with one edge and one plane KNN.  The update is damped
    by `cfg.gn_damping`.  Returns (refined map-from-scan pose, diagnostics).

    axis: the banks are sharded over this mesh axis; only the
    correspondence search communicates (the candidate merge), and the
    merged targets are replicated, so the GN runs alike on every rank.
    """
    all_pts = torch.cat([edge_pts, plane_pts], dim=0)

    def gn_update(pose, A, c, ok):
        H, b, cost, n_in = build_normal_equations(
            pose, all_pts, A, c, ok, cfg.huber_delta)
        damp = cfg.gn_damping * (1.0 + torch.diagonal(H))
        # solve_ex does not synchronise to check for errors; a failed or
        # non-finite solve (degenerate geometry) is rejected on the device
        delta, info = torch.linalg.solve_ex(H + torch.diag(damp), -b)
        good = torch.all(torch.isfinite(delta)) & (info == 0) & (n_in > 10)
        delta = torch.where(good, delta, torch.zeros_like(delta))
        new_pose = Pose(
            pose.t + delta[:3],
            quat_normalize(quat_mul(pose.q, so3_exp_quat(delta[3:6]))),
        )
        return new_pose, cost, n_in

    pose = init_pose
    costs, inliers = [], []
    for _ in range(max(1, (iters + 1) // 2)):
        pw_e = _transform(pose, edge_pts)
        pw_p = _transform(pose, plane_pts)
        # recentering by the sensor position keeps coordinates ≤ max_range
        ec = find_edge_corr(pw_e, edge_mask, edge_bank, edge_bank_mask, cfg,
                            center=pose.t, axis=axis)
        pc = find_plane_corr(pw_p, plane_mask, plane_bank, plane_bank_mask,
                             cfg, center=pose.t, axis=axis)
        A, c, ok = _unified_targets(ec, pc)
        pose, cost, n_in = gn_update(pose, A, c, ok)
        pose, cost, n_in = gn_update(pose, A, c, ok)
        costs.append(cost)
        inliers.append(n_in)
    return pose, {"costs": torch.stack(costs), "inliers": torch.stack(inliers)}
