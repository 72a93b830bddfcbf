"""Intrinsic camera calibration: Zhang's homography initialization, a joint
Gauss–Newton refinement, chessboard corner detection and PnP extrinsics.

Port of `lmono_tpu/camera/calibration.py`.  The planar-target homographies
give the closed-form K (Zhang 2000), per-view poses follow from H, and a
dense `torch.func.jacfwd` Gauss–Newton refines intrinsics, distortion and
every view pose together.  Each solve is a fixed count of steps with no
read-back between them (the reference's `lax.scan`); `calibrate_camera`
runs its focal (×ξ) candidates as one batch under `torch.func.vmap`, as
the reference vmaps them.

Array inputs may be numpy or tensors.  Tensors stay on their device; numpy
inputs go to `device`, the CUDA card unless another is named
(`lmono_tpu_torch.default_device`).  Corner detection runs its image ops on
the image's device and orders the candidates on the host, as the
reference does.
"""

from __future__ import annotations

from itertools import combinations
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import jacfwd, vmap

from lmono_tpu_torch import default_device
from lmono_tpu_torch.camera.models import (
    _equi_s2p,
    _mei_s2p,
    _pinhole_s2p,
    _radtan_distort,
)
from lmono_tpu_torch.ops.image import gauss_blur3, max_pool_same
from lmono_tpu_torch.utils.lie import Pose, _cross, mat_to_quat


class CalibResult(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    dist: np.ndarray        # (k1, k2, p1, p2)
    view_poses: Pose        # (V,) camera-from-board
    reproj_rmse: float


def _as_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _device_of(x, device) -> torch.device:
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return default_device(device)


def _homography_dlt(obj_xy: torch.Tensor, img_xy: torch.Tensor) -> torch.Tensor:
    """Planar DLT homographies: board coords (..., N, 2) → pixels (..., N, 2),
    batched over leading dimensions; H[2, 2] = 1."""
    obj_xy, img_xy = torch.broadcast_tensors(obj_xy, img_xy)
    x, y = obj_xy[..., 0], obj_xy[..., 1]
    u, v = img_xy[..., 0], img_xy[..., 1]
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], -1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], -1)
    A = torch.cat([r1, r2], dim=-2)
    _, _, Vh = torch.linalg.svd(A, full_matrices=False)
    H = Vh[..., -1, :].reshape(Vh.shape[:-2] + (3, 3))
    return H / H[..., 2:3, 2:3]


def _zhang_intrinsics(Hs: np.ndarray) -> tuple[float, float, float, float]:
    """Closed-form K from ≥3 homographies (Zhang's B-matrix constraints), in
    float64 on the host."""
    def vij(H, i, j):
        return np.array([
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j],
        ])

    V = []
    for H in Hs:
        V.append(vij(H, 0, 1))
        V.append(vij(H, 0, 0) - vij(H, 1, 1))
    _, _, Vt = np.linalg.svd(np.stack(V))
    b11, b12, b22, b13, b23, b33 = Vt[-1]
    cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
    lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
    fx = np.sqrt(abs(lam / b11))
    fy = np.sqrt(abs(lam * b11 / (b11 * b22 - b12 * b12)))
    cx = -b13 * fx * fx / lam
    return float(fx), float(fy), float(cx), float(cy)


def _pose_from_homography(H: np.ndarray, K: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Camera-from-board (t, R) from H = K [r1 r2 t], float64 on the host."""
    Kinv = np.linalg.inv(K)
    h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
    lam = 1.0 / np.linalg.norm(Kinv @ h1)
    r1 = lam * (Kinv @ h1)
    r2 = lam * (Kinv @ h2)
    t = lam * (Kinv @ h3)
    r3 = np.cross(r1, r2)
    R = np.stack([r1, r2, r3], axis=1)
    U, _, Vt = np.linalg.svd(R)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = -R
    if t[2] < 0:   # board must be in front of the camera
        R[:, :2] *= -1
        t = -t
    return t, R


def _view_points(pose_t, pose_q, dp, obj3) -> torch.Tensor:
    """The board points (N, 3) in each view's camera frame (V, N, 3), the
    view poses (V,) retracted by dp (V, 6)."""
    pv = Pose(pose_t, pose_q).retract(dp)
    return Pose(pv.t[:, None], pv.q[:, None]).apply(obj3)


def calibrate_pinhole(obj_xy, img_xy, iters: int = 20, device=None) -> CalibResult:
    """Full intrinsic calibration from V planar views.

    obj_xy: (N, 2) board coordinates (same for every view, meters);
    img_xy: (V, N, 2) detected corner pixels.  Zhang's closed form seeds a
    joint GN over (fx, fy, cx, cy, k1, k2, p1, p2) and the 6V pose terms:
    `iters` damped steps, read back once at the end.
    """
    dev = _device_of(img_xy, device)
    obj = _as_f32(obj_xy, dev)
    img = _as_f32(img_xy, dev)
    Vn = img.shape[0]

    Hs = _homography_dlt(obj, img).cpu().numpy()
    fx, fy, cx, cy = _zhang_intrinsics(Hs)
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    tR = [_pose_from_homography(Hs[v], K) for v in range(Vn)]
    pose_t = torch.tensor(np.stack([t for t, _ in tR]), dtype=torch.float32, device=dev)
    pose_q = mat_to_quat(torch.tensor(np.stack([R for _, R in tR]),
                                      dtype=torch.float32, device=dev))
    obj3 = torch.cat([obj, torch.zeros_like(obj[:, :1])], -1)

    def flat_res(x):
        fx_, fy_, cx_, cy_, k1, k2, p1, p2 = x[:8]
        P = _view_points(pose_t, pose_q, x[8:].reshape(Vn, 6), obj3)
        xy = P[..., :2] / torch.clamp(P[..., 2:3], min=1e-6)
        xy_d = xy + _radtan_distort(k1, k2, p1, p2, xy)
        u = fx_ * xy_d[..., 0] + cx_
        v = fy_ * xy_d[..., 1] + cy_
        r = (torch.stack([u, v], -1) - img).reshape(-1)
        return r, r

    x = torch.cat([torch.tensor([fx, fy, cx, cy, 0.0, 0.0, 0.0, 0.0],
                                dtype=torch.float32, device=dev),
                   torch.zeros(Vn * 6, device=dev)])
    eye = 1e-3 * torch.eye(x.shape[0], device=dev)
    rmse = torch.zeros((), device=dev)
    for _ in range(iters):
        J, r = jacfwd(flat_res, has_aux=True)(x)
        dx, _ = torch.linalg.solve_ex(J.T @ J + eye, J.T @ r)
        x = x - dx
        rmse = torch.sqrt(torch.mean(r * r))
    th = x[:8].double().cpu().numpy()
    poses = Pose(pose_t, pose_q).retract(x[8:].reshape(Vn, 6))
    return CalibResult(fx=float(th[0]), fy=float(th[1]), cx=float(th[2]),
                       cy=float(th[3]), dist=th[4:8], view_poses=poses,
                       reproj_rmse=float(rmse))


# --------------------------------------------------------------------------
# General intrinsic calibration for pinhole / MEI / Kannala–Brandt: one
# autodiff GN over (θ, view poses) per focal candidate, the candidates as
# one batch; the converged minimum wins (wide-FoV models have no Zhang
# closed form).
# --------------------------------------------------------------------------

class CalibResultGeneric(NamedTuple):
    model: str
    params: dict            # model parameter dict (floats)
    view_poses: Pose        # (V,) camera-from-board
    reproj_rmse: float


# θ layout per model (the optimized parameter vector)
_MODEL_THETA = {
    "pinhole": ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2"),
    "mei": ("gamma1", "gamma2", "u0", "v0", "xi", "k1", "k2", "p1", "p2"),
    "equidistant": ("mu", "mv", "u0", "v0", "k2", "k3", "k4", "k5"),
}
_S2P = {"pinhole": _pinhole_s2p, "mei": _mei_s2p, "equidistant": _equi_s2p}


def _project(model: str, theta, P):
    p = {k: theta[i] for i, k in enumerate(_MODEL_THETA[model])}
    return _S2P[model](p, P)


def _lift_nodist(model: str, theta: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Normalized-plane lift ignoring distortion, for pose initialization
    only (the joint GN absorbs the rest).  theta (..., T) broadcasts
    against uv (..., N, 2) with one parameter vector per row of N."""
    t = [theta[..., i, None] for i in range(5)]
    if model == "pinhole":
        fx, fy, cx, cy = t[:4]
        return torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], -1)
    if model == "mei":
        g1, g2, u0, v0, xi = t
        mx = (uv[..., 0] - u0) / g1
        my = (uv[..., 1] - v0) / g2
        r2 = mx * mx + my * my
        disc = 1.0 + (1.0 - xi * xi) * r2
        z = 1.0 - xi * (r2 + 1.0) / (xi + torch.sqrt(torch.clamp(disc, min=1e-9)))
        z = torch.clamp(z, min=1e-3)
        return torch.stack([mx / z, my / z], -1)
    # equidistant: rd = f·θ ⇒ tanθ scaling
    mu, mv, u0, v0 = t[:4]
    x = (uv[..., 0] - u0) / mu
    y = (uv[..., 1] - v0) / mv
    rd = torch.sqrt(x * x + y * y)
    s = torch.tan(rd) / torch.clamp(rd, min=1e-9)
    return torch.stack([x * s, y * s], -1)


def _pose_from_h_batched(H: torch.Tensor) -> Pose:
    """`_pose_from_homography` with K = I for homographies on the normalized
    plane (..., 3, 3), on the device: the sign flipped so the board lies in
    front of the camera, R projected onto SO(3)."""
    h1, h2, h3 = H[..., :, 0], H[..., :, 1], H[..., :, 2]
    lam = 1.0 / torch.clamp(torch.linalg.vector_norm(h1, dim=-1), min=1e-9)
    sgn = torch.where(h3[..., 2] * lam < 0, -1.0, 1.0)
    s = (sgn * lam)[..., None]
    r1, r2, t = s * h1, s * h2, s * h3
    R = torch.stack([r1, r2, _cross(r1, r2)], dim=-1)
    U, _, Vh = torch.linalg.svd(R)
    R = U @ Vh
    R = torch.where(torch.linalg.det(R)[..., None, None] < 0, -R, R)
    return Pose(t, mat_to_quat(R))


def calibrate_camera(model: str, obj_xy, img_xy,
                     image_size: tuple[int, int] | None = None,
                     iters: int = 40, device=None) -> CalibResultGeneric:
    """Intrinsic calibration for the pinhole / MEI / Kannala–Brandt models.

    obj_xy: (N, 2) board coordinates (meters); img_xy: (V, N, 2) pixels;
    image_size: (W, H) for the principal-point and focal-sweep priors (the
    detections' bounding box when None).  Every focal (×ξ for MEI)
    candidate runs `iters` damped GN steps over (θ, view poses) in one
    batch; the lowest final RMSE wins (one read-back).
    """
    if model not in _MODEL_THETA:
        raise ValueError(f"unknown model {model!r}; supported: {sorted(_MODEL_THETA)}")
    dev = _device_of(img_xy, device)
    obj = _as_f32(obj_xy, dev)
    img = _as_f32(img_xy, dev)
    Vn = img.shape[0]
    obj3 = torch.cat([obj, torch.zeros_like(obj[:, :1])], -1)
    if image_size is None:
        img_np = np.asarray(img_xy.cpu() if isinstance(img_xy, torch.Tensor) else img_xy)
        W = float(np.max(img_np[..., 0]) + np.min(img_np[..., 0]))
        H = float(np.max(img_np[..., 1]) + np.min(img_np[..., 1]))
    else:
        W, H = float(image_size[0]), float(image_size[1])
    cx0, cy0 = W / 2.0, H / 2.0

    f_cands = np.array([0.4, 0.7, 1.0, 1.5, 2.2]) * max(W, H) / 2.0
    if model == "mei":
        thetas = [np.array([f * (1 + xi), f * (1 + xi), cx0, cy0, xi, 0, 0, 0, 0])
                  for f in f_cands for xi in (0.6, 1.0, 1.6)]
    else:
        thetas = [np.array([f, f, cx0, cy0, 0, 0, 0, 0]) for f in f_cands]
    theta0 = torch.tensor(np.stack(thetas), dtype=torch.float32, device=dev)   # (C, T)
    C, T = theta0.shape

    # per-view pose init: normalized-plane homography at each candidate's
    # intrinsics (distortion-free lift)
    xy_n = _lift_nodist(model, theta0[:, None, :], img)                    # (C, V, N, 2)
    poses0 = _pose_from_h_batched(_homography_dlt(obj, xy_n))             # (C, V)

    def res_one(x, pose_t, pose_q):
        P = _view_points(pose_t, pose_q, x[T:].reshape(Vn, 6), obj3)
        r = (_project(model, x[:T], P) - img).reshape(-1)
        return r, r

    step = vmap(jacfwd(res_one, has_aux=True))
    x = torch.cat([theta0, torch.zeros(C, Vn * 6, device=dev)], dim=1)
    rmse = torch.zeros(C, device=dev)
    for _ in range(iters):
        J, r = step(x, poses0.t, poses0.q)                               # (C, R, D), (C, R)
        JtJ = J.transpose(1, 2) @ J
        damp = 1e-3 * (1.0 + torch.diagonal(JtJ, dim1=1, dim2=2))
        dx, _ = torch.linalg.solve_ex(JtJ + torch.diag_embed(damp),
                                      (J.transpose(1, 2) @ r[..., None])[..., 0])
        ok = torch.all(torch.isfinite(dx), dim=1, keepdim=True)
        x = torch.where(ok, x - dx, x)
        rmse = torch.sqrt(torch.mean(r * r, dim=1))
    rmses = torch.where(torch.isfinite(rmse), rmse, 1e12).cpu().numpy()
    best = int(np.argmin(rmses))
    theta = x[best, :T].double().cpu().numpy()
    poses = Pose(poses0.t[best], poses0.q[best]).retract(x[best, T:].reshape(Vn, 6))
    params = {k: float(theta[i]) for i, k in enumerate(_MODEL_THETA[model])}
    return CalibResultGeneric(model=model, params=params, view_poses=poses,
                              reproj_rmse=float(rmses[best]))


# --------------------------------------------------------------------------
# Chessboard corner detection (reference `camera_models/src/chessboard/`)
# --------------------------------------------------------------------------

def _cross2(a: np.ndarray, b: np.ndarray) -> float:
    """The z component of the cross product of two 2-D vectors."""
    return float(a[0] * b[1] - a[1] * b[0])


def _convex_hull(pts: np.ndarray) -> np.ndarray:
    """Andrew monotone chain; returns hull vertices in CCW order."""
    P = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(points):
        h = []
        for p in points:
            while len(h) >= 2 and _cross2(h[-1] - h[-2], p - h[-2]) <= 0:
                h.pop()
            h.append(p)
        return h

    lower = half(P)
    upper = half(P[::-1])
    return np.array(lower[:-1] + upper[:-1])


def _homography_4pt(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Exact homography from 4 correspondences (src → dst), 8×8 solve."""
    A, b = [], []
    for (x, y), (u, v) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        b.append(u)
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b.append(v)
    h = np.linalg.solve(np.asarray(A, float), np.asarray(b, float))
    return np.concatenate([h, [1.0]]).reshape(3, 3)


def _apply_h(Hm: np.ndarray, pts: np.ndarray) -> np.ndarray:
    ph = np.concatenate([pts, np.ones((len(pts), 1))], -1) @ Hm.T
    return ph[:, :2] / ph[:, 2:3]


def _dlt_ls(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    A = []
    for (x, y), (u, v) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    _, _, Vt = np.linalg.svd(np.asarray(A))
    return Vt[-1].reshape(3, 3)


def _order_grid_homography(pts: np.ndarray, rows: int, cols: int):
    """Row-major grid ordering under any perspective: the largest
    quadrilateral of hull corners defines a homography from the ideal
    (cols−1)×(rows−1) grid; each candidate's back-projected grid coordinate,
    rounded, is its cell.  Returns the ordered (rows·cols, 2) corners, or
    None when no corner assignment fills the grid."""
    hull = _convex_hull(pts)
    if len(hull) < 4:
        return None
    best_q, best_a = None, -1.0
    for quad in combinations(range(len(hull)), 4):
        q = hull[list(quad)]
        a = 0.5 * abs(sum(
            q[i, 0] * q[(i + 1) % 4, 1] - q[(i + 1) % 4, 0] * q[i, 1]
            for i in range(4)))
        if a > best_a:
            best_a, best_q = a, q
    tgt = np.array([[0, 0], [cols - 1, 0], [cols - 1, rows - 1],
                    [0, rows - 1]], float)
    grid_set = {(r, c) for r in range(rows) for c in range(cols)}

    for flip in (False, True):
        q4 = best_q[::-1] if flip else best_q
        for s in range(4):
            qs = np.roll(q4, -s, axis=0)
            try:
                Hm = _homography_4pt(tgt, qs)
                g = _apply_h(np.linalg.inv(Hm), pts)
            except np.linalg.LinAlgError:
                continue
            # two least-squares refits on the well-assigned majority pull
            # the mid-grid corners onto the lattice
            for _ in range(2):
                gr = np.round(g)
                good = np.max(np.abs(g - gr), axis=1) < 0.35
                if good.sum() < max(8, (rows * cols) // 2):
                    break
                try:
                    H2 = _dlt_ls(gr[good], pts[good])
                    g = _apply_h(np.linalg.inv(H2), pts)
                except np.linalg.LinAlgError:
                    break
            # each lattice cell takes its closest candidate; every cell
            # must be filled
            gr = np.round(g).astype(int)
            dev = np.max(np.abs(g - gr), axis=1)
            chosen = {}
            for i in range(len(pts)):
                if dev[i] > 0.4:
                    continue
                cell = (gr[i, 1], gr[i, 0])
                if cell not in grid_set:
                    continue
                if cell not in chosen or dev[i] < dev[chosen[cell]]:
                    chosen[cell] = i
            if set(chosen) != grid_set:
                continue
            ordered = pts[[chosen[(r, c)] for r in range(rows) for c in range(cols)]]
            # orientation gate: the board seen from its front maps the grid
            # axes onto the image axes preserving orientation
            if _cross2(ordered[1] - ordered[0], ordered[cols] - ordered[0]) <= 0:
                continue
            return ordered
    return None


def _quadrant_kernel(device) -> torch.Tensor:
    """The 11×11 X-junction kernel: +1 on opposite quadrants, −1 on the
    adjacent ones, 0 on the axes."""
    yy, xx = np.mgrid[-5:6, -5:6]
    return torch.tensor((np.sign(xx) * np.sign(yy)).astype(np.float32),
                        device=device)[None, None]


def find_chessboard_corners(image: torch.Tensor, rows: int, cols: int
                            ) -> tuple[torch.Tensor, bool]:
    """Detect the inner chessboard corners and order them row-major.

    X-junction response (the quadrant kernel as a `conv2d`) → 7×7 NMS →
    the strongest rows·cols + 10 by a stable sort (read back once) →
    strongest-first merging of responses within 6 px → homography-guided
    grid ordering on the host, with a PCA-axis fallback.  Returns
    (corners (rows·cols, 2) float32 on the image's device, ok).
    """
    img = gauss_blur3(image)
    resp = F.conv2d(img[None, None], _quadrant_kernel(img.device), padding=5)[0, 0]
    resp = torch.abs(resp)
    resp_nms = torch.where(resp >= max_pool_same(resp, 7), resp, 0.0).reshape(-1)
    n = rows * cols
    n_cand = n + 10
    flat_idx = torch.argsort(-resp_nms, stable=True)[:n_cand]
    strengths = resp_nms[flat_idx]
    W = image.shape[1]
    flat_idx, strengths = flat_idx.cpu().numpy(), strengths.cpu().numpy()
    ok = bool(strengths[n - 1] > 0.25 * strengths[0])
    cand_all = np.stack([(flat_idx % W).astype(np.float32),
                         (flat_idx // W).astype(np.float32)], -1).astype(np.float64)

    keep = []
    for i in range(len(cand_all)):     # strength-ordered already
        if all(np.linalg.norm(cand_all[i] - cand_all[j]) >= 6.0 for j in keep):
            keep.append(i)
        if len(keep) == n:
            break
    if len(keep) < n:
        keep = list(range(n))
    cand = cand_all[keep]
    ordered = _order_grid_homography(cand, rows, cols)
    if ordered is None:
        # PCA-axis ordering (near-frontal boards with degenerate hulls)
        c = cand.mean(0)
        X = cand - c
        _, _, Vt = np.linalg.svd(X, full_matrices=False)
        a0, a1 = Vt[0], Vt[1]
        if cols < rows:      # the long axis (more corners) is the column axis
            a0, a1 = a1, a0
        s, t = X @ a0, X @ a1
        order = np.lexsort((s, np.round((t - t.min()) / max(np.ptp(t), 1e-9)
                                        * (rows - 1))))
        ordered = cand[order]
    return torch.tensor(ordered, dtype=torch.float32, device=image.device), ok


# --------------------------------------------------------------------------
# Extrinsic estimation (camodocal `Camera::estimateExtrinsics`: PnP on
# undistorted normalized points)
# --------------------------------------------------------------------------

def estimate_extrinsics(cam, obj_pts, img_pts, gumbel: torch.Tensor | None = None,
                        iters: int = 128, thresh: float = 1e-4,
                        generator: torch.Generator | None = None, device=None):
    """Camera-from-world pose of a calibrated camera from 3D↔pixel matches,
    for every camera model: pixels are lifted to the normalized plane
    through the model's own lift, then RANSAC DLT + GN (`ransac_pnp`).

    gumbel: (iters, 6, N) Gumbel noise of the minimal samples (port
    convention for the reference's PRNG key: pass `jax.random.gumbel(key,
    (iters, 6, N))` to draw the reference's samples); drawn from
    `generator` (seed 0 when None) when not given.
    Returns (Pose camera-from-world, inlier_mask, ok flag).
    """
    from lmono_tpu_torch.ops.ransac import gumbel_noise, ransac_pnp

    dev = _device_of(img_pts, device)
    obj = _as_f32(obj_pts, dev)
    xy = cam.lift_to_normalized(_as_f32(img_pts, dev))
    mask = torch.ones(obj.shape[0], dtype=torch.bool, device=dev)
    if gumbel is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        gumbel = gumbel_noise((iters, 6, obj.shape[0]), generator, dev)
    return ransac_pnp(obj, xy, mask, gumbel.to(dev), thresh=thresh)
