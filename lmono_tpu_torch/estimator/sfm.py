"""Global SfM over a window: PnP chaining + two-view triangulation + full BA.

Port of `lmono_tpu/estimator/sfm.py`, the rebuild of the reference's
`GlobalSFM` (`mono_lidar_mapping/src/initial/SFM.cc:1-310`: `construct`,
`solveFrameByPnP`, `triangulateTwoFrames`, and the Ceres full-BA block at
the end of `construct`): a camera-only bootstrap of a window from tracks.

Shapes are fixed, as in the JAX package:
  * the observations are a (M, W1) masked table;
  * the PnP chain runs in the reference's order (a Python loop over the
    frames, static in the anchor `l`), each solve a damped GN
    (`ops.ransac._pnp_gn_refine`) over every triangulated point;
  * triangulation is a batched two-view DLT (4×4 SVD per point);
  * the BA is a dense Gauss-Newton on one `torch.func.jacfwd` Jacobian
    over D = 6·W1 + 3·M perturbations, with the reference's gauge (frame
    l fixed, the last frame's translation fixed) applied to the residual's
    perturbation and to the step.  The iterations run with no read-back:
    `solve_ex` checks nothing on the host, and a non-finite step is
    dropped on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lmono_tpu_torch.estimator.factors import jacobian
from lmono_tpu_torch.ops.ransac import _pnp_gn_refine
from lmono_tpu_torch.utils.lie import Pose, quat_mul, quat_normalize, quat_to_mat, so3_exp_quat


class SfmResult(NamedTuple):
    poses: Pose              # (W1,) world-from-camera (world = frame l)
    points: torch.Tensor     # (M, 3) world
    point_ok: torch.Tensor   # (M,)
    ok: torch.Tensor         # () bool — enough PnP/triangulation support


def _triangulate_two(pose_i: Pose, pose_j: Pose, xi: torch.Tensor,
                     xj: torch.Tensor):
    """Two-view DLT triangulation of every point (`GlobalSFM::
    triangulatePoint`'s 4-row DLT).

    pose_*: world-from-camera, one pose or one per point; xi/xj: (M,2)
    normalized image coordinates.  Returns (X (M,3) world, depth_i,
    depth_j)."""
    Pi, Pj = pose_i.inverse(), pose_j.inverse()
    Ri, ti = quat_to_mat(Pi.q), Pi.t
    Rj, tj = quat_to_mat(Pj.q), Pj.t
    Mi = torch.cat([Ri, ti[..., :, None]], dim=-1)        # (..., 3, 4)
    Mj = torch.cat([Rj, tj[..., :, None]], dim=-1)
    A = torch.stack([
        xi[:, 0:1] * Mi[..., 2, :] - Mi[..., 0, :],
        xi[:, 1:2] * Mi[..., 2, :] - Mi[..., 1, :],
        xj[:, 0:1] * Mj[..., 2, :] - Mj[..., 0, :],
        xj[:, 1:2] * Mj[..., 2, :] - Mj[..., 1, :],
    ], dim=-2)                                            # (M, 4, 4)
    Xh = torch.linalg.svd(A).Vh[:, -1]
    w = Xh[:, 3:]
    X = Xh[:, :3] / torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    zi = (torch.einsum("...ij,...j->...i", Ri, X) + ti)[:, 2]
    zj = (torch.einsum("...ij,...j->...i", Rj, X) + tj)[:, 2]
    return X, zi, zj


def _pnp_all_inlier(X: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                    init: Pose) -> Pose:
    """Weighted GN PnP from an initial guess (`solveFrameByPnP`: the
    reference seeds cv::solvePnP with the neighbouring frame's pose);
    returns camera-from-world."""
    R0 = quat_to_mat(init.q)
    return _pnp_gn_refine(R0.T, -(R0.T @ init.t), X, x, w, iters=8)


def _gauge(dp: torch.Tensor, l: int) -> torch.Tensor:
    """dp (W1, 6) with frame l's perturbation and the last frame's
    translation held at zero (the reference's constant parameter blocks)."""
    W1 = dp.shape[0]
    free = torch.ones((W1, 6), dtype=torch.bool, device=dp.device)
    free[l] = False
    free[W1 - 1, 0:3] = False
    return torch.where(free, dp, torch.zeros_like(dp))


def _ba_residuals(delta: torch.Tensor, t0: torch.Tensor, q0: torch.Tensor,
                  X0: torch.Tensor, obs: torch.Tensor, w_obs: torch.Tensor,
                  l: int) -> torch.Tensor:
    """Weighted reprojection residuals (M·W1·2,) of the window retracted by
    `delta` (6 per pose, then 3 per point)."""
    W1, M = t0.shape[0], X0.shape[0]
    dp = _gauge(delta[: 6 * W1].reshape(W1, 6), l)
    dx = delta[6 * W1:].reshape(M, 3)
    t = t0 + dp[:, :3]
    q = quat_normalize(quat_mul(q0, so3_exp_quat(dp[:, 3:])))
    X = X0 + dx
    # camera-from-world per frame
    Rcw = quat_to_mat(q).transpose(-1, -2)                # (W1, 3, 3)
    tcw = -torch.einsum("wij,wj->wi", Rcw, t)
    Pc = torch.einsum("wij,mj->mwi", Rcw, X) + tcw[None]  # (M, W1, 3)
    z = Pc[..., 2]
    proj = Pc[..., :2] / torch.clamp(z, min=1e-3)[..., None]
    return ((proj - obs) * w_obs[..., None]).reshape(-1)


def global_sfm(obs: torch.Tensor, obs_mask: torch.Tensor, l: int,
               rel_pose: Pose, ba_iters: int = 8) -> SfmResult:
    """Reconstruct window poses + sparse points from tracks alone.

    obs: (M, W1, 2) normalized observations; obs_mask: (M, W1) validity;
    l: anchor frame index (the reference's parallax-chosen frame);
    rel_pose: pose of frame l in the last frame's camera (cam_last-from-
    cam_l, the reference's `relative_R/relative_T`).  Returns world-from-
    camera poses with world = camera l.  Runs on `obs`'s device.
    """
    M, W1, _ = obs.shape
    dev, dt = obs.device, obs.dtype

    # ---- initial two frames: l at identity, last from the relative pose
    pose_l = Pose.identity(dtype=dt, device=dev)
    pose_last = rel_pose.inverse()     # world(=l)-from-cam_last
    poses = [None] * W1
    poses[l] = pose_l
    poses[W1 - 1] = pose_last

    pts = torch.zeros((M, 3), dtype=dt, device=dev)
    ok = torch.zeros((M,), dtype=torch.bool, device=dev)

    def tri_merge(pts, ok, pa: Pose, pb: Pose, ia: int, ib: int):
        seen = obs_mask[:, ia] & obs_mask[:, ib]
        X, za, zb = _triangulate_two(pa, pb, obs[:, ia], obs[:, ib])
        good = seen & (za > 0.1) & (zb > 0.1) & torch.all(torch.isfinite(X), -1)
        new = good & ~ok
        return torch.where(new[:, None], X, pts), ok | new

    pts, ok = tri_merge(pts, ok, pose_l, pose_last, l, W1 - 1)

    # forward chain l+1 … W1-2: PnP against the current cloud, then
    # triangulate with the last frame (SFM.cc construct step 1)
    for i in range(l + 1, W1 - 1):
        w = (ok & obs_mask[:, i]).to(dt)
        poses[i] = _pnp_all_inlier(pts, obs[:, i], w, poses[i - 1]).inverse()
        pts, ok = tri_merge(pts, ok, poses[i], pose_last, i, W1 - 1)

    # step 2: triangulate between l and each of those frames (tracks that
    # do not reach the last frame)
    for i in range(l + 1, W1 - 1):
        pts, ok = tri_merge(pts, ok, pose_l, poses[i], l, i)

    # step 3: backward chain l-1 … 0: PnP, triangulate with l
    for i in range(l - 1, -1, -1):
        w = (ok & obs_mask[:, i]).to(dt)
        poses[i] = _pnp_all_inlier(pts, obs[:, i], w, poses[i + 1]).inverse()
        pts, ok = tri_merge(pts, ok, poses[i], pose_l, i, l)

    # step 4: every track seen by two solved frames, from its first and last
    # observation (the reference's begin/end)
    m8 = obs_mask.to(torch.uint8)
    first_idx = torch.argmax(m8, dim=1)
    last_idx = W1 - 1 - torch.argmax(m8.flip(1), dim=1)
    t_all = torch.stack([p.t for p in poses])
    q_all = torch.stack([p.q for p in poses])
    rows = torch.arange(M, device=dev)
    Xr, za, zb = _triangulate_two(Pose(t_all[first_idx], q_all[first_idx]),
                                  Pose(t_all[last_idx], q_all[last_idx]),
                                  obs[rows, first_idx], obs[rows, last_idx])
    okr = ((first_idx != last_idx) & (za > 0.1) & (zb > 0.1)
           & torch.all(torch.isfinite(Xr), -1)
           & obs_mask[rows, first_idx] & obs_mask[rows, last_idx])
    new = okr & ~ok
    pts = torch.where(new[:, None], Xr, pts)
    ok = ok | new

    # ---- full BA (SFM.cc construct's Ceres block) on all poses and points
    D = 6 * W1 + 3 * M
    w_obs = (obs_mask & ok[:, None]).to(dt)
    zero = torch.zeros(D, dtype=dt, device=dev)
    t, q, X = t_all, q_all, pts
    for _ in range(ba_iters):
        consts = (t, q, X, obs, w_obs)
        r = _ba_residuals(zero, *consts, l)
        J = jacobian(lambda d, *c: _ba_residuals(d, *c, l), consts, zero)
        H = J.T @ J
        g = J.T @ r
        Hd = H + 1e-4 * torch.diag(1.0 + torch.diagonal(H))
        delta = -torch.linalg.solve_ex(Hd, g)[0]
        delta = torch.where(torch.all(torch.isfinite(delta)), delta,
                            torch.zeros_like(delta))
        dp = _gauge(delta[: 6 * W1].reshape(W1, 6), l)
        t = t + dp[:, :3]
        q = quat_normalize(quat_mul(q, so3_exp_quat(dp[:, 3:])))
        X = X + delta[6 * W1:].reshape(M, 3)

    result_ok = torch.sum(ok) >= max(10, M // 8)
    return SfmResult(poses=Pose(t, q), points=X, point_ok=ok, ok=result_ok)
