"""Fixed-shape sliding-window state for the LiDAR–monocular fusion estimator.

Port of `lmono_tpu/estimator/window.py`.  One NamedTuple of fixed-capacity
tensors holds:

* `W+1` pose slots (world-from-laser), slot `count-1` = newest frame;
* the camera-from-laser extrinsic T_CL as an optimized variable;
* a feature table of `max_tracks` slots × `W+1` per-frame normalized
  observations with masks, anchored inverse depths.

Frame convention: camera pose T_W_C(i) = T_W_L(i) ∘ T_CL⁻¹.

`count` stays a device tensor, because the factors mask by it; its value is
host-knowable (`min(frames seen, W+1)` after a frame enters), so the
estimator keeps a host copy and never reads this one back.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from lmono_tpu_torch.config import EstimatorConfig
from lmono_tpu_torch.utils.lie import Pose, quat_identity


class FeatureTable(NamedTuple):
    ids: torch.Tensor        # (M,) int32, -1 empty
    anchor: torch.Tensor     # (M,) int32 anchor frame slot (first obs)
    obs: torch.Tensor        # (M, W1, 2) normalized coords per window frame
    obs_mask: torch.Tensor   # (M, W1) bool
    inv_depth: torch.Tensor  # (M,) inverse depth in anchor camera frame
    depth_ok: torch.Tensor   # (M,) bool — triangulated / solvable
    alive: torch.Tensor      # (M,) bool — slot in use

    @staticmethod
    def empty(max_tracks: int, w1: int, device=None) -> "FeatureTable":
        return FeatureTable(
            ids=torch.full((max_tracks,), -1, dtype=torch.int32, device=device),
            anchor=torch.zeros((max_tracks,), dtype=torch.int32, device=device),
            obs=torch.zeros((max_tracks, w1, 2), device=device),
            obs_mask=torch.zeros((max_tracks, w1), dtype=torch.bool, device=device),
            inv_depth=torch.zeros((max_tracks,), device=device),
            depth_ok=torch.zeros((max_tracks,), dtype=torch.bool, device=device),
            alive=torch.zeros((max_tracks,), dtype=torch.bool, device=device),
        )


class MargPrior(NamedTuple):
    """Linearized prior from marginalization (first-estimate Jacobians).

    r(x) = r0 + J · (x ⊟ x0) over the stacked local coords of
    [poses 0..W, extrinsic] (dim D = 6*(W+1)+6).  Inactive rows are zero.
    """
    J: torch.Tensor         # (D, D)
    r0: torch.Tensor        # (D,)
    lin_t: torch.Tensor     # (W1, 3) linearization point
    lin_q: torch.Tensor     # (W1, 4)
    lin_ex_t: torch.Tensor  # (3,)
    lin_ex_q: torch.Tensor  # (4,)
    valid: torch.Tensor     # () bool

    @staticmethod
    def empty(w1: int, device=None) -> "MargPrior":
        D = 6 * w1 + 6
        return MargPrior(
            J=torch.zeros((D, D), device=device),
            r0=torch.zeros((D,), device=device),
            lin_t=torch.zeros((w1, 3), device=device),
            lin_q=quat_identity(device=device).repeat(w1, 1),
            lin_ex_t=torch.zeros((3,), device=device),
            lin_ex_q=quat_identity(device=device),
            valid=torch.zeros((), dtype=torch.bool, device=device),
        )


class WindowState(NamedTuple):
    t: torch.Tensor          # (W1, 3) window poses: world-from-laser
    q: torch.Tensor          # (W1, 4)
    lt: torch.Tensor         # (W1, 3) laser-odometry poses (odom frame)
    lq: torch.Tensor         # (W1, 4)
    ex_t: torch.Tensor       # (3,) extrinsic: camera-from-laser
    ex_q: torch.Tensor       # (4,)
    ex_ref_t: torch.Tensor   # (3,) prior target for the extrinsic
    ex_ref_q: torch.Tensor   # (4,)
    feats: FeatureTable
    prior: MargPrior
    count: torch.Tensor      # () int32 — frames currently in window (≤ W1)
    initialized: torch.Tensor  # () bool
    ex_refines: torch.Tensor   # () int32 — extrinsic refinement count

    @staticmethod
    def init(cfg: EstimatorConfig, T_CL: Pose | None = None,
             device=None) -> "WindowState":
        w1 = cfg.window_size + 1
        ident_q = quat_identity(device=device).repeat(w1, 1)
        if T_CL is None:
            ex_t = torch.zeros(3, device=device)
            ex_q = quat_identity(device=device)
        else:
            ex_t = T_CL.t.to(device=device, dtype=torch.float32)
            ex_q = T_CL.q.to(device=device, dtype=torch.float32)
        return WindowState(
            t=torch.zeros((w1, 3), device=device),
            q=ident_q,
            lt=torch.zeros((w1, 3), device=device),
            lq=ident_q.clone(),
            ex_t=ex_t, ex_q=ex_q,
            ex_ref_t=ex_t.clone(), ex_ref_q=ex_q.clone(),
            feats=FeatureTable.empty(cfg.max_tracks, w1, device),
            prior=MargPrior.empty(w1, device),
            count=torch.zeros((), dtype=torch.int32, device=device),
            initialized=torch.zeros((), dtype=torch.bool, device=device),
            ex_refines=torch.zeros((), dtype=torch.int32, device=device),
        )

    @property
    def w1(self) -> int:
        return self.t.shape[0]

    def pose(self, i) -> Pose:
        return Pose(self.t[i], self.q[i])

    def extrinsic(self) -> Pose:
        """T_CL: camera-from-laser."""
        return Pose(self.ex_t, self.ex_q)

    def cam_pose(self, i) -> Pose:
        """T_W_C(i) = T_W_L(i) ∘ T_CL⁻¹."""
        return self.pose(i).compose(self.extrinsic().inverse())


def tree_where(cond: torch.Tensor, a, b):
    """`torch.where(cond, a, b)` leaf by leaf over two NamedTuples of the same
    structure (nested NamedTuples included); cond is a () bool tensor."""
    if isinstance(a, torch.Tensor):
        return torch.where(cond, a, b)
    return type(a)(*(tree_where(cond, x, y) for x, y in zip(a, b)))


def consistency_check(w: WindowState) -> dict:
    """Camera-vs-laser relative-motion consistency over the window
    (reference `Estimator::check()`): per consecutive pair, the optimized
    relative motion against the laser-odometry one, as a rotation
    discrepancy (degrees) and a translation discrepancy (metres), masked to
    the occupied pairs, with their maxima."""
    a, b = Pose(w.t[:-1], w.q[:-1]), Pose(w.t[1:], w.q[1:])
    la, lb = Pose(w.lt[:-1], w.lq[:-1]), Pose(w.lt[1:], w.lq[1:])
    d = a.between(b).local(la.between(lb))                   # (W, 6)
    rot_deg = torch.linalg.vector_norm(d[:, 3:], dim=-1) * (180.0 / math.pi)
    trans_m = torch.linalg.vector_norm(d[:, :3], dim=-1)
    pair_valid = (torch.arange(w.w1 - 1, device=w.t.device)
                  < torch.clamp(w.count - 1, min=0))
    rot_deg = torch.where(pair_valid, rot_deg, 0.0)
    trans_m = torch.where(pair_valid, trans_m, 0.0)
    return {
        "rot_err_deg": rot_deg,
        "trans_err_m": trans_m,
        "max_rot_err_deg": torch.max(rot_deg),
        "max_trans_err_m": torch.max(trans_m),
    }
