"""Window-landmark extraction for the loop lane.

Port of `lmono_tpu/loop/landmarks.py`.  Per keyframe the loop lane takes
the newest window frame's live features with metric 3D: the depth comes
from the LiDAR depth image (projected and completed) sampled at the feature
pixel, and from the triangulated inverse depth where the image has none.
`window_landmarks` either computes that depth image from the raw scan or
reuses the one the dense-map lane computed for the same frame.

The newest slot, `min(count−1, W)`, is taken with `index_select` on the
window's device count, so nothing is read back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lmono_tpu_torch.camera.base import CameraModel
from lmono_tpu_torch.config import MappingConfig
from lmono_tpu_torch.mapping.depth import complete_depth, project_cloud
from lmono_tpu_torch.ops.image import to_int32_xla
from lmono_tpu_torch.utils.lie import Pose, quat_mul, quat_normalize, quat_rotate


class WindowLandmarks(NamedTuple):
    pts_w: torch.Tensor    # (Kw, 3) world 3D (estimator frame, uncorrected)
    norm: torch.Tensor     # (Kw, 2) normalized-plane obs in the newest frame
    uv: torch.Tensor       # (Kw, 2) pixel coords
    sel: torch.Tensor      # (Kw,) descriptor-matchable
    sel_pnp: torch.Tensor  # (Kw,) has reliable 3D for PnP


def top_k_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest values, the lower index first among equal
    values (`lax.top_k`'s order), by a stable descending sort."""
    return torch.sort(score, descending=True, stable=True).indices[:k]


def window_landmarks(w, cam: CameraModel, cfg: MappingConfig, Kw: int,
                     scan_points=None, scan_valid=None,
                     depth=None, depth_mask=None) -> WindowLandmarks:
    """Newest-frame window landmarks for the loop lane.

    Pass either the raw scan (`scan_points`/`scan_valid`, sensor frame) or a
    camera-frame depth image (`depth`, `depth_mask`).  Returns
    fixed-capacity tensors of the best `Kw` landmarks.
    """
    W1 = w.t.shape[0]
    # a negative slot wraps, as JAX's indexing does
    slot = torch.remainder(torch.clamp(w.count.long() - 1, max=W1 - 1),
                           W1).reshape(1)
    feats = w.feats
    sel = feats.alive & feats.obs_mask.index_select(1, slot)[:, 0]
    norm = feats.obs.index_select(1, slot)[:, 0]
    uv = cam.undist_to_plane(norm)

    T_CL_ = Pose(w.ex_t, w.ex_q)
    cam_pose = Pose(w.t.index_select(0, slot)[0],
                    w.q.index_select(0, slot)[0]).compose(T_CL_.inverse())

    # --- LiDAR depth at feature pixels (nearest-valid sampling)
    if depth is None:
        pts_cam_scan = T_CL_.apply(scan_points.reshape(-1, 3))
        depth_img, dmask = project_cloud(
            pts_cam_scan, scan_valid.reshape(-1), cam,
            cfg.depth_min, cfg.depth_max)
        depth, depth_mask = complete_depth(depth_img, dmask, cfg)
    ui = torch.clamp(to_int32_xla(torch.round(uv[:, 0])), 0,
                     depth.shape[1] - 1).long()
    vi = torch.clamp(to_int32_xla(torch.round(uv[:, 1])), 0,
                     depth.shape[0] - 1).long()
    z_lidar = depth[vi, ui]
    has_lidar = (depth_mask[vi, ui] & (z_lidar > cfg.depth_min)
                 & (z_lidar < cfg.depth_max * 0.9))

    # --- fallback: triangulated inverse depth (features above the LiDAR's
    # vertical field of view)
    T_LC = T_CL_.inverse()
    cam_t = w.t + quat_rotate(w.q, T_LC.t.expand(W1, 3))
    cam_q = quat_normalize(quat_mul(w.q, T_LC.q))
    a = feats.anchor.long()
    n_a = torch.gather(feats.obs, 1, a[:, None, None].expand(-1, 1, 2))[:, 0]
    tri_depth = 1.0 / torch.clamp(feats.inv_depth, min=1e-4)
    p_ca = torch.cat([n_a, torch.ones_like(n_a[:, :1])], -1) * tri_depth[:, None]
    p_w_tri = quat_rotate(cam_q[a], p_ca) + cam_t[a]
    z_tri = cam_pose.apply_inv(p_w_tri)[..., 2]
    has_tri = feats.depth_ok & (z_tri > 0.5)

    ray = torch.cat([norm, torch.ones_like(norm[:, :1])], -1)
    z = torch.where(has_lidar, z_lidar, z_tri)
    pts_w = cam_pose.apply(ray * z[:, None])
    sel_pnp = sel & (has_lidar | has_tri)
    if Kw >= sel.shape[0]:
        return WindowLandmarks(pts_w[:Kw], norm[:Kw], uv[:Kw], sel[:Kw],
                               sel_pnp[:Kw])
    # keep the best Kw landmarks: rank by (selected, PnP-usable, track length)
    track_len = torch.sum(feats.obs_mask, dim=1).to(torch.float32)
    score = (sel.to(torch.float32) * 1e6 + sel_pnp.to(torch.float32) * 1e3
             + track_len)
    idx = top_k_indices(score, Kw)
    return WindowLandmarks(pts_w[idx], norm[idx], uv[idx], sel[idx],
                           sel_pnp[idx])


def subsample_features(x, m, cap: int):
    """Static-stride subsample of a masked feature bank to `cap` rows
    (loop-lane LiDAR feature budget)."""
    stride = max(1, x.shape[0] // cap)
    return x[::stride][:cap], m[::stride][:cap]
