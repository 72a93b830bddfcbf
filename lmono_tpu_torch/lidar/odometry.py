"""LiDAR odometry: direct scan-to-map registration with a rolling voxel map.

Port of `lmono_tpu/lidar/odometry.py`.  One step extracts edge/planar
features, predicts the pose with a constant-velocity model, registers the
scan against the map by damped Gauss-Newton, and inserts the features into
the voxel banks.  State is a NamedTuple of fixed-shape tensors.

The JAX package branches on its device frame counter inside the program
(`lax.cond`, `jnp.where(is_first, ...)`); here those branches are host
control flow on a frame number that the caller keeps as a Python int beside
the device counter, so a step never waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lmono_tpu_torch import default_device
from lmono_tpu_torch.config import LidarConfig
from lmono_tpu_torch.lidar.features import extract_features
from lmono_tpu_torch.lidar.registration import register
from lmono_tpu_torch.ops.voxelmap import PointBank, bank_update, bank_update_hash
from lmono_tpu_torch.utils.lie import Pose


class OdometryState(NamedTuple):
    pose: Pose             # map-from-sensor, current frame
    prev_pose: Pose        # map-from-sensor, previous frame
    edge_map: PointBank
    plane_map: PointBank
    frame: torch.Tensor    # int32 frame counter (device copy)

    @staticmethod
    def init(cfg: LidarConfig, device=None) -> "OdometryState":
        return OdometryState(
            pose=Pose.identity(device=device),
            prev_pose=Pose.identity(device=device),
            edge_map=PointBank.empty(cfg.map_edge_capacity, device=device),
            plane_map=PointBank.empty(cfg.map_planar_capacity, device=device),
            frame=torch.zeros((), dtype=torch.int32, device=device),
        )


def predict_pose(state: OdometryState) -> Pose:
    """Constant-velocity motion model: pose ∘ (prev⁻¹ ∘ pose)."""
    rel = state.prev_pose.between(state.pose)
    return state.pose.compose(rel)


def odometry_step(state: OdometryState, scan: dict, cfg: LidarConfig,
                  frame: int, axis=None) -> tuple[OdometryState, dict]:
    """Process one sweep dict {points (R,W,3), ranges (R,W), valid (R,W)}.

    frame: the host copy of `state.frame`.  Frame 0 registers against the
    empty map like every other frame (fixed work per frame) and keeps the
    prior pose.

    axis: a mesh `Axis` (the space axis, "map") over which the banks in
    `state` are shards of the global slot space; the scan and the poses
    are replicated.  Needs `map_update == "hash"`, whose slot ranges
    partition.  The shards, concatenated, and the trajectory equal the
    single-device run's.
    """
    if axis is not None and cfg.map_update != "hash":
        raise ValueError("sharded odometry requires map_update='hash'")
    feats = extract_features(scan["points"], scan["ranges"], scan["valid"], cfg)
    init_pose = predict_pose(state)

    refined, diag = register(
        init_pose,
        feats.edge_points, feats.edge_mask,
        feats.planar_points, feats.planar_mask,
        state.edge_map.points, state.edge_map.mask,
        state.plane_map.points, state.plane_map.mask,
        cfg, cfg.scan_to_map_iters, axis=axis,
    )
    # first frame: no map yet, keep the prior pose
    pose = init_pose if frame == 0 else refined

    # sub-rate mapping (A-LOAM's map thread runs below odometry rate); the
    # first frames always insert so registration has a map to anchor to
    if (cfg.map_update_every <= 1 or frame % cfg.map_update_every == 0
            or frame < 10):
        if cfg.map_update == "hash":
            upd = lambda *a: bank_update_hash(*a, axis=axis)
        else:
            upd = bank_update
        edge_map = upd(state.edge_map, pose.apply(feats.edge_points),
                       feats.edge_mask, cfg.map_voxel_size, pose.t,
                       cfg.map_keep_radius)
        plane_map = upd(state.plane_map, pose.apply(feats.planar_points),
                        feats.planar_mask, cfg.map_voxel_size * 2.0, pose.t,
                        cfg.map_keep_radius)
    else:
        edge_map, plane_map = state.edge_map, state.plane_map

    new_state = OdometryState(
        pose=pose,
        prev_pose=state.pose,
        edge_map=edge_map,
        plane_map=plane_map,
        frame=state.frame + 1,
    )
    out = {
        "pose": pose,
        "n_edge": torch.sum(feats.edge_mask),
        "n_planar": torch.sum(feats.planar_mask),
        "inliers": diag["inliers"][-1],
        "cost": diag["costs"][-1],
        # sensor-frame features, reused by the loop lane for LiDAR
        # refinement of loop edges
        "features": feats,
    }
    return new_state, out


def odometry_scan(state: OdometryState, scans: dict, cfg: LidarConfig,
                  frame: int, axis=None) -> tuple[OdometryState, dict]:
    """Roll the odometry over a chunk of sweeps with a leading frame axis,
    e.g. points (F, R, W, 3); `frame` is the host frame number of the
    first.  Returns (final state, stacked per-frame outputs without the
    feature arrays).  axis: as in `odometry_step`."""
    n = scans["points"].shape[0]
    outs = []
    for i in range(n):
        state, out = odometry_step(state, {k: v[i] for k, v in scans.items()},
                                   cfg, frame + i, axis)
        out.pop("features")
        outs.append(out)
    stacked = {k: torch.stack([o[k] for o in outs])
               for k in ("n_edge", "n_planar", "inliers", "cost")}
    stacked["pose"] = Pose(torch.stack([o["pose"].t for o in outs]),
                           torch.stack([o["pose"].q for o in outs]))
    return state, stacked


class LidarOdometry:
    """Host-side runner holding the odometry state on one device.

    `process` runs one sweep per call; `process_chunk` runs a stacked
    (F, ...) batch of sweeps.  Sweeps may be numpy arrays or tensors; they
    are moved to `device`, the CUDA card unless another is named
    (`default_device`).  `frame` is the host frame counter.
    """

    def __init__(self, cfg: LidarConfig, device=None):
        self.cfg = cfg
        self.device = default_device(device)
        self.state = OdometryState.init(cfg, self.device)
        self.frame = 0

    def _to_device(self, scans: dict) -> dict:
        return {k: torch.as_tensor(scans[k], device=self.device)
                for k in ("points", "ranges", "valid")}

    def process(self, scan: dict) -> dict:
        self.state, out = odometry_step(self.state, self._to_device(scan),
                                        self.cfg, self.frame)
        self.frame += 1
        return out

    def process_chunk(self, scans: dict) -> dict:
        """scans: stacked sweeps with leading frame axis."""
        scans = self._to_device(scans)
        self.state, outs = odometry_scan(self.state, scans, self.cfg, self.frame)
        self.frame += scans["points"].shape[0]
        return outs
