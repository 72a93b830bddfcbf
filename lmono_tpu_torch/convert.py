"""Carry state and configuration over from the JAX package.

This system has no weights; what a run carries is the odometry state
(poses, the two voxel banks and the frame counter), the tracker state
(feature slots and the previous frame's pyramid) and the configuration.
Both arrive here as plain data (numpy arrays, JSON), so this module needs
neither JAX nor `lmono_tpu`.
"""

from __future__ import annotations

import numpy as np
import torch

from lmono_tpu_torch.config import SystemConfig
from lmono_tpu_torch.estimator.tracker import TrackerState
from lmono_tpu_torch.lidar.odometry import OdometryState
from lmono_tpu_torch.ops.voxelmap import PointBank
from lmono_tpu_torch.utils.lie import Pose


def _tensor(x, dtype, device) -> torch.Tensor:
    """A copy of array `x` (read-only views included) on `device`."""
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def odometry_state_from_numpy(tree, device=None) -> tuple[OdometryState, int]:
    """A `lmono_tpu.lidar.odometry.OdometryState` pulled to numpy (for
    example with `jax.device_get`) → (the port's state on `device`, its
    host frame counter).  `tree` needs only the reference's field names:
    pose/prev_pose (t, q), edge_map/plane_map (points, mask) and frame.
    """
    def dev(x, dtype):
        return _tensor(x, dtype, device)

    def pose(p):
        return Pose(dev(p.t, torch.float32), dev(p.q, torch.float32))

    def bank(b):
        return PointBank(dev(b.points, torch.float32), dev(b.mask, torch.bool))

    frame = int(np.asarray(tree.frame))
    state = OdometryState(
        pose=pose(tree.pose),
        prev_pose=pose(tree.prev_pose),
        edge_map=bank(tree.edge_map),
        plane_map=bank(tree.plane_map),
        frame=torch.tensor(frame, dtype=torch.int32, device=device),
    )
    return state, frame


def tracker_state_from_numpy(tree, device=None) -> tuple[TrackerState, int]:
    """A `lmono_tpu.estimator.tracker.TrackerState` pulled to numpy → (the
    port's state on `device`, its host frame counter).  `tree` needs only
    the reference's field names."""
    def dev(x, dtype):
        return _tensor(x, dtype, device)

    frame = int(np.asarray(tree.frame))
    state = TrackerState(
        uv=dev(tree.uv, torch.float32),
        norm=dev(tree.norm, torch.float32),
        ids=dev(tree.ids, torch.int32),
        track_cnt=dev(tree.track_cnt, torch.int32),
        alive=dev(tree.alive, torch.bool),
        next_id=dev(tree.next_id, torch.int32),
        pyramid=tuple(dev(p, torch.float32) for p in tree.pyramid),
        grads=tuple((dev(gx, torch.float32), dev(gy, torch.float32))
                    for gx, gy in tree.grads),
        frame=torch.tensor(frame, dtype=torch.int32, device=device),
    )
    return state, frame


def config_from_json(s: str) -> SystemConfig:
    """A configuration written by either package's `SystemConfig.to_json`."""
    return SystemConfig.from_json(s)
