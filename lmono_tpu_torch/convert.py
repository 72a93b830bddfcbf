"""Carry state and configuration over from the JAX package.

This system has no weights; what a run carries is the odometry state
(poses, the two voxel banks and the frame counter) and the configuration.
Both arrive here as plain data (numpy arrays, JSON), so this module needs
neither JAX nor `lmono_tpu`.
"""

from __future__ import annotations

import numpy as np
import torch

from lmono_tpu_torch.config import SystemConfig
from lmono_tpu_torch.lidar.odometry import OdometryState
from lmono_tpu_torch.ops.voxelmap import PointBank
from lmono_tpu_torch.utils.lie import Pose


def odometry_state_from_numpy(tree, device=None) -> tuple[OdometryState, int]:
    """A `lmono_tpu.lidar.odometry.OdometryState` pulled to numpy (for
    example with `jax.device_get`) → (the port's state on `device`, its
    host frame counter).  `tree` needs only the reference's field names:
    pose/prev_pose (t, q), edge_map/plane_map (points, mask) and frame.
    """
    def dev(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

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


def config_from_json(s: str) -> SystemConfig:
    """A configuration written by either package's `SystemConfig.to_json`."""
    return SystemConfig.from_json(s)
