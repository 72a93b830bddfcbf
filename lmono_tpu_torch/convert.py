"""Carry state and configuration over from the JAX package.

This system has no weights; what a run carries is the odometry state
(poses, the two voxel banks and the frame counter), the tracker state
(feature slots and the previous frame's pyramid), the estimator state (the
window, its feature table and prior, the hand-eye ring and the previous
frame's tracks and laser pose), the loop lane's keyframe DB, pose graph and
host gates, the dense map's active bank, and the configuration.
Both arrive here as plain data (numpy arrays, JSON), so this module needs
neither JAX nor `lmono_tpu`.

On a device mesh each rank holds its part of the state: the `*_shard_*`
functions convert a JAX global state and keep this rank's blocks under the
port's spec trees (`parallel/dist_engine.py`, `dist_loop.py`,
`dist_posegraph.py`): the odometry banks and the colored map split over
"map", the feature table, the keyframe DB and the pose-graph nodes over
"kf".
"""

from __future__ import annotations

import numpy as np
import torch

from lmono_tpu_torch.config import SystemConfig
from lmono_tpu_torch.estimator.estimator import EstimatorState
from lmono_tpu_torch.estimator.initializer import HandEyeState
from lmono_tpu_torch.estimator.tracker import TrackerState
from lmono_tpu_torch.estimator.window import FeatureTable, MargPrior, WindowState
from lmono_tpu_torch.fused import FusedState
from lmono_tpu_torch.lidar.odometry import OdometryState
from lmono_tpu_torch.loop.keyframe_db import KeyframeDB
from lmono_tpu_torch.loop.posegraph import PoseGraph
from lmono_tpu_torch.mapping.builder import ColorMap
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


def _fields(cls, tree, device, dtypes: dict):
    """cls(**{field: tensor}) from the same-named fields of `tree`, each
    as dtypes[field] (float32 by default)."""
    return cls(**{f: _tensor(getattr(tree, f), dtypes.get(f, torch.float32),
                             device) for f in cls._fields})


def window_state_from_numpy(w, device=None) -> WindowState:
    """A `lmono_tpu.estimator.window.WindowState` pulled to numpy → the
    port's on `device`."""
    i32, b = torch.int32, torch.bool
    return WindowState(
        **{f: _tensor(getattr(w, f), torch.float32, device)
           for f in ("t", "q", "lt", "lq", "ex_t", "ex_q", "ex_ref_t", "ex_ref_q")},
        feats=_fields(FeatureTable, w.feats, device, {
            "ids": i32, "anchor": i32, "obs_mask": b, "depth_ok": b, "alive": b}),
        prior=_fields(MargPrior, w.prior, device, {"valid": b}),
        count=_tensor(w.count, i32, device),
        initialized=_tensor(w.initialized, b, device),
        ex_refines=_tensor(w.ex_refines, i32, device))


def estimator_state_from_numpy(tree, device=None) -> tuple[EstimatorState, int]:
    """A `lmono_tpu.estimator.estimator.EstimatorState` pulled to numpy →
    (the port's state on `device`, the host copy of its window count).
    `tree` needs only the reference's field names."""
    i32, b = torch.int32, torch.bool
    window = window_state_from_numpy(tree.window, device)
    handeye = _fields(HandEyeState, tree.handeye, device, {
        "mask": b, "n": i32, "converged": b, "stable": i32})
    state = EstimatorState(
        window=window, handeye=handeye,
        prev_norm=_tensor(tree.prev_norm, torch.float32, device),
        prev_ids=_tensor(tree.prev_ids, i32, device),
        prev_alive=_tensor(tree.prev_alive, b, device),
        prev_laser_t=_tensor(tree.prev_laser_t, torch.float32, device),
        prev_laser_q=_tensor(tree.prev_laser_q, torch.float32, device))
    return state, int(np.asarray(tree.window.count))


def fused_state_from_numpy(tree, device=None) -> tuple[FusedState, int]:
    """A `lmono_tpu.fused.FusedState` pulled to numpy → (the port's state on
    `device`, its host frame number).  The reference's PRNG key is not
    carried: the port's noise comes from `FusedPipeline.generator`."""
    odo, frame = odometry_state_from_numpy(tree.odo, device)
    trk, trk_frame = tracker_state_from_numpy(tree.trk, device)
    est, _ = estimator_state_from_numpy(tree.est, device)
    if trk_frame != frame:
        raise ValueError(f"odometry frame {frame} != tracker frame {trk_frame}")
    return FusedState(odo, trk, est), frame


def keyframe_db_from_numpy(tree, device=None) -> tuple[KeyframeDB, int]:
    """A `lmono_tpu.loop.keyframe_db.KeyframeDB` pulled to numpy → (the
    port's DB on `device`, its host keyframe count)."""
    b, i32, u8 = torch.bool, torch.int32, torch.uint8
    db = _fields(KeyframeDB, tree, device, {
        "desc": u8, "win_desc": u8, "kp_mask": b, "win_mask": b, "seq": i32,
        "valid": b, "count": i32, "lidar_edge_mask": b, "lidar_planar_mask": b})
    return db, int(np.asarray(tree.count))


def posegraph_from_numpy(tree, device=None) -> tuple[PoseGraph, int, int]:
    """A `lmono_tpu.loop.posegraph.PoseGraph` pulled to numpy → (the port's
    graph on `device`, its host node and loop counts)."""
    b, i32, i64 = torch.bool, torch.int32, torch.int64
    g = _fields(PoseGraph, tree, device, {
        "node_mask": b, "seq_mask": b, "loop_i": i64, "loop_j": i64,
        "loop_mask": b, "n_nodes": i32, "n_loops": i32})
    return g, int(np.asarray(tree.n_nodes)), int(np.asarray(tree.n_loops))


def colormap_from_numpy(tree, device=None) -> ColorMap:
    """A `lmono_tpu.mapping.builder.ColorMap` pulled to numpy → the port's
    on `device`."""
    return _fields(ColorMap, tree, device, {"mask": torch.bool})


def loop_detector_from_numpy(det, ref, device=None) -> None:
    """Carry a `lmono_tpu.loop.LoopDetector`'s state `ref` (its DB pulled to
    numpy, its host gates) into the port's `det` on `device`."""
    det.db, det.count = keyframe_db_from_numpy(ref.db, device)
    det._last_time = ref._last_time
    det._last_pos = None if ref._last_pos is None else np.asarray(ref._last_pos)
    det._last_loop_time = ref._last_loop_time
    det._last_loop_pos = (None if ref._last_loop_pos is None
                          else np.asarray(ref._last_loop_pos))


def config_from_json(s: str) -> SystemConfig:
    """A configuration written by either package's `SystemConfig.to_json`."""
    return SystemConfig.from_json(s)


# --------------------------------------------------------------------------
# This rank's part on a device mesh
# --------------------------------------------------------------------------

def fused_state_shard_from_numpy(tree, mesh, device=None) -> tuple[FusedState, int]:
    """`fused_state_from_numpy`, cut to this rank's part under
    `dist_engine.fused_specs` (banks over "map", feature rows over "kf")."""
    from lmono_tpu_torch.parallel.dist_engine import fused_specs
    from lmono_tpu_torch.parallel.mesh import put_sharded

    state, frame = fused_state_from_numpy(tree, device)
    return put_sharded(mesh, state, fused_specs()), frame


def keyframe_db_shard_from_numpy(tree, mesh, device=None,
                                 axis: str = "kf") -> tuple[KeyframeDB, int]:
    """`keyframe_db_from_numpy`, this rank's DB slots over `axis`."""
    from lmono_tpu_torch.parallel.dist_loop import put_db_sharded

    db, count = keyframe_db_from_numpy(tree, device)
    return put_db_sharded(mesh, db, axis), count


def posegraph_shard_from_numpy(tree, mesh, device=None,
                               axis: str = "kf") -> tuple[PoseGraph, int, int]:
    """`posegraph_from_numpy`, this rank's node block over `axis` (loop
    edges replicated)."""
    from lmono_tpu_torch.parallel.dist_posegraph import graph_shardings

    g, n_nodes, n_loops = posegraph_from_numpy(tree, device)
    return graph_shardings(mesh, g, axis), n_nodes, n_loops


def colormap_shard_from_numpy(tree, mesh, device=None) -> ColorMap:
    """`colormap_from_numpy`, this rank's slot range over "map"."""
    from lmono_tpu_torch.parallel.mesh import shard_leading

    return shard_leading(mesh, colormap_from_numpy(tree, device), "map")
