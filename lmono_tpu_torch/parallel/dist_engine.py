"""The live engine on the mesh: the distributed fused step and pipeline.

Port of `lmono_tpu/parallel/dist_engine.py`.  The engine's state is laid
over a 2-D (kf, map) mesh of ranks:

* kf (keyframe / landmark axis): the fusion window's feature-table rows
  (`fusion_step(axis=)`: the landmark-sharded LM with local Schur
  elimination of depths, or the gathered dense solve below
  DIST_WINDOW_CROSSOVER shards) and, in `SlamSystem`, the keyframe DB and
  the pose-graph nodes;
* map (space axis): the odometry's voxel banks (`odometry_step(axis=)`:
  slot-range hash updates, K1 on each rank's shard, gathered candidate
  merge) and the dense colored map (`colormap_update_hash(axis=)`).

Everything not worth communicating for (scan features, KLT tracking, the
GN on merged correspondences) runs replicated on every rank, with the same
noise drawn from identically seeded generators.  The sharded and the
single-device runs give the same trajectory: the bank and KNN path
exactly, the fusion path up to the reassociation of the kf-axis sums.

The JAX package expresses the layout with `PartitionSpec` trees over
global arrays; here a spec tree has an axis name or None at each leaf
(or subtree) and `parallel.mesh.put_sharded` cuts a global tree to this
rank's part under it.
"""

from __future__ import annotations

from lmono_tpu_torch.camera.base import CameraModel
from lmono_tpu_torch.config import SystemConfig
from lmono_tpu_torch.estimator.estimator import EstimatorState, fusion_step
from lmono_tpu_torch.fused import FusedPipeline, FusedState, fused_step
from lmono_tpu_torch.lidar.odometry import OdometryState, odometry_scan, odometry_step
from lmono_tpu_torch.ops.voxelmap import PointBank
from lmono_tpu_torch.parallel.dist_window import window_specs
from lmono_tpu_torch.parallel.mesh import (Mesh, gather_sharded, make_mesh_2d,
                                           put_sharded)
from lmono_tpu_torch.utils.lie import Pose

__all__ = ["make_engine_mesh", "odometry_specs", "estimator_specs",
           "fused_specs", "put_sharded", "gather_sharded", "check_divisible",
           "dist_fused_step", "DistributedFusedPipeline",
           "make_dist_odometry_step", "make_dist_odometry_scan",
           "make_dist_fusion_step"]


def make_engine_mesh(kf_shards: int, map_shards: int) -> Mesh:
    """The 2-D engine mesh: kf (landmark / keyframe axis) × map (space
    axis) over the ranks of the initialized process group, whose size must
    be kf_shards × map_shards."""
    return make_mesh_2d(kf_shards, map_shards)


# --------------------------------------------------------------------------
# Spec trees over the state (None: replicated; a name: the leading dim is
# sharded over that axis; a spec over a subtree covers all of it)
# --------------------------------------------------------------------------

def odometry_specs() -> OdometryState:
    """Map banks sharded over the space axis, poses replicated."""
    return OdometryState(pose=None, prev_pose=None,
                         edge_map=PointBank("map", "map"),
                         plane_map=PointBank("map", "map"), frame=None)


def estimator_specs() -> EstimatorState:
    """Feature-table rows sharded over kf, everything else replicated."""
    return EstimatorState(window=window_specs("kf"), handeye=None,
                          prev_norm=None, prev_ids=None, prev_alive=None,
                          prev_laser_t=None, prev_laser_q=None)


def fused_specs() -> FusedState:
    return FusedState(odo=odometry_specs(), trk=None, est=estimator_specs())


def check_divisible(cfg: SystemConfig, kf: int, map_: int,
                    loop: bool = True, mapping: bool = True) -> None:
    est, lid, mp = cfg.estimator, cfg.lidar, cfg.mapping
    bad = []
    if est.max_tracks % kf:
        bad.append(f"estimator.max_tracks={est.max_tracks} % kf={kf}")
    if lid.map_edge_capacity % map_ or lid.map_planar_capacity % map_:
        bad.append("lidar map bank capacities % map shards")
    if loop and cfg.loop.db_capacity % kf:
        bad.append(f"loop.db_capacity={cfg.loop.db_capacity} % kf={kf}")
    if mapping and mp.map_capacity % map_:
        bad.append(f"mapping.map_capacity={mp.map_capacity} % map={map_}")
    if bad:
        raise ValueError("shard-divisibility: " + "; ".join(bad))


# --------------------------------------------------------------------------
# The composed distributed step and its host runner
# --------------------------------------------------------------------------

def dist_fused_step(state: FusedState, frame: dict, cam: CameraModel,
                    cfg: SystemConfig, mesh: Mesh, gumbel, n: int,
                    rp_gumbel=None, with_features: bool = False
                    ) -> tuple[FusedState, dict]:
    """One frame through odometry → tracker → fusion on the (kf, map)
    mesh: `fused.fused_step` with this rank's part of the state under
    `fused_specs`."""
    return fused_step(state, frame, cam, cfg, gumbel, n, rp_gumbel,
                      with_features, mesh=mesh)


class DistributedFusedPipeline(FusedPipeline):
    """`fused.FusedPipeline` with the step laid over the engine mesh: the
    same host API (`process`, `process_chunk`); the state held between
    calls is this rank's part under `fused_specs`."""

    def __init__(self, cfg: SystemConfig, cam: CameraModel,
                 T_CL: Pose | None = None, mesh: Mesh | None = None,
                 device=None, generator=None):
        super().__init__(cfg, cam, T_CL, device=device, generator=generator)
        pc = cfg.parallel
        self.mesh = mesh or make_engine_mesh(pc.kf_shards, pc.map_shards)
        check_divisible(cfg, self.mesh.shape["kf"], self.mesh.shape["map"],
                        loop=False, mapping=False)
        self.state = put_sharded(self.mesh, self.state, fused_specs())

    def global_state(self) -> FusedState:
        """The whole state, the shards gathered (the same on every rank)."""
        return gather_sharded(self.mesh, self.state, fused_specs())


# --------------------------------------------------------------------------
# Per-lane steps for callers that drive the lanes one by one
# --------------------------------------------------------------------------

def make_dist_odometry_step(mesh: Mesh, cfg_lidar):
    """`odometry_step` with the banks on the map axis:
    f(state, scan, frame) -> (state, out)."""
    ax = mesh.axis("map")
    return lambda s, scan, frame: odometry_step(s, scan, cfg_lidar, frame, axis=ax)


def make_dist_odometry_scan(mesh: Mesh, cfg_lidar):
    """`odometry_scan` (a chunk) with the banks on the map axis:
    f(state, scans, frame) -> (state, stacked outputs)."""
    ax = mesh.axis("map")
    return lambda s, scans, frame: odometry_scan(s, scans, cfg_lidar, frame, axis=ax)


def make_dist_fusion_step(mesh: Mesh, cfg_est):
    """`fusion_step` with the feature table on the kf axis:
    f(state, track, laser, count, gumbel) -> (state, FusionOutput)."""
    ax = mesh.axis("kf")
    return lambda s, track, laser, count, gumbel=None: fusion_step(
        s, track, laser, cfg_est, count, gumbel, axis=ax)
