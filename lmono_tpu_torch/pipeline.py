"""Full-system pipeline: LiDAR odometry → fusion → loop closure → dense map.

Port of `lmono_tpu/pipeline.py:SlamSystem` on one device, the CUDA card
unless another is named (`default_device`).  Two drive modes:

* `process(scan, image)`: one frame per call through `fused_step`; the
  loop lane runs at keyframe rate and its result is reaped on a later
  frame.
* `process_chunk(frames)`: the frame-rate dataflow (front, dense-map merge,
  loop-landmark extraction) runs as `fused.system_chunk` over the chunk;
  the keyframe-rate loop lane then runs on its per-frame outputs.

The pose-graph correction feeds back multiplicatively: poses are emitted as
T_corrected = drift_correction ∘ T_fused, from the frame after a reap
(interactive) or the next chunk (chunked).

Reads of device values are batched as the reference batches them: one per
frame in `process` (the keyframe and initialized flags and the track
count), one per chunk in `process_chunk` (the flags, the corrected camera
positions and the map's occupancy), one per reap (every pending detection)
and one more when a reap applied a loop (the count of rejected loop edges).
`readbacks` counts them.

`save_checkpoint` / `load_checkpoint` write and restore the whole state,
keyed by tree path (`utils/checkpoint.py`), including three things the
reference's checkpoint leaves out: the loop detector's noise source and its
skip gates, and the map's flushed archive.

With `ParallelConfig.kf_shards × map_shards > 1` the engine runs over a
(kf, map) mesh of ranks (`parallel/`), in SPMD form: the system is built
inside an initialized `torch.distributed` process group of kf × map
ranks (`python -m lmono_tpu_torch.run_multihost` spawns them; the
constructor raises without one), and every rank makes the same calls.
The odometry banks and the dense map are sharded over "map", the window's
feature table, the keyframe DB (kf > 1) and, past
DIST_POSEGRAPH_CROSSOVER nodes, the pose graph over "kf"; the rest runs
replicated with identically seeded noise.  `process_chunk` runs frame by
frame as on one device.  Checkpoints are not written on a mesh.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lmono_tpu_torch import default_device
from lmono_tpu_torch.camera import camera_from_config
from lmono_tpu_torch.config import SystemConfig
from lmono_tpu_torch.fused import FusedPipeline, system_chunk
from lmono_tpu_torch.io.sync import MeasurementSync
from lmono_tpu_torch.loop.detector import LoopDetector
from lmono_tpu_torch.loop.landmarks import subsample_features, window_landmarks
from lmono_tpu_torch.loop.posegraph import (PoseGraph, graph_add_loop,
                                            graph_add_node, graph_poses,
                                            optimize_posegraph)
from lmono_tpu_torch.mapping.builder import ColorMap, MapBuilder
from lmono_tpu_torch.utils.checkpoint import (CheckpointMismatch, load_extras,
                                              load_state, save_state)
from lmono_tpu_torch.utils.lie import (Pose, mat_to_quat, pose_stack,
                                       quat_rotate_inv, ypr_to_mat)
from lmono_tpu_torch.utils import timing
from lmono_tpu_torch.utils.timing import Tracer, read, span

_SCAN = ("points", "ranges", "valid")

# node count from which the mesh runs the kf-sharded pose-graph optimizer
# (the JAX package's measured crossover on its 8-device CPU mesh); smaller
# graphs are optimized replicated on every rank
DIST_POSEGRAPH_CROSSOVER = 16384


def drop_bad_loops(g: PoseGraph, gate_m: float) -> tuple[PoseGraph, torch.Tensor]:
    """Switch off loop edges that the optimized graph still contradicts by
    more than `gate_m` metres; returns (graph, count switched off)."""
    opt = graph_poses(g)
    dt_est = quat_rotate_inv(opt.q[g.loop_i], g.t[g.loop_j] - g.t[g.loop_i])
    err = torch.linalg.vector_norm(dt_est - g.loop_dt, dim=-1)
    bad = g.loop_mask & (err > gate_m)
    return g._replace(loop_mask=g.loop_mask & ~bad), torch.sum(bad)


def _to_host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


class SlamSystem:
    """End-to-end SLAM engine over (scan, image) frame streams."""

    # loop-edge weights relative to sequential odometry edges: closures whose
    # relative pose survived the LiDAR refinement are cm-grade and anchor
    # hard; PnP-only closures are dm-grade
    LOOP_W_REFINED = 5.0
    LOOP_W_PNP = 1.5
    # a reap switches off loop edges the optimum contradicts by this much
    DROP_BAD_GATE_M = 0.5

    def __init__(self, cfg: SystemConfig, enable_loop: bool = True,
                 enable_mapping: bool = True, device=None,
                 generator: torch.Generator | None = None, mesh=None,
                 trace: bool = False):
        """generator: the front's noise source (seed 7 on `device` when none
        is given); the loop detector draws from its own.  mesh: the (kf,
        map) engine mesh when kf_shards × map_shards > 1 (default: one over
        every rank of the process group).  trace: `tracer` records every
        frame's spans; without it a frame is traced only while a torch
        profiler records (and untraced, `process` reads no clock)."""
        pc = cfg.parallel
        self.mesh = None
        if pc.kf_shards * pc.map_shards > 1:
            from lmono_tpu_torch.parallel.dist_engine import (check_divisible,
                                                              make_engine_mesh)
            self.mesh = mesh or make_engine_mesh(pc.kf_shards, pc.map_shards)
            if self.mesh.shape != {"kf": pc.kf_shards, "map": pc.map_shards}:
                raise ValueError(f"mesh {self.mesh.shape} is not the configured "
                                 f"(kf={pc.kf_shards}, map={pc.map_shards})")
            check_divisible(cfg, pc.kf_shards, pc.map_shards, loop=enable_loop,
                            mapping=enable_mapping)
        self.cfg = cfg
        self.device = default_device(device)
        self.cam = camera_from_config(cfg.camera)
        T_CL = None
        if cfg.laser_to_camera is not None:
            m = np.array(cfg.laser_to_camera, np.float32).reshape(4, 4)
            T_CL = Pose.from_mat4(torch.tensor(m, device=self.device))
        if self.mesh is None:
            self.front = FusedPipeline(cfg, self.cam, T_CL, device=self.device,
                                       generator=generator)
        else:
            from lmono_tpu_torch.parallel.dist_engine import DistributedFusedPipeline
            self.front = DistributedFusedPipeline(
                cfg, self.cam, T_CL, mesh=self.mesh, device=self.device,
                generator=generator)
        self.loop: Optional[LoopDetector] = (
            LoopDetector(cfg.loop, (cfg.camera.height, cfg.camera.width),
                         lidar_cfg=cfg.lidar, device=self.device)
            if enable_loop else None)
        if self.loop is not None and self.mesh is not None and pc.kf_shards > 1:
            # the keyframe DB sharded over kf: scores and rows split by slot,
            # verification stays replicated
            from lmono_tpu_torch.parallel.dist_loop import (make_dist_process_fused,
                                                            put_db_sharded)
            self.loop.db = put_db_sharded(self.mesh, self.loop.db)
            self.loop.detect_add = make_dist_process_fused(self.mesh, self.loop,
                                                           cfg.loop)
        # the pose graph starts small and doubles on demand: a GN step costs
        # O((capacity·d)³) on one device (dense J and LU), O(capacity) per CG
        # step in the sharded optimizer, whatever the number of live nodes;
        # on a mesh every capacity is a multiple of kf_shards, so the nodes
        # split
        self._graph_cap = self._round_cap(min(512, cfg.loop.db_capacity))
        self.graph = (PoseGraph.empty(self._graph_cap, device=self.device)
                      if enable_loop else None)
        self._opt_sharded = None
        if self.mesh is not None and enable_loop:
            from lmono_tpu_torch.parallel.dist_posegraph import make_sharded_posegraph_opt
            self._opt_sharded = make_sharded_posegraph_opt(
                self.mesh, iters=cfg.loop.posegraph_iters, cg_iters=50,
                four_dof=cfg.loop.posegraph_4dof)
        self.mapper: Optional[MapBuilder] = (
            MapBuilder(self.cam, cfg.mapping, device=self.device, mesh=self.mesh)
            if enable_mapping else None)
        self.correction = Pose.identity(device=self.device)
        self.trace = trace
        self.tracer = Tracer()
        self.n_loops = 0
        self.readbacks = 0          # device reads of the system's own lanes
        self.reaps = 0              # reaps that fetched pending detections
        self.graph_solves = 0       # optimize_posegraph calls
        self.keyframes_processed = 0
        # history for the retro-corrected trajectory
        self._raw_poses: list = []      # fused laser pose per frame
        self._node_frames: list = []    # frame index of each pose-graph node
        self._node_raw_cam: list = []   # uncorrected cam pose per node
        self._n_nodes = 0
        self._pending: list = []        # dispatched, un-reaped detections
        # push-based stream front (MeasurementManager parity)
        self.sync = MeasurementSync(delay_time=cfg.estimator.delay_time)

    @property
    def frame_idx(self) -> int:
        return self.front.frame

    def _round_cap(self, n: int) -> int:
        """`n` rounded up to a multiple of kf_shards, capped at db_capacity
        (which the mesh check keeps divisible)."""
        ks = max(1, self.cfg.parallel.kf_shards)
        return min(-(-n // ks) * ks, self.cfg.loop.db_capacity)

    def _read(self, *values) -> np.ndarray:
        """One device→host read of several values (flattened to f32, whose
        integers are exact up to 2²⁴)."""
        self.readbacks += 1
        flat = torch.cat([torch.as_tensor(v).reshape(-1).to(torch.float32)
                          for v in values])
        return read(_to_host, flat)

    # ------------------------------------------------------------------
    # push-based streams: scans and images paired by timestamp
    def push_image(self, t: float, image) -> None:
        self.sync.push_image(t, image)

    def push_scan(self, t: float, scan: dict) -> None:
        """scan = {points, ranges, valid}."""
        self.sync.push_odometry(t, scan)

    def process_pending(self) -> list:
        """Pair the queued streams by timestamp and run `process` on each
        pair in time order.  Returns the per-frame output dicts."""
        return [self.process(scan, image, time=t_img)
                for t_img, image, scan in self.sync.get_measurements()]

    # ------------------------------------------------------------------
    def process(self, scan: dict, image, time: Optional[float] = None) -> dict:
        """One frame: scan = {points, ranges, valid}; image (H, W) in [0,1].
        `loop` reports detections applied this frame (they run at the
        keyframe and are reaped on a later frame)."""
        if not (self.trace or timing.profiling()):
            return self._process(scan, image, time)
        with timing.tracing(self.tracer, self.frame_idx, "frame"):
            return self._process(scan, image, time)

    def _process(self, scan: dict, image, time: Optional[float]) -> dict:
        idx = self.frame_idx
        time = idx * 0.1 if time is None else time
        applied = self._reap_loops()
        dev = self.device
        scan = {k: torch.as_tensor(scan[k], device=dev) for k in _SCAN}
        image = torch.as_tensor(image, device=dev)
        res = self.front.process({**scan, "image": image},
                                 with_features=self.loop is not None)
        fused = Pose(res["pose_t"], res["pose_q"])
        cam_pose = Pose(res["cam_t"], res["cam_q"])
        ex = Pose(res["ex_t"], res["ex_q"])
        self._raw_poses.append(fused)
        kf, init, n_tracked = self._read(res["is_keyframe"], res["initialized"],
                                         res["n_tracked"])
        kf_flag, init_flag = bool(kf), bool(init)

        if self.loop is not None and kf_flag and init_flag:
            with span("loop_lane"):
                self._loop_lane(scan, image, cam_pose, ex, time, res["features"], idx,
                                res.get("window_feats"))
        if self.mapper is not None and init_flag:
            with span("map"):
                self.mapper.process(scan["points"].reshape(-1, 3),
                                    scan["valid"].reshape(-1), image, ex,
                                    self.correction.compose(cam_pose))
        return {
            "pose": self.correction.compose(fused),
            "pose_raw": fused,
            "cam_pose": self.correction.compose(cam_pose),
            "extrinsic": ex,
            "is_keyframe": kf_flag,
            "initialized": init_flag,
            "loop": applied > 0,
            "n_tracked": int(n_tracked),
        }

    # ------------------------------------------------------------------
    def process_chunk(self, frames: dict, t0: Optional[float] = None,
                      dt: float = 0.1) -> dict:
        """Offline drive: frames {points, ranges, valid, image} with a
        leading (F,) axis run through `fused.system_chunk`, then the loop
        lane on each processed keyframe.  Returns the per-frame outputs
        (leading (F,) axis) and `loops_applied`."""
        if not (self.trace or timing.profiling()):
            return self._process_chunk(frames, t0, dt)
        with timing.tracing(self.tracer, self.frame_idx, "chunk"):
            return self._process_chunk(frames, t0, dt)

    def _process_chunk(self, frames: dict, t0: Optional[float], dt: float) -> dict:
        t0 = self.frame_idx * dt if t0 is None else t0
        applied = self._reap_loops()   # correction current before the chunk
        frames = {k: torch.as_tensor(v, device=self.device) for k, v in frames.items()}
        F = frames["points"].shape[0]
        cmap = self.mapper.map if self.mapper is not None \
            else ColorMap.empty(8, self.device)
        draws = [self.front.noise() for _ in range(F)]
        g = torch.stack([d[0] for d in draws])
        rp = torch.stack([d[1] for d in draws]) if draws[0][1] is not None else None
        self.front.state, cmap2, outs = system_chunk(
            self.front.state, cmap, frames, self.correction, self.cam,
            self.cfg, self.mapper is not None, self.loop is not None, g,
            self.frame_idx, rp, mesh=self.mesh)
        fill = outs.pop("map_fill")
        if self.mapper is not None:
            self.mapper.absorb_chunk(cmap2, F)
        self._raw_poses += [Pose(outs["pose_t"][i], outs["pose_q"][i]) for i in range(F)]
        if self.loop is not None:
            # one read covers the lane flags, the keyframe positions and the
            # map's occupancy
            host = self._read(outs["is_keyframe"], outs["initialized"],
                              outs["ccam_t"], fill)
            kf, init = host[:F] > 0.5, host[F:2 * F] > 0.5
            ccam_t = host[2 * F:5 * F].reshape(F, 3)
            if self.mapper is not None:
                self.mapper.flush_if_full(int(host[-1]))
            for i in range(F):
                if kf[i] and init[i]:
                    with span("loop_lane"):
                        self._loop_lane_chunk(outs, frames, i, t0 + i * dt,
                                              ccam_t[i], self.frame_idx + i)
        elif self.mapper is not None:
            self.mapper.flush_if_full(int(self._read(fill)[0]))
        self.front.frame += F
        outs["loops_applied"] = applied
        return outs

    # ------------------------------------------------------------------
    def _loop_lane(self, scan, image, cam_pose: Pose, extrinsic: Pose,
                   time: float, lidar_feats, frame_idx: int,
                   window_feats=None) -> None:
        """Keyframe lane of `process`: landmarks from the raw scan, detect
        and add, the result queued for a later reap.  window_feats: on a
        mesh, the whole feature table (`fused_step`'s `window_feats`)."""
        cfg = self.cfg
        w = self.front.state.est.window
        if window_feats is not None:
            w = w._replace(feats=window_feats)
        with span("loop_lane.landmarks"):
            lm = window_landmarks(w, self.cam, cfg.mapping,
                                  cfg.loop.window_points, scan_points=scan["points"],
                                  scan_valid=scan["valid"])
            corr_pose = self.correction.compose(cam_pose)
            lidar = (*subsample_features(lidar_feats.edge_points, lidar_feats.edge_mask,
                                         cfg.loop.kf_edge_points),
                     *subsample_features(lidar_feats.planar_points,
                                         lidar_feats.planar_mask,
                                         cfg.loop.kf_planar_points))
        pos = self._read(corr_pose.t)
        with span("loop_lane.detect"):
            res = self.loop.process_keyframe(
                image, self.cam, lm.uv, lm.norm, self.correction.apply(lm.pts_w),
                lm.sel, corr_pose, time, win_pnp_mask=lm.sel_pnp, lidar_features=lidar,
                extrinsic=extrinsic, defer_note=True, pos=pos)
        if res is not None:
            self._add_node(corr_pose, cam_pose, res, time, pos, frame_idx)

    def _loop_lane_chunk(self, outs, frames, i: int, time: float, pos,
                         frame_idx: int) -> None:
        """Keyframe lane fed by `system_chunk`'s outputs for frame i."""
        corr_pose = Pose(outs["ccam_t"][i], outs["ccam_q"][i])
        with span("loop_lane.detect"):
            res = self.loop.process_keyframe(
                frames["image"][i], self.cam, outs["lm_uv"][i], outs["lm_norm"][i],
                outs["lm_pts"][i], outs["lm_sel"][i], corr_pose, time,
                win_pnp_mask=outs["lm_pnp"][i],
                lidar_features=tuple(outs[k][i] for k in (
                    "loop_edge", "loop_edge_mask", "loop_planar", "loop_planar_mask")),
                extrinsic=Pose(outs["ex_t"][i], outs["ex_q"][i]),
                defer_note=True, pos=pos)
        if res is not None:
            self._add_node(corr_pose, Pose(outs["cam_t"][i], outs["cam_q"][i]),
                           res, time, pos, frame_idx)

    def _add_node(self, corr_pose: Pose, raw_cam: Pose, res, time: float, pos,
                  frame_idx: int) -> None:
        """Every processed keyframe becomes a pose-graph node; its detection
        result is queued for the next reap."""
        self.keyframes_processed += 1
        node_idx = self._n_nodes
        self._n_nodes += 1
        if (self._n_nodes >= self._graph_cap - 2
                and self._graph_cap < self.cfg.loop.db_capacity):
            self._grow_graph()
        graph_add_node(self.graph, corr_pose, node_idx)
        self._node_frames.append(frame_idx)
        # the uncorrected camera pose: final_trajectory maps raw → optimized
        # world per segment through it
        self._node_raw_cam.append(raw_cam)
        self._pending.append({"res": res, "node_idx": node_idx, "pos": pos,
                              "time": time})

    def _grow_graph(self) -> None:
        """Double the pose-graph node capacity (log2(total/512) times over a
        run)."""
        self._graph_cap = self._round_cap(self._graph_cap * 2)
        self.graph = self.graph.grown(self._graph_cap)

    # ------------------------------------------------------------------
    def _reap_loops(self) -> int:
        """Collect the pending detections in one read, add their loop edges
        under the SKIP_LOOP_* gates in time order, optimize once, switch off
        contradicted edges, and re-anchor the drift correction at the newest
        node.  Returns the number of loops applied."""
        if not self._pending:
            return 0
        with span("reap"):
            self.reaps += 1
            with span("reap.read"):
                rows = self._read(*[torch.cat([p["res"].found.reshape(1).float(),
                                               p["res"].old_seq.reshape(1).float(),
                                               p["res"].rel_t, p["res"].rel_q,
                                               p["res"].refined.reshape(1).float()])
                                    for p in self._pending]).reshape(len(self._pending), 10)
            skip_t, skip_d = self.cfg.loop.skip_loop_time, self.cfg.loop.skip_loop_dis
            applied = 0
            for p, row in zip(self._pending, rows):
                if row[0] < 0.5:
                    continue
                pos = p["pos"]
                if p["time"] - self.loop._last_loop_time < skip_t:
                    continue
                if (self.loop._last_loop_pos is not None and skip_d > 0
                        and np.linalg.norm(pos - self.loop._last_loop_pos) < skip_d):
                    continue
                self.loop.note_loop(p["time"], pos)
                rel = Pose(torch.tensor(row[2:5], device=self.device),
                           torch.tensor(row[5:9], device=self.device))
                graph_add_loop(self.graph, int(row[1]), p["node_idx"], rel, self.n_loops,
                               weight=self.LOOP_W_REFINED if row[9] > 0.5 else self.LOOP_W_PNP)
                self.n_loops += 1
                applied += 1
            self._pending = []
            if applied:
                self.graph = self._optimize(self.graph)
                # a loop edge the optimum still contradicts by > 0.5 m is a
                # verification false-accept: it stops pulling
                self.graph, n_bad = drop_bad_loops(self.graph, self.DROP_BAD_GATE_M)
                if self._read(n_bad)[0] > 0:
                    self.graph = self._optimize(self.graph)
                last = self._n_nodes - 1
                opt = Pose(self.graph.t[last], mat_to_quat(ypr_to_mat(self.graph.ypr[last])))
                # correction = optimized world from the raw estimator world at
                # the newest node
                self.correction = opt.compose(self._node_raw_cam[last].inverse())
            return applied

    def _optimize(self, g: PoseGraph) -> PoseGraph:
        """On a mesh, graphs of DIST_POSEGRAPH_CROSSOVER nodes and more run
        the kf-sharded optimizer (sharded for the solve, gathered back);
        smaller ones the single-device optimizer on every rank alike."""
        self.graph_solves += 1
        with span("pose_graph.solve"):
            if self._opt_sharded is not None and g.t.shape[0] >= DIST_POSEGRAPH_CROSSOVER:
                from lmono_tpu_torch.parallel.dist_posegraph import (graph_gathered,
                                                                     graph_shardings)
                return graph_gathered(self.mesh, self._opt_sharded(
                    graph_shardings(self.mesh, g)))
            return optimize_posegraph(g, iters=self.cfg.loop.posegraph_iters,
                                      four_dof=self.cfg.loop.posegraph_4dof)

    # ------------------------------------------------------------------
    def final_trajectory(self) -> Pose:
        """The retro-corrected trajectory (laser frame, one pose per frame):
        each frame re-anchored through its most recent keyframe node's
        optimized pose."""
        self._reap_loops()
        if self.graph is None or not self._node_frames:
            return pose_stack(self._raw_poses)
        opt = graph_poses(self.graph)
        out = []
        node = 0
        cur_fix = Pose.identity(device=self.device)
        for i, raw in enumerate(self._raw_poses):
            while node < len(self._node_frames) and self._node_frames[node] <= i:
                cur_fix = Pose(opt.t[node], opt.q[node]).compose(
                    self._node_raw_cam[node].inverse())
                node += 1
            out.append(cur_fix.compose(raw))
        return pose_stack(out)

    def save_map(self, path: str) -> int:
        """Write the PLY (on a mesh every rank gathers, rank 0 writes);
        returns the point count."""
        if self.mapper is None:
            return 0
        return self.mapper.save_ply(path, write=self.mesh is None or self.mesh.rank == 0)

    def _no_mesh(self, what: str) -> None:
        if self.mesh is not None:
            raise RuntimeError(f"{what} on a device mesh is not supported")

    # ------------------------------------------------------------------
    _COUNTERS = ("n_loops", "_n_nodes", "readbacks", "reaps", "graph_solves",
                 "keyframes_processed")

    def _checkpoint_tree(self) -> dict:
        """The system's fixed-shape state as a tree: the front (fused state,
        frame counter, noise source), the drift correction and counters,
        and, where enabled, the loop detector (DB, noise source, keyframe
        count, skip-gate times), the pose graph and the map (active bank,
        frame count, archived count, the occupancy queued by its last
        check, -1 for none)."""
        tree = {"front": self.front.state, "correction": self.correction,
                "count": {"frame": self.front.frame,
                          **{k.lstrip("_"): getattr(self, k) for k in self._COUNTERS}},
                "rng": {"front": self.front.generator.get_state()}}
        if self.loop is not None:
            tree["loop"] = {"db": self.loop.db, "count": self.loop.count,
                            "last_time": self.loop._last_time,
                            "last_loop_time": self.loop._last_loop_time}
            tree["rng"]["loop"] = self.loop.generator.get_state()
            tree["graph"] = self.graph
        if self.mapper is not None:
            m = self.mapper
            occ = -1
            if m._occ is not None:
                host, event = m._occ
                if event is not None:
                    event.synchronize()
                occ = int(host)
            tree["map"] = {"bank": m.map, "frames": m.frames,
                           "archived_n": m._archived_n, "occupancy": occ}
        return tree

    def save_checkpoint(self, path: str) -> None:
        """Serialize the full state for resume and replay.  Pending
        detections are reaped first, so none is left in flight; the host
        histories (per-frame raw poses, per-node frames and raw camera
        poses), the skip gates' positions and the map's archive go in as
        variable-length extras."""
        self._no_mesh("save_checkpoint")
        self._reap_loops()
        extra = {}
        if self._raw_poses:
            raw = pose_stack(self._raw_poses)
            extra.update(raw_t=raw.t, raw_q=raw.q)
        if self._node_frames:
            cams = pose_stack(self._node_raw_cam)
            extra.update(node_frames=np.asarray(self._node_frames, np.int64),
                         node_raw_t=cams.t, node_raw_q=cams.q)
        if self.loop is not None:
            for k in ("last_pos", "last_loop_pos"):
                if getattr(self.loop, "_" + k) is not None:
                    extra["loop_" + k] = getattr(self.loop, "_" + k)
        if self.mapper is not None and self.mapper._archive:
            extra["map_archive_points"] = np.concatenate(
                [p for p, _ in self.mapper._archive])
            extra["map_archive_colors"] = np.concatenate(
                [c for _, c in self.mapper._archive])
        save_state(path, self._checkpoint_tree(), extra=extra)

    def load_checkpoint(self, path: str) -> None:
        """Restore a checkpoint into this system; detections pending here
        are dropped.  A saved pose graph larger than this system's is met
        by doubling the graph (up to `db_capacity`) when every mismatched
        path lies under `graph/`; any other mismatch raises
        `CheckpointMismatch` at once.  Noise-source states load only into
        a system on the same device type (the CPU and CUDA generators keep
        states of different sizes, listed under `rng/`)."""
        self._no_mesh("load_checkpoint")
        template = self._checkpoint_tree()
        while True:
            try:
                state = load_state(path, template)
                break
            except CheckpointMismatch as e:
                graph_only = all(p.startswith("graph/") for p, _, _ in e.paths)
                if (self.loop is None or not graph_only
                        or self._graph_cap >= self.cfg.loop.db_capacity):
                    raise
                self._grow_graph()
                template["graph"] = self.graph
        self.front.state = state["front"]
        self.front.frame = state["count"]["frame"]
        self.front.generator.set_state(state["rng"]["front"])
        self.correction = state["correction"]
        for k in self._COUNTERS:
            setattr(self, k, state["count"][k.lstrip("_")])
        self._pending = []
        extras = load_extras(path)
        dev = self.device

        def poses(t, q) -> list:
            t, q = torch.from_numpy(t).to(dev), torch.from_numpy(q).to(dev)
            return [Pose(t[i], q[i]) for i in range(t.shape[0])]

        self._raw_poses = (poses(extras["raw_t"], extras["raw_q"])
                           if "raw_t" in extras else [])
        self._node_frames = [int(f) for f in extras.get("node_frames", [])]
        self._node_raw_cam = (poses(extras["node_raw_t"], extras["node_raw_q"])
                              if self._node_frames else [])
        if self.loop is not None:
            lp = state["loop"]
            self.loop.db = lp["db"]
            self.loop.count = lp["count"]
            self.loop._last_time = lp["last_time"]
            self.loop._last_loop_time = lp["last_loop_time"]
            self.loop._last_pos = extras.get("loop_last_pos")
            self.loop._last_loop_pos = extras.get("loop_last_loop_pos")
            self.loop.generator.set_state(state["rng"]["loop"])
            self.graph = state["graph"]
            self._graph_cap = self.graph.t.shape[0]
        if self.mapper is not None:
            m, mp = self.mapper, state["map"]
            m.map = mp["bank"]
            m.frames = mp["frames"]
            m._archived_n = mp["archived_n"]
            m._occ = (None if mp["occupancy"] < 0
                      else (torch.tensor(mp["occupancy"]), None))
            m._archive = ([(extras["map_archive_points"],
                            extras["map_archive_colors"])]
                          if "map_archive_points" in extras else [])
