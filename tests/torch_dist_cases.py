"""Rank programs for the port's mesh tests (`tests/test_torch_dist_*.py`,
`tests/test_torch_parallel.py`).

Each `*_suite(rank, world, ...)` runs on every rank of a gloo process
group spawned by `lmono_tpu_torch.parallel.launch.run_ranks` and returns
CPU tensors and numbers for the test to compare with the JAX package and
with the port's single-rank functions.  Spawned ranks import this module
afresh, so it imports neither JAX nor `lmono_tpu`, only the port.  A
suite's mesh spans every rank of its group; with one rank it runs the
single-rank reference.  A test file spawns each of its groups once, side
by side.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from lmono_tpu_torch.config import ParallelConfig, SystemConfig, synthetic_config
from lmono_tpu_torch.io import synthetic as syn
from lmono_tpu_torch.utils.lie import Pose

_BASE = synthetic_config()
_T_CL = syn.synthetic_T_CL()
# test_torch_system.py's small widths, the loop DB and graph sized to split
ENGINE_CFG = _BASE.replace(
    laser_to_camera=tuple(_T_CL.to_mat4().reshape(-1).tolist()),
    lidar=dataclasses.replace(_BASE.lidar, max_edge_features=256, max_planar_features=512,
                              map_edge_capacity=2048, map_planar_capacity=4096),
    camera=dataclasses.replace(_BASE.camera, width=256, height=128, fx=128.0, fy=128.0,
                               cx=128.0, cy=64.0),
    tracker=dataclasses.replace(_BASE.tracker, max_features=40, min_dist=16,
                                pyramid_levels=3, lk_patch=15),
    estimator=dataclasses.replace(_BASE.estimator, window_size=4, max_tracks=48),
    loop=dataclasses.replace(_BASE.loop, db_capacity=64, max_keypoints=96, window_points=40,
                             pnp_ransac_iters=32, kf_edge_points=128, kf_planar_points=256,
                             search_gap=3, search_time=0.9, skip_time=0.1, skip_dis=0.3,
                             min_brief_matches=10, refine_min_inliers=50, posegraph_iters=8),
    mapping=dataclasses.replace(_BASE.mapping, map_capacity=1 << 15))


def run_groups(groups: dict, timeout_s: float, meanwhile=None) -> dict:
    """{name: (fn, world, args)} → {name: the ranks' results}: each group
    spawned by `run_ranks` (its own process group), all side by side;
    `meanwhile()` runs in this thread while they do."""
    from lmono_tpu_torch.parallel.launch import run_ranks

    with ThreadPoolExecutor(len(groups)) as ex:
        futs = {name: ex.submit(run_ranks, fn, world, args, timeout_s)
                for name, (fn, world, args) in groups.items()}
        if meanwhile is not None:
            meanwhile()
        return {name: f.result() for name, f in futs.items()}


def several(rank: int, world: int, calls: dict) -> dict:
    """Several suites one after another on the same ranks:
    {name: (suite, args)} → {name: its result}."""
    return {name: fn(rank, world, *args) for name, (fn, args) in calls.items()}


def plain(tree):
    """A tree of NamedTuples (the JAX package's states, pulled to numpy) as
    nested `SimpleNamespace`s with the same field names, which a spawned
    rank unpickles without importing the package that defined them."""
    import types

    if hasattr(tree, "_fields"):
        return types.SimpleNamespace(**{k: plain(v) for k, v in tree._asdict().items()})
    if isinstance(tree, (tuple, list)):
        return type(tree)(plain(v) for v in tree)
    return tree


def on_mesh(cfg: SystemConfig, kf: int, map_: int) -> SystemConfig:
    return cfg.replace(parallel=ParallelConfig(kf_shards=kf, map_shards=map_))


def circuit_frames(cfg: SystemConfig, n: int, seed: int = 1) -> list:
    """n frames along the circuit from the port's simulator (CPU, one
    seed)."""
    traj = syn.circuit_trajectory(n)
    scene = syn.make_city_scene()
    g = torch.Generator().manual_seed(seed)
    frames = []
    for i in range(n):
        p = Pose(traj.t[i], traj.q[i])
        s = syn.simulate_lidar(scene, p, cfg.lidar, 0.01, generator=g)
        frames.append({**{k: s[k] for k in ("points", "ranges", "valid")},
                       "image": syn.render_camera(scene, p.compose(_T_CL.inverse()),
                                                  cfg.camera)})
    return frames


def _lanes_step(pipe):
    """A frame step that drives the fused step's three lanes one by one,
    through the mesh's per-lane steps (`make_dist_odometry_step`, the
    replicated tracker, `make_dist_fusion_step`), on `pipe`'s state and
    noise."""
    from lmono_tpu_torch.estimator.tracker import tracker_step
    from lmono_tpu_torch.fused import FusedState
    from lmono_tpu_torch.parallel.dist_engine import (make_dist_fusion_step,
                                                      make_dist_odometry_step)

    cfg = pipe.cfg
    odometry = make_dist_odometry_step(pipe.mesh, cfg.lidar)
    fusion = make_dist_fusion_step(pipe.mesh, cfg.estimator)

    def step(frame: dict) -> dict:
        g, rp = pipe.noise()
        n, s = pipe.frame, pipe.state
        odo, lo = odometry(s.odo, {k: frame[k] for k in ("points", "ranges", "valid")}, n)
        trk, track = tracker_step(s.trk, frame["image"], pipe.cam, cfg.tracker, g, n)
        est, out = fusion(s.est, track, lo["pose"], min(n, cfg.estimator.window_size), rp)
        pipe.state, pipe.frame = FusedState(odo, trk, est), n + 1
        return {"pose_t": out.pose.t, "is_keyframe": out.is_keyframe,
                "initialized": out.initialized}

    return step


def _fused_step(pipe):
    """A frame step through `dist_fused_step` on `pipe`'s state and noise."""
    from lmono_tpu_torch.parallel.dist_engine import dist_fused_step

    def step(frame: dict) -> dict:
        g, rp = pipe.noise()
        pipe.state, out = dist_fused_step(pipe.state, frame, pipe.cam, pipe.cfg,
                                          pipe.mesh, g, pipe.frame, rp)
        pipe.frame += 1
        return out

    return step


def pipeline_suite(rank: int, world: int, kf: int, map_: int, frames: list,
                   drive: str = "process") -> dict:
    """The fused pipeline over `frames` (`circuit_frames`): on one rank the
    single-rank `FusedPipeline`, else `DistributedFusedPipeline` on a
    (kf, map_) mesh of every rank, driven frame by frame through its
    `process`, through `dist_fused_step` ("dist_fused_step") or lane by
    lane ("lanes", `_lanes_step`).  Per-frame pose, keyframe and
    initialized flags, the odometry banks (gathered on a mesh) and the
    mesh's collective counts."""
    from lmono_tpu_torch.camera import camera_from_config
    from lmono_tpu_torch.fused import FusedPipeline
    from lmono_tpu_torch.parallel.dist_engine import DistributedFusedPipeline
    from lmono_tpu_torch.parallel.mesh import Mesh

    cfg = ENGINE_CFG
    cam = camera_from_config(cfg.camera)
    if world == 1:
        pipe = FusedPipeline(cfg, cam, _T_CL, device="cpu")
    else:
        pipe = DistributedFusedPipeline(on_mesh(cfg, kf, map_), cam, _T_CL,
                                        mesh=Mesh({"kf": kf, "map": map_}), device="cpu")
    step = (pipe.process if drive == "process" else
            {"dist_fused_step": _fused_step, "lanes": _lanes_step}[drive](pipe))
    outs = [step(fr) for fr in frames]
    state = pipe.state if pipe.mesh is None else pipe.global_state()
    return {"pose_t": torch.stack([o["pose_t"] for o in outs]),
            "is_keyframe": [bool(o["is_keyframe"]) for o in outs],
            "initialized": [bool(o["initialized"]) for o in outs],
            "edge_map": tuple(state.odo.edge_map),
            "plane_map": tuple(state.odo.plane_map),
            "stats": None if pipe.mesh is None else pipe.mesh.collective_stats()}


def system_suite(rank: int, world: int, kf: int, map_: int, frames: list,
                 ply: str) -> dict:
    """`SlamSystem.process` (loop and map on) over `frames`: on one rank the
    single-rank system, else on a (kf, map_) mesh of every rank.  Poses, keyframe flags, the DB count, loops, the odometry banks
    and the colored map (gathered on a mesh), and the point count of the
    PLY written to `ply` (by rank 0 on a mesh)."""
    from lmono_tpu_torch.parallel.dist_engine import odometry_specs
    from lmono_tpu_torch.parallel.mesh import Mesh, gather_sharded
    from lmono_tpu_torch.pipeline import SlamSystem

    cfg = ENGINE_CFG if world == 1 else on_mesh(ENGINE_CFG, kf, map_)
    system = SlamSystem(cfg, device="cpu", generator=torch.Generator().manual_seed(3),
                        mesh=None if world == 1 else Mesh({"kf": kf, "map": map_}))
    outs = [system.process({k: fr[k] for k in ("points", "ranges", "valid")},
                           fr["image"], time=i * 0.1) for i, fr in enumerate(frames)]
    odo = system.front.state.odo
    if system.mesh is not None:
        odo = gather_sharded(system.mesh, odo, odometry_specs())
    return {"pose_t": torch.stack([o["pose"].t for o in outs]),
            "is_keyframe": [o["is_keyframe"] for o in outs],
            "initialized": [o["initialized"] for o in outs],
            "db_count": system.loop.count, "n_loops": system.n_loops,
            "edge_map": tuple(odo.edge_map), "plane_map": tuple(odo.plane_map),
            "cmap": tuple(system.mapper._global_map()), "n_points": system.mapper.n_points,
            "ply_points": system.save_map(ply)}


# --------------------------------------------------------------------------
# tests/test_torch_parallel.py: the space axis's exact pieces, conversion
# --------------------------------------------------------------------------

def parallel_suite(rank: int, world: int, inp: dict) -> dict:
    """Four ranks on a 1-D "map" mesh: `sharded_knn`, the sharded voxel
    bank and colored-map updates (each rank's shard), and each rank's shard
    of a JAX fused state and keyframe DB under the port's spec trees."""
    from lmono_tpu_torch import convert
    from lmono_tpu_torch.mapping.builder import ColorMap, colormap_update_hash
    from lmono_tpu_torch.ops.voxelmap import PointBank, bank_update_hash
    from lmono_tpu_torch.parallel.dist_knn import sharded_knn
    from lmono_tpu_torch.parallel.mesh import Mesh, make_mesh

    mesh = make_mesh(world, axis="map")
    ax = mesh.axis("map")
    t = {k: torch.from_numpy(v) for k, v in inp["arrays"].items()}
    out = {}
    Mq = t["bank"].shape[0] // world
    sl = slice(rank * Mq, (rank + 1) * Mq)
    out["knn"] = sharded_knn(mesh, t["query"], t["bank"][sl], t["bank_mask"][sl], 5)
    C = inp["bank_capacity"] // world
    bank = PointBank.empty(C)
    for p in (t["pts1"], t["pts2"]):
        bank = bank_update_hash(bank, p, torch.ones(p.shape[0], dtype=torch.bool),
                                0.5, torch.zeros(3), 100.0, axis=ax)
    out["bank"] = tuple(bank)
    cm = colormap_update_hash(ColorMap.empty(inp["map_capacity"] // world),
                              t["cm_pts"], t["cm_cols"], t["cm_mask"], 0.3, axis=ax)
    out["cmap"] = tuple(cm)
    # conversion of JAX global states to this rank's part, on a (kf, map)
    # mesh of the same ranks (kf = world here)
    mesh_kf = Mesh({"kf": world, "map": 1})
    fused, frame = convert.fused_state_shard_from_numpy(inp["fused"], mesh_kf)
    out["fused_feats_ids"] = fused.est.window.feats.ids
    out["fused_edge_points"] = fused.odo.edge_map.points
    out["fused_frame"] = frame
    db, count = convert.keyframe_db_shard_from_numpy(inp["db"], mesh_kf)
    out["db_valid"], out["db_t"], out["db_count"] = db.valid, db.t, count
    # the odometry over the map axis (`make_dist_odometry_scan`), and on
    # one rank for reference
    from lmono_tpu_torch.lidar.odometry import OdometryState, odometry_scan
    from lmono_tpu_torch.parallel.dist_engine import (make_dist_odometry_scan,
                                                      make_dist_odometry_step,
                                                      odometry_specs)
    from lmono_tpu_torch.parallel.mesh import gather_sharded, put_sharded

    lid = ENGINE_CFG.lidar
    frames = circuit_frames(ENGINE_CFG, inp["odometry_frames"])
    scans = {k: torch.stack([f[k] for f in frames]) for k in ("points", "ranges", "valid")}
    mesh_map = Mesh({"kf": 1, "map": world})
    st, outs = make_dist_odometry_scan(mesh_map, lid)(
        put_sharded(mesh_map, OdometryState.init(lid), odometry_specs()), scans, 0)
    st = gather_sharded(mesh_map, st, odometry_specs())
    ref, ref_outs = odometry_scan(OdometryState.init(lid), scans, lid, 0)
    # the same frames one by one (`make_dist_odometry_step`)
    step = make_dist_odometry_step(mesh_map, lid)
    st1, ts = put_sharded(mesh_map, OdometryState.init(lid), odometry_specs()), []
    for n in range(len(frames)):
        st1, o = step(st1, {k: v[n] for k, v in scans.items()}, n)
        ts.append(o["pose"].t)
    st1 = gather_sharded(mesh_map, st1, odometry_specs())
    out["odometry"] = ((outs["pose"].t, tuple(st.edge_map), tuple(st.plane_map)),
                       (ref_outs["pose"].t, tuple(ref.edge_map), tuple(ref.plane_map)),
                       (torch.stack(ts), tuple(st1.edge_map), tuple(st1.plane_map)))
    return out


# --------------------------------------------------------------------------
# tests/test_torch_dist_window.py and test_torch_dist_posegraph.py
# --------------------------------------------------------------------------

def window_suite(rank: int, world: int, window, est_cfg: dict) -> dict:
    """`make_sharded_solve` on a "kf" mesh of all ranks, on the JAX window
    `window` (pulled to numpy), converted and cut to this rank's rows; the
    solved window gathered back.  Also the divisibility error."""
    from lmono_tpu_torch.config import EstimatorConfig
    from lmono_tpu_torch.convert import window_state_from_numpy
    from lmono_tpu_torch.parallel.dist_window import (make_sharded_solve,
                                                      window_gathered,
                                                      window_shardings)
    from lmono_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(world, axis="kf")
    cfg = EstimatorConfig(**est_cfg)
    w = window_shardings(mesh, window_state_from_numpy(window))
    out, diag = make_sharded_solve(mesh, cfg)(w)
    out = window_gathered(mesh, out)
    try:
        make_sharded_solve(mesh, EstimatorConfig(**{**est_cfg, "max_tracks": 50}))
        error = None
    except ValueError as e:
        error = str(e)
    return {"t": out.t, "q": out.q, "ex_t": out.ex_t, "ex_q": out.ex_q,
            "inv_depth": out.feats.inv_depth, "rows": w.feats.ids.shape[0],
            "iters": diag.iters, "cost0": float(diag.cost0),
            "cost1": float(diag.cost1), "error": error}


def step_suite(rank: int, world: int, inputs: tuple, lidar: dict, est: dict) -> dict:
    """`dist_ba.make_distributed_step` on a "kf" mesh of all ranks, on the
    global `inputs` (`dist_ba.demo_inputs`), this rank's part cut by
    `inputs_shardings`; the outputs made global (node and landmark rows
    gathered)."""
    from lmono_tpu_torch.config import EstimatorConfig, LidarConfig
    from lmono_tpu_torch.parallel.dist_ba import inputs_shardings, make_distributed_step
    from lmono_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(world, axis="kf")
    ax = mesh.axis("kf")
    step, _ = make_distributed_step(mesh, LidarConfig(**lidar), EstimatorConfig(**est))
    out = step(*inputs_shardings(mesh, inputs))
    return {**out, **{k: ax.all_gather(out[k], 0, tiled=True)
                      for k in ("graph_t", "graph_ypr", "win_inv_depth")}}


def posegraph_suite(rank: int, world: int, graph, iters: int, cg_iters: int) -> dict:
    """The node-sharded pose graph (4-DoF and 6-DoF) on a "kf" mesh of all
    ranks, on the JAX graph `graph` (pulled to numpy), converted and cut
    to this rank's nodes; the optimized positions gathered back."""
    from lmono_tpu_torch.convert import posegraph_shard_from_numpy
    from lmono_tpu_torch.parallel.dist_posegraph import (graph_gathered,
                                                         make_sharded_posegraph_opt)
    from lmono_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(world, axis="kf")
    g, _, _ = posegraph_shard_from_numpy(graph, mesh)
    out = {"nodes": g.t.shape[0]}
    for four_dof in (True, False):
        opt = make_sharded_posegraph_opt(mesh, iters=iters, cg_iters=cg_iters,
                                         four_dof=four_dof)
        res = graph_gathered(mesh, opt(g))
        out[four_dof] = (res.t, res.ypr)
    return out


# --------------------------------------------------------------------------
# tests/test_torch_dist_loop.py
# --------------------------------------------------------------------------

LOOP_H, LOOP_W, LOOP_KW = 128, 160, 32


def loop_config():
    from lmono_tpu_torch.config import LoopConfig

    return LoopConfig(db_capacity=64, max_keypoints=64, window_points=LOOP_KW,
                      search_gap=2, search_time=0.15, skip_time=0.0, skip_dis=0.0)


def loop_frames(n: int, seed: int = 0) -> list:
    """Structured random keyframes: three base images revisited, so that
    queries find real candidates (tests/test_dist_loop.py's frames)."""
    from lmono_tpu_torch.utils.lie import so3_exp_quat

    rng = np.random.RandomState(seed)
    base = [rng.rand(LOOP_H, LOOP_W).astype(np.float32) for _ in range(3)]
    out = []
    for i in range(n):
        uv = torch.from_numpy(rng.uniform([8, 8], [LOOP_W - 8, LOOP_H - 8],
                                          (LOOP_KW, 2)).astype(np.float32))
        norm = (uv - torch.tensor([LOOP_W / 2, LOOP_H / 2])) / 100.0
        pts = torch.cat([norm * 5.0, torch.full((LOOP_KW, 1), 5.0)], -1)
        mask = torch.from_numpy(rng.rand(LOOP_KW) > 0.2)
        pose = Pose(torch.tensor([0.1 * i, 0.0, 0.0]),
                    so3_exp_quat(torch.tensor([0.0, 0.0, 0.01 * i])))
        out.append((torch.from_numpy(base[i % 3]), uv, norm, pts, mask, pose, 0.1 * i))
    return out


def loop_suite(rank: int, world: int, n_frames: int) -> dict:
    """The loop detector over the keyframes of `loop_frames`: on one rank
    the local detector, else with its DB sharded over a "kf" mesh of every
    rank (`make_dist_process_fused`).  Its results, the collective counts
    and its DB (gathered on a mesh, `gather_db`)."""
    from lmono_tpu_torch.camera.models import pinhole_camera
    from lmono_tpu_torch.loop.detector import LoopDetector
    from lmono_tpu_torch.parallel.dist_loop import (gather_db, make_dist_process_fused,
                                                    put_db_sharded)
    from lmono_tpu_torch.parallel.mesh import make_mesh

    cfg = loop_config()
    cam = pinhole_camera(LOOP_W, LOOP_H, 100.0, 100.0, LOOP_W / 2, LOOP_H / 2)
    det = LoopDetector(cfg, (LOOP_H, LOOP_W), device="cpu")
    mesh = None
    if world > 1:
        mesh = make_mesh(world, axis="kf")
        det.db = put_db_sharded(mesh, det.db)
        det.detect_add = make_dist_process_fused(mesh, det, cfg)
    results = []
    for img, uv, norm, pts, mask, pose, t in loop_frames(n_frames):
        res = det.process_keyframe(img, cam, uv, norm, pts, mask, pose, t)
        results.append(None if res is None else tuple(res))
    return {"results": results, "count": det.count,
            "db": tuple(det.db if mesh is None else gather_db(mesh, det.db)),
            "stats": None if mesh is None else mesh.collective_stats()}
