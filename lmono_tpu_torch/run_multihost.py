"""The device-mesh engine across ranks: the sharded pose graph and the live
composed engine, each rank one process of a `torch.distributed` group.

Port of `examples/run_multihost.py`.  The parent spawns RANKS ranks once
(`parallel/launch.py:run_ranks`, gloo, a `file://` store), runs two
phases on them and checks them:

* "ba": the keyframe-sharded pose graph (`dist_posegraph`) on a 64-node
  drifted circuit over an 8-rank "kf" mesh, node blocks of 8, the loop
  edge from the last node to the first crossing every block; each rank
  holds its rows within max(0.05 · correction, 1 mm) of the single-rank
  `optimize_posegraph`, which it computes itself.
* "engine": the live composed engine (`dist_fused_step`: odometry with
  space-sharded voxel banks and K1 on each rank's shard, KLT tracking,
  landmark-sharded window fusion) on a (kf=4, map=2) mesh over FRAMES
  ray-cast frames at this script's widths; each rank holds its poses
  within 5 mm of the single-rank `FusedPipeline`, which rank 0 runs after
  the mesh run and broadcasts (eight copies side by side on one card
  would each run at an eighth of the pace).
  The per-frame collective bytes are printed: the analytic count of the
  window solve's psums and what the ranks put into each axis's
  collectives, counted by the mesh.

The ranks run on the CUDA card unless `--device cpu` is given; several
ranks share one card over gloo, which stands in for NCCL across cards: a
run checks the sharded program's semantics and its parity, it measures no
scaling.  Any rank's failure makes the parent exit non-zero.

Usage:
    python -m lmono_tpu_torch.run_multihost [--device cpu] [--phase ba|engine]
        [--timeout 900]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

RANKS = 8                     # the ba's "kf" mesh and the engine's (4, 2)
BA_NODES_PER_RANK = 8
BA_ITERS, BA_CG_ITERS = 4, 24
ENGINE_KF, ENGINE_MAP = 4, 2
FRAMES = 14
ENGINE_GAP_M = 5e-3


def _device(name: str) -> torch.device:
    return torch.device("cuda", 0) if name == "cuda" else torch.device(name)


def ba_rank(rank: int, world: int, device: str) -> dict:
    """One rank of the "ba" phase."""
    from lmono_tpu_torch.loop.posegraph import optimize_posegraph
    from lmono_tpu_torch.parallel.dist_ba import demo_graph
    from lmono_tpu_torch.parallel.dist_posegraph import (graph_shardings,
                                                         make_sharded_posegraph_opt)
    from lmono_tpu_torch.parallel.mesh import make_mesh

    dev = _device(device)
    mesh = make_mesh(world, axis="kf")
    g = demo_graph(world, BA_NODES_PER_RANK, device=dev)   # the same on every rank
    opt = make_sharded_posegraph_opt(mesh, iters=BA_ITERS, cg_iters=BA_CG_ITERS, axis="kf")
    t0 = time.perf_counter()
    out = opt(graph_shardings(mesh, g))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    ref = optimize_posegraph(g, iters=BA_ITERS, cg_iters=BA_CG_ITERS)
    lo = rank * BA_NODES_PER_RANK
    mine = ref.t[lo:lo + BA_NODES_PER_RANK]
    gap = float(torch.linalg.vector_norm(out.t - mine, dim=-1).max())
    corr = float(torch.linalg.vector_norm(g.t - ref.t, dim=-1).max())
    return {"gap_m": gap, "correction_m": corr, "seconds": seconds,
            "device": str(out.t.device), "stats": mesh.collective_stats()}


def engine_config():
    """This script's widths: a small engine whose banks and table split
    over (kf=4, map=2)."""
    from lmono_tpu_torch.config import (CameraConfig, EstimatorConfig, LidarConfig,
                                        SystemConfig, TrackerConfig)
    from lmono_tpu_torch.io.synthetic import synthetic_T_CL

    cfg = SystemConfig(
        lidar=LidarConfig(num_rings=32, horiz_res=512, max_range=60.0,
                          max_edge_features=256, max_planar_features=512,
                          map_edge_capacity=4096, map_planar_capacity=8192,
                          scan_to_map_iters=4),
        camera=CameraConfig(width=256, height=128, fx=128.0, fy=128.0, cx=128.0,
                            cy=64.0),
        tracker=TrackerConfig(max_features=48, min_dist=12, pyramid_levels=2),
        estimator=EstimatorConfig(window_size=6, max_tracks=48, gn_iters=4))
    return cfg.replace(laser_to_camera=tuple(
        synthetic_T_CL().to_mat4().reshape(-1).tolist()))


def engine_frames(cfg, n: int, dev) -> list:
    """n frames ray-cast along the circuit, the same on every rank."""
    from lmono_tpu_torch.io import synthetic as syn
    from lmono_tpu_torch.utils.lie import Pose

    T_CL = syn.synthetic_T_CL(device=dev)
    scene = syn.make_city_scene(device=dev)
    traj = syn.circuit_trajectory(n, device=dev)
    g = torch.Generator(device=dev).manual_seed(50)
    frames = []
    for i in range(n):
        p = Pose(traj.t[i], traj.q[i])
        s = syn.simulate_lidar(scene, p, cfg.lidar, 0.01, generator=g)
        frames.append({**{k: s[k] for k in ("points", "ranges", "valid")},
                       "image": syn.render_camera(scene, p.compose(T_CL.inverse()),
                                                  cfg.camera)})
    return frames


def window_psum_bytes(cfg) -> tuple[int, int]:
    """Analytic bytes one rank puts into the kf axis's psums per LM attempt
    of the sharded window solve (`dist_window._local_lm_step`: the reduced
    system with its gradient, Schur terms and cost, then the step's two
    scalars, then the candidate's cost) and per marginalization (the
    reduced system and its gradient)."""
    P = 6 * (cfg.estimator.window_size + 1) + 6
    return (2 * P * P + 2 * P + 1 + 2 + 1) * 4, (P * P + P) * 4


def engine_rank(rank: int, world: int, device: str) -> dict:
    """One rank of the "engine" phase: `dist_fused_step` frame by frame on
    this rank's part of the state, with the single-rank pipeline's noise."""
    from lmono_tpu_torch.camera import camera_from_config
    from lmono_tpu_torch.config import ParallelConfig
    from lmono_tpu_torch.fused import FusedPipeline, FusedState
    from lmono_tpu_torch.io.synthetic import synthetic_T_CL
    from lmono_tpu_torch.ops import knn as knn_mod
    from lmono_tpu_torch.ops.cuda import knn as knn_cuda_mod
    from lmono_tpu_torch.ops.ransac import gumbel_noise
    from lmono_tpu_torch.parallel.dist_engine import (dist_fused_step, fused_specs,
                                                      make_engine_mesh)
    from lmono_tpu_torch.parallel.mesh import put_sharded

    dev = _device(device)
    cfg = engine_config()
    cam = camera_from_config(cfg.camera)
    T_CL = synthetic_T_CL(device=dev)
    mesh = make_engine_mesh(ENGINE_KF, ENGINE_MAP)
    frames = engine_frames(cfg, FRAMES, dev)
    mesh_cfg = cfg.replace(parallel=ParallelConfig(kf_shards=ENGINE_KF,
                                                   map_shards=ENGINE_MAP))
    state = put_sharded(mesh, FusedState.init(cfg, T_CL, dev), fused_specs())
    # FusedPipeline's default noise source (estimate_laser 1: no
    # relative-pose draws)
    gen = torch.Generator(device=dev).manual_seed(7)
    shape = (cfg.tracker.f_ransac_iters, 8, cfg.tracker.max_features)
    mesh.reset_stats()
    knn_launches = plain = 0
    seconds = 0.0
    poses = []
    for n, fr in enumerate(frames):
        k0, p0 = knn_cuda_mod.knn_kernel_launches, knn_mod.knn_plain_calls
        t0 = time.perf_counter()
        state, out = dist_fused_step(state, fr, cam, mesh_cfg, mesh,
                                     gumbel_noise(shape, gen, dev), n)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds += time.perf_counter() - t0
        knn_launches += knn_cuda_mod.knn_kernel_launches - k0
        plain += knn_mod.knn_plain_calls - p0
        poses.append(out["pose_t"])
    # the single-rank reference on rank 0, its poses and last initialized
    # flag broadcast to every rank
    ref = torch.zeros((FRAMES + 1, 3), device=dev)
    if rank == 0:
        fp = FusedPipeline(cfg, cam, T_CL, device=dev)
        outs = [fp.process(fr) for fr in frames]
        ref[:FRAMES] = torch.stack([o["pose_t"] for o in outs])
        ref[FRAMES, 0] = float(bool(outs[-1]["initialized"]))
    torch.distributed.broadcast(ref, 0)
    gap = float(torch.linalg.vector_norm(torch.stack(poses) - ref[:FRAMES], dim=-1).max())
    return {"gap_m": gap, "initialized": bool(out["initialized"]),
            "ref_initialized": bool(ref[FRAMES, 0] > 0.5),
            "device": str(out["pose_t"].device), "frames": FRAMES,
            "seconds": seconds, "knn_launches": knn_launches, "knn_plain_calls": plain,
            "stats": mesh.collective_stats(), "coords": mesh.coords,
            "shard_rows": {"edge_bank": state.odo.edge_map.points.shape[0],
                           "plane_bank": state.odo.plane_map.points.shape[0],
                           "feature_rows": state.est.window.feats.ids.shape[0]}}


def phases_rank(rank: int, world: int, device: str, phases: tuple) -> dict:
    """One rank: the phases in order on the same process group."""
    run = {"ba": ba_rank, "engine": engine_rank}
    return {p: run[p](rank, world, device) for p in phases}


def check_ba(results: list) -> None:
    for r, res in enumerate(results):
        gate = max(0.05 * res["correction_m"], 1e-3)
        print(f"[ba rank {r}] device={res['device']} gap={res['gap_m']:.3e} m "
              f"(correction {res['correction_m']:.3f} m, gate {gate:.3e} m) "
              f"seconds={res['seconds']:.3f}", flush=True)
        if not res["gap_m"] < gate:
            raise SystemExit(f"ba: rank {r} gap {res['gap_m']} m over {gate} m")


def check_engine(results: list, cfg) -> None:
    per_attempt, per_marg = window_psum_bytes(cfg)
    n = results[0]["frames"]
    for r, res in enumerate(results):
        st = res["stats"]
        print(f"[engine rank {r}] {res['coords']} device={res['device']} "
              f"gap={res['gap_m']:.3e} m knn_launches={res['knn_launches']} "
              f"knn_plain_calls={res['knn_plain_calls']} seconds={res['seconds']:.3f} "
              f"shard_rows={res['shard_rows']} per_frame_bytes="
              + json.dumps({a: {k: v[1] / n for k, v in s.items()} for a, s in st.items()}),
              flush=True)
        if not (res["initialized"] and res["ref_initialized"]):
            raise SystemExit(f"engine: rank {r} never initialized")
        if not res["gap_m"] < ENGINE_GAP_M:
            raise SystemExit(f"engine: rank {r} pose gap {res['gap_m']} m over "
                             f"{ENGINE_GAP_M} m")
    print(f"[engine] analytic kf-axis psums of the sharded window solve: "
          f"{per_attempt} B per LM attempt ({cfg.estimator.gn_iters} at most per "
          f"frame), {per_marg} B per marginalization", flush=True)


def main(argv=None) -> dict:
    """Returns {phase: [each rank's result]}."""
    from lmono_tpu_torch.parallel.launch import run_ranks

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--phase", default=None, choices=("ba", "engine"))
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds for the ranks, spawn to join")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run_multihost: no CUDA device (pass --device cpu)")
    phases = (args.phase,) if args.phase else ("ba", "engine")
    t0 = time.perf_counter()
    res = run_ranks(phases_rank, RANKS, (args.device, phases), timeout_s=args.timeout)
    out = {p: [r[p] for r in res] for p in phases}
    if "ba" in out:
        check_ba(out["ba"])
    if "engine" in out:
        check_engine(out["engine"], engine_config())
    print(f"run_multihost {', '.join(phases)}: {RANKS} ranks OK in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


if __name__ == "__main__":
    try:
        main()
    except SystemExit as e:
        if e.code not in (None, 0):
            print(e.code, file=sys.stderr)
            sys.exit(1)
        raise
