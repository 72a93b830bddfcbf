"""The combined distributed compute step over a mesh axis, and its inputs.

Port of `lmono_tpu/parallel/dist_ba.py`.  `make_distributed_step` lays
the engine's scale axes over the ranks of one axis with explicit
collectives:

* keyframe (time) axis: pose-graph GN + CG over node blocks
  (`dist_posegraph.make_sharded_posegraph_opt`);
* landmark axis: the window LM with local Schur elimination of depths and
  a psum'd pose system (`dist_window.make_sharded_solve`);
* map (space) axis: KNN over the sharded bank (`dist_knn.sharded_knn`,
  K1 on each rank's shard);
* data axis: feature extraction over this rank's block of a scan batch.

`demo_inputs` makes small structured global inputs for it, as the JAX
package's does: scans ray-cast from the synthetic city, a drifted circuit
graph with a loop edge across the node blocks, a perturbed window problem;
`inputs_shardings` cuts a rank's part.
"""

from __future__ import annotations

import math

import torch

from lmono_tpu_torch.config import EstimatorConfig, LidarConfig
from lmono_tpu_torch.estimator.window import FeatureTable, WindowState
from lmono_tpu_torch.lidar.features import extract_features
from lmono_tpu_torch.loop.posegraph import PoseGraph, graph_add_loop, graph_add_node
from lmono_tpu_torch.parallel.dist_knn import sharded_knn
from lmono_tpu_torch.parallel.dist_posegraph import (graph_shardings,
                                                     make_sharded_posegraph_opt)
from lmono_tpu_torch.parallel.dist_window import make_sharded_solve, window_shardings
from lmono_tpu_torch.parallel.mesh import Mesh
from lmono_tpu_torch.utils.lie import (Pose, mat_to_quat, quat_mul, quat_normalize,
                                       quat_rotate, quat_rotate_inv, so3_exp_quat,
                                       ypr_to_mat)

__all__ = ["make_distributed_step", "graph_shardings", "inputs_shardings",
           "demo_graph", "demo_window", "demo_inputs"]


def make_distributed_step(mesh: Mesh, lidar_cfg: LidarConfig,
                          est_cfg: EstimatorConfig | None = None,
                          axis: str = "kf", pg_iters: int = 4,
                          pg_cg_iters: int = 24):
    """The multi-rank step: f(graph, scan_points, scan_ranges, scan_valid,
    query, bank, bank_mask, window) -> dict, every argument this rank's
    part (`inputs_shardings`): the graph's node blocks, this rank's block
    of the scan batch, the replicated query, this rank's bank shard and
    the window's feature rows.  The feature counts come out summed over
    the whole batch, the graph and the depths as this rank's rows, the
    rest replicated.  Returns (step, est_cfg)."""
    est_cfg = est_cfg or EstimatorConfig(window_size=6, max_tracks=48, gn_iters=4)
    pg_opt = make_sharded_posegraph_opt(mesh, iters=pg_iters, cg_iters=pg_cg_iters,
                                        axis=axis)
    ax = mesh.axis(axis)
    win_solve = make_sharded_solve(mesh, est_cfg, axis=axis)

    def step(graph: PoseGraph, scan_points, scan_ranges, scan_valid,
             query, bank, bank_mask, window: WindowState) -> dict:
        # 1. feature extraction over this rank's scans
        feats = [extract_features(p, r, v, lidar_cfg)
                 for p, r, v in zip(scan_points, scan_ranges, scan_valid)]
        # 2. KNN over the sharded bank (K1 on this rank's shard)
        d2, idx = sharded_knn(mesh, query, bank, bank_mask, k=5, axis=axis)
        # 3. keyframe-sharded pose-graph GN + CG
        graph2 = pg_opt(graph)
        # 4. landmark-sharded window LM
        win2, diag = win_solve(window)
        return {
            "n_edge": ax.psum(sum(torch.sum(f.edge_mask) for f in feats)),
            "n_planar": ax.psum(sum(torch.sum(f.planar_mask) for f in feats)),
            "knn_d2": d2, "knn_idx": idx,
            "graph_t": graph2.t, "graph_ypr": graph2.ypr,
            "win_t": win2.t, "win_q": win2.q, "win_ex_t": win2.ex_t,
            "win_inv_depth": win2.feats.inv_depth,
            "win_cost1": diag.cost1, "win_iters": diag.iters,
        }

    return step, est_cfg


def demo_graph(n_devices: int, nodes_per_dev: int = 8, device=None) -> PoseGraph:
    """A drifted circuit of n_devices·nodes_per_dev nodes with a loop edge
    from the last node to the first, across the node blocks."""
    N = n_devices * nodes_per_dev
    theta = torch.linspace(0, 2 * math.pi, N, device=device)
    zero = torch.zeros(N, device=device)
    gt_t = torch.stack([12 * torch.cos(theta), 12 * torch.sin(theta), zero], -1)
    gt_ypr = torch.stack([theta + math.pi / 2, zero, zero], -1)
    gt = [Pose(gt_t[i], mat_to_quat(ypr_to_mat(gt_ypr[i]))) for i in range(N)]
    bias = Pose(torch.tensor([0.0, 0.01, 0.0], device=device),
                so3_exp_quat(torch.tensor([0.0, 0.0, 0.002], device=device)))
    g = PoseGraph.empty(N, 16, device=device)
    graph_add_node(g, gt[0], 0)
    cur = gt[0]
    for i in range(1, N):
        cur = cur.compose(gt[i - 1].between(gt[i]).compose(bias))
        graph_add_node(g, cur, i)
    graph_add_loop(g, 0, N - 1, gt[0].between(gt[N - 1]), 0)
    return g


def demo_window(cfg: EstimatorConfig, seed: int = 0, device=None) -> WindowState:
    """A perturbed window problem: a smooth trajectory, a landmark cloud
    with exact observations, poses and depths knocked off the truth."""
    from lmono_tpu_torch.io.synthetic import synthetic_T_CL

    g = torch.Generator().manual_seed(seed)
    W1, M = cfg.window_size + 1, cfg.max_tracks
    ts = torch.arange(W1, dtype=torch.float32)
    t = torch.stack([ts, 0.02 * ts ** 2, torch.zeros_like(ts)], -1)
    q = so3_exp_quat(torch.stack(
        [0.004 * ts + 0.002 * torch.sin(1.7 * ts),
         0.01 * ts - 0.004 * torch.cos(1.3 * ts),
         0.02 * ts + 0.006 * torch.sin(0.9 * ts)], -1))
    T_CL = synthetic_T_CL()
    lm = torch.cat([torch.rand((M, 1), generator=g) * 20.0 + 5.0,
                    torch.rand((M, 2), generator=g) * 16.0 - 8.0], -1)
    lm[:, 2] = lm[:, 2] * 0.3 + 1.0

    def project(ft, fq, pts):
        p_l = quat_rotate_inv(fq, pts - ft)
        p_c = quat_rotate(T_CL.q, p_l) + T_CL.t
        return p_c[:, :2] / p_c[:, 2:3], p_c[:, 2]

    obs, masks = zip(*(project(t[i], q[i], lm) for i in range(W1)))
    obs = torch.stack(obs, 1)
    obs_mask = torch.stack(masks, 1) > 1.0
    anchor = torch.argmax(obs_mask.to(torch.int32), dim=1)
    p_l = quat_rotate_inv(q[anchor], lm - t[anchor])
    inv_depth = 1.0 / (quat_rotate(T_CL.q[None], p_l) + T_CL.t[None])[:, 2]
    feats = FeatureTable(
        ids=torch.arange(M, dtype=torch.int32), anchor=anchor.to(torch.int32),
        obs=obs, obs_mask=obs_mask, inv_depth=inv_depth,
        depth_ok=torch.ones(M, dtype=torch.bool), alive=torch.ones(M, dtype=torch.bool))
    state = WindowState.init(cfg, T_CL)
    dp = 0.08 * torch.randn((W1, 3), generator=g)
    dth = 0.015 * torch.randn((W1, 3), generator=g)
    dp[0] = dth[0] = 0.0                     # the gauge frame stays
    state = state._replace(
        t=t + dp, q=quat_normalize(quat_mul(q, so3_exp_quat(dth))), lt=t, lq=q,
        feats=feats._replace(inv_depth=inv_depth * (
            1.0 + 0.15 * torch.randn(M, generator=g))),
        count=torch.tensor(W1, dtype=torch.int32),
        initialized=torch.ones((), dtype=torch.bool))
    return state if device is None else _to(state, torch.device(device))


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return type(tree)(*(_to(x, device) for x in tree))


def demo_inputs(n_devices: int, lidar_cfg: LidarConfig, est_cfg: EstimatorConfig,
                nodes_per_dev: int = 8, bank_per_dev: int = 256, device=None):
    """The global demo inputs of `make_distributed_step`, as the JAX
    package's `demo_inputs` lays them out: the drifted circuit graph, a
    batch of n_devices scans ray-cast from the synthetic city (ground
    plane and boxes: edge and planar features), the query, the bank (scan
    0's points tiled or cropped to (n_devices, bank_per_dev)) and the
    perturbed window.  `inputs_shardings` cuts a rank's part."""
    from lmono_tpu_torch.io.synthetic import (circuit_trajectory, make_city_scene,
                                              simulate_lidar)

    g = demo_graph(n_devices, nodes_per_dev, device)
    scene = make_city_scene(device=device)
    traj = circuit_trajectory(n_devices, device=device)
    gen = torch.Generator(device=device or "cpu").manual_seed(7)
    scans = [simulate_lidar(scene, Pose(traj.t[i], traj.q[i]), lidar_cfg, 0.005,
                            generator=gen) for i in range(n_devices)]
    pts, rng, valid = (torch.stack([s[k] for s in scans])
                       for k in ("points", "ranges", "valid"))
    flat, flat_ok = pts[0].reshape(-1, 3), valid[0].reshape(-1)
    M = n_devices * bank_per_dev
    reps = -(-M // flat.shape[0])
    bank = flat.repeat(reps, 1)[:M].reshape(n_devices, bank_per_dev, 3)
    bank_mask = flat_ok.repeat(reps)[:M].reshape(n_devices, bank_per_dev)
    query = flat[::7][:64] + 0.05
    return (g, pts, rng, valid, query, bank, bank_mask,
            demo_window(est_cfg, device=device))


def inputs_shardings(mesh: Mesh, inputs: tuple, axis: str = "kf") -> tuple:
    """This rank's part of `make_distributed_step`'s global inputs (as
    `demo_inputs` returns them): the graph's node blocks, its block of the
    scan batch, the replicated query, its bank shard and window rows."""
    g, pts, rng, valid, query, bank, bank_mask, window = inputs
    ax = mesh.axis(axis)
    i = slice(ax.index * pts.shape[0] // ax.size, (ax.index + 1) * pts.shape[0] // ax.size)
    return (graph_shardings(mesh, g, axis), pts[i], rng[i], valid[i], query,
            bank[ax.index], bank_mask[ax.index], window_shardings(mesh, window, axis))
