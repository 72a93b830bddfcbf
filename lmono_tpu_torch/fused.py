"""Fused full-pipeline step: LiDAR odometry + KLT tracking + window fusion.

Port of `lmono_tpu/fused.py` (`fused_step`, `fused_chunk`,
`FusedPipeline`).  The JAX package scans the composed step over a chunk
of frames in one compiled program; here a chunk is a Python loop of
per-frame steps on the device (the port's convention for `lax.scan`
rollouts).  Each step runs K1 through `odometry_step` and K2 through
`tracker_step`'s `track_fb`.

The JAX state carries a PRNG key split three ways per frame; here
`FusedPipeline` holds a `torch.Generator` and hands each step its noise:
the tracker's RANSAC Gumbel noise and, when estimate_laser == 2, the
relative-pose RANSAC's.  The host keeps the frame number; the window count
is min(frame, W).  `system_chunk` adds the dense-map merge and the loop
lane's per-frame landmark extraction, sharing one depth image per frame.

With `mesh` (a (kf, map) `parallel.mesh.Mesh`) the same functions are the
JAX package's `dist_fused_step` / `DistributedFusedPipeline` step: the
odometry's banks and the dense map are sharded over "map", the window's
feature table over "kf" (`parallel/dist_engine.py`); everything else runs
replicated on every rank with the same noise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lmono_tpu_torch import default_device
from lmono_tpu_torch.camera.base import CameraModel
from lmono_tpu_torch.config import SystemConfig
from lmono_tpu_torch.estimator.estimator import EstimatorState, fusion_step
from lmono_tpu_torch.estimator.initializer import RP_ITERS
from lmono_tpu_torch.estimator.tracker import TrackerState, tracker_step
from lmono_tpu_torch.lidar.odometry import OdometryState, odometry_step
from lmono_tpu_torch.loop.landmarks import subsample_features, window_landmarks
from lmono_tpu_torch.mapping.builder import colormap_update_hash
from lmono_tpu_torch.mapping.depth import (backproject_colored, complete_depth,
                                           project_cloud)
from lmono_tpu_torch.ops.ransac import gumbel_noise
from lmono_tpu_torch.parallel.mesh import all_gather_rows
from lmono_tpu_torch.utils.lie import Pose
from lmono_tpu_torch.utils.timing import span

_SCAN = ("points", "ranges", "valid")


class FusedState(NamedTuple):
    odo: OdometryState
    trk: TrackerState
    est: EstimatorState

    @staticmethod
    def init(cfg: SystemConfig, T_CL: Pose | None, device=None) -> "FusedState":
        return FusedState(
            odo=OdometryState.init(cfg.lidar, device),
            trk=TrackerState.init(cfg.tracker, cfg.camera.height,
                                  cfg.camera.width, device),
            est=EstimatorState.init(cfg.estimator, T_CL,
                                    cfg.tracker.max_features, device),
        )


def fused_step(state: FusedState, frame: dict, cam: CameraModel,
               cfg: SystemConfig, gumbel: torch.Tensor, n: int,
               rp_gumbel: torch.Tensor | None = None,
               with_features: bool = False, mesh=None) -> tuple[FusedState, dict]:
    """One frame through odometry → tracker → fusion.

    frame: {points (R,W,3), ranges (R,W), valid (R,W), image (H,W)}.
    gumbel: the tracker's RANSAC noise (f_ransac_iters, 8, max_features);
    rp_gumbel: the relative-pose noise (96, 8, max_features), used when
    estimate_laser == 2.  n: the host frame number (the odometry's and
    tracker's `frame`).  The result holds device tensors and three host
    counts, `lm_attempts`, `lm_replayed` (of them, replays of the window
    solve's CUDA graph) and `readbacks`; with_features=True adds the
    scan's edge/planar feature sets (`result["features"]`) for the loop
    lane's LiDAR refinement and, on a mesh, the whole window feature table
    (`result["window_feats"]`) for its landmarks.  `handeye_q` /
    `handeye_converged` are the hand-eye rotation estimate R_CL and its
    adoption flag after this frame (identity and false unless
    estimate_laser == 2).  mesh: the state is
    this rank's part under `parallel.dist_engine.fused_specs`.
    """
    odo_axis = est_axis = None
    if mesh is not None:
        odo_axis, est_axis = mesh.axis("map"), mesh.axis("kf")
    with span("odometry"):
        odo, lo = odometry_step(state.odo, {k: frame[k] for k in _SCAN},
                                cfg.lidar, n, axis=odo_axis)
    with span("tracker"):
        trk, track = tracker_step(state.trk, frame["image"], cam, cfg.tracker,
                                  gumbel, n)
    est, out = fusion_step(state.est, track, lo["pose"], cfg.estimator,
                           min(n, cfg.estimator.window_size), rp_gumbel,
                           axis=est_axis)
    result = {
        "pose_t": out.pose.t, "pose_q": out.pose.q,
        "cam_t": out.cam_pose.t, "cam_q": out.cam_pose.q,
        "ex_t": out.extrinsic.t, "ex_q": out.extrinsic.q,
        "is_keyframe": out.is_keyframe,
        "initialized": out.initialized,
        "n_tracked": out.n_tracked,
        "laser_t": lo["pose"].t, "laser_q": lo["pose"].q,
        "solve_cost": out.solve_cost,
        "handeye_q": est.handeye.q_ex,
        "handeye_converged": est.handeye.converged,
        "lm_attempts": out.lm_attempts,
        "lm_replayed": out.lm_replayed,
        "readbacks": out.readbacks,
    }
    if with_features:
        result["features"] = lo["features"]
        if mesh is not None:
            # the whole feature table for the landmarks, gathered by the
            # step where it was (`FusionOutput.feats_gathered`), else here
            result["window_feats"] = (
                out.feats_gathered if out.feats_gathered is not None
                else all_gather_rows(est_axis, est.window.feats))
    return FusedState(odo, trk, est), result


def _stack(outs: list) -> dict:
    """Per-frame result dicts → one dict of stacked tensors (host counts
    become CPU int tensors)."""
    return {k: (torch.tensor([o[k] for o in outs]) if isinstance(outs[0][k], int)
                else torch.stack([o[k] for o in outs]))
            for k in outs[0]}


def fused_chunk(state: FusedState, frames: dict, cam: CameraModel,
                cfg: SystemConfig, gumbels: torch.Tensor, n: int,
                rp_gumbels: torch.Tensor | None = None, mesh=None
                ) -> tuple[FusedState, dict]:
    """Run `fused_step` over frames with a leading chunk axis; `gumbels`
    (and `rp_gumbels`) carry one frame's noise per row, `n` is the host
    frame number of the first.  Returns (state, stacked per-frame results;
    the host counts become CPU int tensors)."""
    outs = []
    for i in range(frames["points"].shape[0]):
        state, out = fused_step(
            state, {k: v[i] for k, v in frames.items()}, cam, cfg, gumbels[i],
            n + i, None if rp_gumbels is None else rp_gumbels[i], mesh=mesh)
        outs.append(out)
    return state, _stack(outs)


def system_chunk(state: FusedState, cmap, frames: dict, corr: Pose,
                 cam: CameraModel, cfg: SystemConfig, enable_map: bool,
                 enable_loop: bool, gumbels: torch.Tensor, n: int,
                 rp_gumbels: torch.Tensor | None = None, mesh=None):
    """The full per-frame system over a chunk: odometry + tracking + window
    fusion, the dense-map merge and the loop lane's landmark extraction
    (port of `lmono_tpu/fused.py:system_chunk`).

    The LiDAR depth image (projection + morphological completion) is made
    once per frame and shared by the map merge and the landmark depths.
    `corr` is the pose-graph drift correction at chunk start, applied to
    mapped points and landmark outputs.  `gumbels`/`rp_gumbels` and `n` are
    as in `fused_chunk`.  mesh: `cmap` is this rank's shard over "map"
    and `map_fill` the global occupancy; the landmarks come from the whole
    feature table (`fused_step`'s `window_feats`).

    Returns (state', cmap', stacked per-frame outputs with `map_fill`, the
    active bank's occupancy at chunk end, as a 0-d device tensor).
    """
    map_axis = None if mesh is None else mesh.axis("map")
    Kw = cfg.loop.window_points
    Ke, Kp = cfg.loop.kf_edge_points, cfg.loop.kf_planar_points
    mcfg = cfg.mapping
    outs = []
    for i in range(frames["points"].shape[0]):
        frame = {k: v[i] for k, v in frames.items()}
        state, res = fused_step(state, frame, cam, cfg, gumbels[i], n + i,
                                None if rp_gumbels is None else rp_gumbels[i],
                                with_features=enable_loop, mesh=mesh)
        feats = res.pop("features", None)
        w = state.est.window
        if mesh is not None and enable_loop:
            w = w._replace(feats=res.pop("window_feats"))
        corr_cam = corr.compose(Pose(res["cam_t"], res["cam_q"]))
        res.update(ccam_t=corr_cam.t, ccam_q=corr_cam.q)
        if enable_map or enable_loop:
            pts_cam = Pose(w.ex_t, w.ex_q).apply(frame["points"].reshape(-1, 3))
            depth, dmask = project_cloud(pts_cam, frame["valid"].reshape(-1), cam,
                                         mcfg.depth_min, mcfg.depth_max)
            depth_f, fmask = complete_depth(depth, dmask, mcfg)
        if enable_map:
            with span("map"):
                pts_c, colors, ok = backproject_colored(depth_f, fmask, frame["image"],
                                                        cam, mcfg)
                keep = ok & (pts_c[:, 1] > -mcfg.crop_height) & res["initialized"]
                cmap = colormap_update_hash(cmap, corr_cam.apply(pts_c), colors, keep,
                                            mcfg.map_voxel, axis=map_axis)
        if enable_loop:
            lm = window_landmarks(w, cam, mcfg, Kw, depth=depth_f, depth_mask=fmask)
            res.update(lm_pts=corr.apply(lm.pts_w), lm_norm=lm.norm, lm_uv=lm.uv,
                       lm_sel=lm.sel, lm_pnp=lm.sel_pnp)
            le, lem = subsample_features(feats.edge_points, feats.edge_mask, Ke)
            lp, lpm = subsample_features(feats.planar_points, feats.planar_mask, Kp)
            res.update(loop_edge=le, loop_edge_mask=lem, loop_planar=lp,
                       loop_planar_mask=lpm)
        outs.append(res)
    outs = _stack(outs)
    fill = torch.sum(cmap.mask)
    outs["map_fill"] = fill if map_axis is None else map_axis.psum(fill)
    return state, cmap, outs


class FusedPipeline:
    """Host-side runner of the fused step on one device, the CUDA card
    unless another is named (`default_device`).

    `process` runs one frame, `process_chunk` a stacked (F, ...) batch;
    both draw each frame's noise from `generator` (seed 7 on `device` when
    none is given) in the same order, so they give the same results.
    `frame` is the host frame counter.  `mesh` is None here;
    `parallel.dist_engine.DistributedFusedPipeline` sets it and holds this
    rank's part of the state.
    """

    mesh = None

    def __init__(self, cfg: SystemConfig, cam: CameraModel,
                 T_CL: Pose | None = None, device=None,
                 generator: torch.Generator | None = None):
        self.cfg = cfg
        self.cam = cam
        self.device = default_device(device)
        self.state = FusedState.init(cfg, T_CL, self.device)
        self.frame = 0
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(7)
        self.generator = generator

    def noise(self) -> tuple[torch.Tensor, torch.Tensor | None]:
        """One frame's (tracker, relative-pose) Gumbel noise."""
        n = self.cfg.tracker.max_features
        g = gumbel_noise((self.cfg.tracker.f_ransac_iters, 8, n),
                         self.generator, self.device)
        rp = (gumbel_noise((RP_ITERS, 8, n), self.generator, self.device)
              if self.cfg.estimator.estimate_laser == 2 else None)
        return g, rp

    def _to_device(self, frames: dict) -> dict:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in frames.items()}

    def process_chunk(self, frames: dict, noise: tuple | None = None) -> dict:
        """frames: stacked frames with leading (chunk,) axis.  noise:
        optional explicit (tracker, relative-pose or None) noise stacked
        per frame, as `noise()` draws it."""
        frames = self._to_device(frames)
        if noise is None:
            draws = [self.noise() for _ in range(frames["points"].shape[0])]
            g = torch.stack([d[0] for d in draws])
            rp = (torch.stack([d[1] for d in draws])
                  if self.cfg.estimator.estimate_laser == 2 else None)
        else:
            g, rp = noise
        self.state, outs = fused_chunk(self.state, frames, self.cam, self.cfg,
                                       g, self.frame, rp, mesh=self.mesh)
        self.frame += frames["points"].shape[0]
        return outs

    def process(self, frame: dict, noise: tuple | None = None,
                with_features: bool = False) -> dict:
        """One frame; noise: optional explicit (tracker, relative-pose);
        with_features: add the scan's feature sets (see `fused_step`)."""
        g, rp = self.noise() if noise is None else noise
        self.state, out = fused_step(self.state, self._to_device(frame),
                                     self.cam, self.cfg, g, self.frame, rp,
                                     with_features, mesh=self.mesh)
        self.frame += 1
        return out
