"""Sliding-window LiDAR–monocular fusion estimator (the reference's core).

Port of `lmono_tpu/estimator/estimator.py`.  Per frame, `fusion_step`

  1. sanitizes the odometry pose and enters the new frame with a
     laser-propagated pose,
  2. ingests tracked features and runs the parallax keyframe test,
  3. (estimate_laser==2) accumulates hand-eye pairs until the extrinsic
     rotation converges,
  4. once the window is full: triangulates, solves the window LM, rejects
     an unhealthy solve and outliers,
  5. marginalizes the oldest frame (keyframe) or drops the second-newest
     (non-keyframe) and slides.

The JAX package branches on device values inside one program (`lax.cond`
over ready, full and is_kf).  Here:

* `count` (frames in the window before this one) is a host int: it is
  min(frames seen, W), so `full` is host control flow and the caller keeps
  the count as `LidarOdometry` keeps its frame;
* `ready` equals `full` unless estimate_laser == 2; then it and `is_kf`
  come back in one read, else `is_kf` alone, once per full frame;
* the LM loop reads its `done` flag once per attempt (`solver.py`).

With `axis` (a mesh `Axis`, `parallel/mesh.py`) the feature table's rows
are this rank's block and the rest is replicated: the new-row placement
and the keyframe test psum their few global values, as in the JAX package.
From DIST_WINDOW_CROSSOVER shards up the window solve is the
landmark-sharded LM (`parallel/dist_window.py`) and marginalization psums
its reduced system.  Below it a full window's table is gathered once, and
the dense solve, the outlier test, marginalization and the slide run on
it alike on every rank, each keeping its own rows back; the gathered
table after the slide comes out in `FusionOutput.feats_gathered`.  The
JAX package gathers for the solve alone there and psums the
marginalization: on a (2, 2) mesh at the mesh tests' widths, on the CPU,
the reassociated prior moved the extrinsic and the dense colored map kept
97.85% of its slots alike (the gate is 99%), where the whole-table step
gives the single-device result.  Every branch the host takes follows
from psum'd or replicated values, so the ranks stay in step.

`FusionOutput` carries the host counts `lm_attempts`, `lm_replayed` (the
attempts that replayed the solver's CUDA graph) and `readbacks`.  The
hand-eye correspondence gather `corr @ prev_norm` stays the reference's
one-hot matmul: exact with TF32 off, as the package sets it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from lmono_tpu_torch import default_device
from lmono_tpu_torch.config import EstimatorConfig
from lmono_tpu_torch.estimator import feature_manager as fm
from lmono_tpu_torch.estimator.initializer import (
    RP_ITERS,
    HandEyeState,
    handeye_update,
    relative_pose_from_tracks,
)
from lmono_tpu_torch.estimator.marginalization import marginalize_oldest
from lmono_tpu_torch.estimator.solver import outlier_rejection, solve_window
from lmono_tpu_torch.estimator.tracker import TrackOutput
from lmono_tpu_torch.estimator.window import FeatureTable, WindowState, tree_where
from lmono_tpu_torch.parallel.mesh import all_gather_rows
from lmono_tpu_torch.ops.ransac import gumbel_noise
from lmono_tpu_torch.utils.lie import (
    Pose,
    quat_conj,
    quat_identity,
    quat_mul,
    quat_normalize,
    quat_rotate,
)
from lmono_tpu_torch.utils.timing import read, span


# Landmark-sharded window-solve crossover, measured by the JAX package on its
# 8-way CPU mesh (sharded/dense time 2.6x at 1 shard, 1.13x at 2, 0.29x at
# 4).  Below this many shards the gathered dense solve runs instead.
DIST_WINDOW_CROSSOVER = 4


class EstimatorState(NamedTuple):
    window: WindowState
    handeye: HandEyeState
    prev_norm: torch.Tensor     # (N,2) previous frame's normalized tracks
    prev_ids: torch.Tensor      # (N,)
    prev_alive: torch.Tensor    # (N,)
    prev_laser_t: torch.Tensor  # (3,) previous frame's raw laser pose: the
    prev_laser_q: torch.Tensor  # (4,) exact one-frame hand-eye baseline

    @staticmethod
    def init(cfg: EstimatorConfig, T_CL: Pose | None, n_tracks: int,
             device=None) -> "EstimatorState":
        return EstimatorState(
            window=WindowState.init(cfg, T_CL, device),
            handeye=HandEyeState.init(device=device),
            prev_norm=torch.zeros((n_tracks, 2), device=device),
            prev_ids=torch.full((n_tracks,), -1, dtype=torch.int32, device=device),
            prev_alive=torch.zeros((n_tracks,), dtype=torch.bool, device=device),
            prev_laser_t=torch.zeros((3,), device=device),
            prev_laser_q=quat_identity(device=device),
        )


class FusionOutput(NamedTuple):
    pose: Pose                 # world-from-laser, newest frame (post-solve)
    cam_pose: Pose             # world-from-camera
    extrinsic: Pose            # T_CL estimate
    is_keyframe: torch.Tensor
    initialized: torch.Tensor
    n_tracked: torch.Tensor
    solve_cost: torch.Tensor
    keyframe_slot: int         # window slot of the newest frame
    lm_attempts: int           # LM attempts of this frame's solve (0: none)
    lm_replayed: int           # of them, replays of a captured CUDA graph
    readbacks: int             # device values the host read this frame
    # the whole feature table after the slide, where the step gathered it
    # (a mesh below DIST_WINDOW_CROSSOVER, a full window), else None
    feats_gathered: Optional[FeatureTable] = None


def _enter_frame(w: WindowState, laser: Pose, count: int
                 ) -> tuple[WindowState, int]:
    """Place the new frame at slot = count (capped at W): predicted pose from
    laser-odometry relative motion, and record the raw laser pose."""
    slot = min(count, w.w1 - 1)
    prev = max(slot - 1, 0)
    if count == 0:
        pred_t, pred_q = laser.t, laser.q
    else:
        # relative laser motion prev→new
        dq = quat_mul(quat_conj(w.lq[prev]), laser.q)
        dp = quat_rotate(quat_conj(w.lq[prev]), laser.t - w.lt[prev])
        pred_t = w.t[prev] + quat_rotate(w.q[prev], dp)
        pred_q = quat_normalize(quat_mul(w.q[prev], dq))

    def put(x, v):
        x = x.clone()
        x[slot] = v
        return x

    return w._replace(
        t=put(w.t, pred_t), q=put(w.q, pred_q),
        lt=put(w.lt, laser.t), lq=put(w.lq, laser.q),
        count=w.count + 1,
    ), slot


def _sanitize(w: WindowState, laser: Pose, count: int) -> Pose:
    """A non-finite or absurdly jumping odometry pose is replaced by the
    constant-velocity extrapolation of the previous laser poses."""
    slot_prev = max(min(count, w.w1 - 1) - 1, 0)
    slot_pp = max(slot_prev - 1, 0)
    lq_pp, lq_p = w.lq[slot_pp], w.lq[slot_prev]
    dq_cv = quat_mul(quat_conj(lq_pp), lq_p)
    dp_cv = quat_rotate(quat_conj(lq_pp), w.lt[slot_prev] - w.lt[slot_pp])
    cv_t = w.lt[slot_prev] + quat_rotate(lq_p, dp_cv)
    cv_q = quat_normalize(quat_mul(lq_p, dq_cv))
    sane = torch.all(torch.isfinite(laser.t)) & torch.all(torch.isfinite(laser.q))
    if count > 0:
        d = laser.t - w.lt[slot_prev]
        sane = sane & (torch.sqrt(torch.sum(d * d)) < 10.0)
    return Pose(torch.where(sane, laser.t, cv_t), torch.where(sane, laser.q, cv_q))


def _solve(w: WindowState, cfg: EstimatorConfig, axis=None):
    """Triangulate, solve, keep the laser-propagated window if the solve is
    not finite, reject outliers; returns (window, cost, SolveDiag)."""
    w = fm.triangulate(w, cfg)
    with span("window_solve"):
        if axis is None:
            w2, diag = solve_window(w, cfg)
        else:
            # imported here: dist_window imports the estimator package
            from lmono_tpu_torch.parallel.dist_window import _lm_loop
            w2, diag = _lm_loop(w, cfg, axis)
    healthy = (torch.all(torch.isfinite(w2.t)) & torch.all(torch.isfinite(w2.q))
               & torch.isfinite(diag.cost1))
    w2 = outlier_rejection(tree_where(healthy, w2, w), cfg)
    w2 = w2._replace(initialized=torch.ones_like(w2.initialized),
                     ex_refines=w2.ex_refines + int(cfg.estimate_laser >= 1))
    # freeze the extrinsic prior target when reaching FINE_TIMES
    freeze = w2.ex_refines == cfg.fine_times
    w2 = w2._replace(ex_ref_t=torch.where(freeze, w2.ex_t, w2.ex_ref_t),
                     ex_ref_q=torch.where(freeze, w2.ex_q, w2.ex_ref_q))
    return w2, diag.cost1, diag


def fusion_step(state: EstimatorState, track: TrackOutput, laser: Pose,
                cfg: EstimatorConfig, count: int,
                gumbel: torch.Tensor | None = None, axis=None
                ) -> tuple[EstimatorState, FusionOutput]:
    """One frame into the window.

    count: the host copy of `state.window.count` (frames in the window
    before this one).  gumbel: (RP_ITERS, 8, N) Gumbel noise of the
    relative-pose RANSAC, needed only when estimate_laser == 2.  axis: the
    landmark axis over which `state.window.feats` is sharded (module
    docstring); the track, laser pose and noise are replicated.
    """
    w1 = cfg.window_size + 1
    wprev = state.window
    laser = _sanitize(wprev, laser, count)
    w, slot = _enter_frame(wprev, laser, count)

    # ---- features in
    feats = fm.ingest_observations(w.feats, track, slot, axis=axis)
    w = w._replace(feats=feats)
    is_kf = fm.keyframe_check(feats, slot, cfg, axis=axis)

    # ---- hand-eye extrinsic rotation (estimate_laser == 2)
    he = state.handeye
    if cfg.estimate_laser == 2:
        with span("handeye"):
            # correspondences: features alive now and last frame
            corr = ((track.ids[:, None] == state.prev_ids[None, :])
                    & track.alive[:, None] & state.prev_alive[None, :]
                    & (track.ids[:, None] >= 0))
            prev_of = corr.to(track.norm.dtype) @ state.prev_norm
            q_cam, rp_ok = relative_pose_from_tracks(
                prev_of, track.norm, torch.any(corr, dim=1), gumbel)
            q_las = quat_mul(quat_conj(state.prev_laser_q), laser.q)
            pair_ok = rp_ok & ~he.converged & (count > 0)
            he = handeye_update(he, q_cam, q_las, pair_ok)
        # adopt the rotation estimate until converged+frozen
        adopt = he.converged & ~state.handeye.converged
        w = w._replace(ex_q=torch.where(adopt, he.q_ex, w.ex_q),
                       ex_ref_q=torch.where(adopt, he.q_ex, w.ex_ref_q))

    full = count + 1 >= w1
    readbacks = 0
    kf = ready = False
    if full:
        if cfg.estimate_laser == 2:
            kf, ready = read(torch.Tensor.tolist, torch.stack(
                [is_kf, w.initialized | he.converged]))
        else:
            kf, ready = read(bool, is_kf), True
        readbacks += 1

    # below the crossover the rest of a full window's step runs on the
    # whole table, gathered once
    m = w.feats.ids.shape[0]
    whole = full and axis is not None and axis.size < DIST_WINDOW_CROSSOVER
    if whole:
        w = w._replace(feats=all_gather_rows(axis, w.feats))
    win_axis = None if whole else axis

    attempts = replayed = 0
    cost = torch.zeros((), device=w.t.device)
    if ready:
        w, cost, diag = _solve(w, cfg, win_axis)
        attempts, readbacks = diag.iters, readbacks + diag.readbacks
        replayed = diag.replayed

    out_pose = Pose(w.t[slot], w.q[slot])
    T_CL = Pose(w.ex_t, w.ex_q)
    output = FusionOutput(
        pose=out_pose,
        cam_pose=out_pose.compose(T_CL.inverse()),
        extrinsic=T_CL,
        is_keyframe=is_kf,
        initialized=w.initialized,
        n_tracked=torch.sum(track.alive),
        solve_cost=cost,
        keyframe_slot=slot,
        lm_attempts=attempts,
        lm_replayed=replayed,
        readbacks=readbacks,
    )

    # ---- slide when full
    if full:
        if kf:
            with span("marginalization"):
                prior = marginalize_oldest(w, cfg, axis=win_axis)
            w = fm.slide_old(w)._replace(prior=prior)
        else:
            w = fm.slide_new(w)
    if whole:
        i = axis.index
        output = output._replace(feats_gathered=w.feats)
        w = w._replace(feats=type(w.feats)(*(x[i * m:(i + 1) * m] for x in w.feats)))

    new_state = EstimatorState(
        window=w, handeye=he,
        prev_norm=track.norm, prev_ids=track.ids, prev_alive=track.alive,
        prev_laser_t=laser.t, prev_laser_q=laser.q,
    )
    return new_state, output


class FusionEstimator:
    """Host-side runner holding the estimator state on one device, the CUDA
    card unless another is named (`default_device`).

    `count` is the host copy of the window count.  The relative-pose noise
    (estimate_laser == 2) comes from `generator` (one is made from seed 42
    on `device` when none is given).
    """

    def __init__(self, cfg: EstimatorConfig, T_CL: Pose | None = None,
                 n_tracks: int | None = None, device=None,
                 generator: torch.Generator | None = None):
        self.cfg = cfg
        self.device = default_device(device)
        self.n_tracks = n_tracks or cfg.max_tracks
        self.state = EstimatorState.init(cfg, T_CL, self.n_tracks, self.device)
        self.count = 0
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(42)
        self.generator = generator

    def gumbel(self) -> torch.Tensor:
        """Gumbel noise for one frame's relative-pose RANSAC draws."""
        return gumbel_noise((RP_ITERS, 8, self.n_tracks), self.generator,
                            self.device)

    def process(self, track: TrackOutput, laser_pose: Pose,
                gumbel: torch.Tensor | None = None) -> FusionOutput:
        """gumbel: optional explicit relative-pose noise (estimate_laser == 2)."""
        if gumbel is None and self.cfg.estimate_laser == 2:
            gumbel = self.gumbel()
        laser_pose = Pose(laser_pose.t.to(self.device), laser_pose.q.to(self.device))
        self.state, out = fusion_step(self.state, track, laser_pose, self.cfg,
                                      self.count, gumbel)
        self.count = min(self.count + 1, self.cfg.window_size)
        return out
