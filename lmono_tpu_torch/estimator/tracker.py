"""Monocular feature-tracking front-end with fixed feature slots.

Port of `lmono_tpu/estimator/tracker.py` (the reference `FeatureTracker`,
`mono_lidar_mapping/src/image_process/FeatureTracker.cc`): KLT pyramid
tracking with a forward-backward check, a fundamental-matrix RANSAC gate,
and Shi–Tomasi re-detection into dead slots.  A slot holds a feature id,
pixel position, track count and validity.

The JAX package keeps its frame counter on the device and its RANSAC draws
come from a JAX key.  Here `tracker_step` takes the host frame number
(`FeatureTracker.frame`, as `LidarOdometry.frame`) and the Gumbel noise of
its RANSAC draws; `FeatureTracker` draws that noise from its
`torch.Generator`.  No step reads a device value back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lmono_tpu_torch import default_device
from lmono_tpu_torch.camera.base import CameraModel
from lmono_tpu_torch.config import TrackerConfig
from lmono_tpu_torch.ops.corners import detect_grid
from lmono_tpu_torch.ops.image import build_pyramid, scharr_gradients
from lmono_tpu_torch.ops.lk import track_fb
from lmono_tpu_torch.ops.ransac import (gumbel_noise, masked_categorical,
                                        ransac_fundamental)
from lmono_tpu_torch.utils.timing import span


class TrackerState(NamedTuple):
    uv: torch.Tensor          # (N, 2) current pixel positions
    norm: torch.Tensor        # (N, 2) normalized image coords
    ids: torch.Tensor         # (N,) int32 feature ids (-1 = empty)
    track_cnt: torch.Tensor   # (N,) int32 frames tracked
    alive: torch.Tensor       # (N,) bool
    next_id: torch.Tensor     # () int32
    pyramid: tuple            # tuple of (H,W) tensors (previous frame)
    grads: tuple              # tuple of ((H,W),(H,W)) per level
    frame: torch.Tensor       # () int32 (device copy of the host counter)

    @staticmethod
    def init(cfg: TrackerConfig, height: int, width: int,
             device=None) -> "TrackerState":
        N = cfg.max_features

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        pyr = tuple(zeros(height // 2 ** l, width // 2 ** l)
                    for l in range(cfg.pyramid_levels))
        return TrackerState(
            uv=zeros(N, 2),
            norm=zeros(N, 2),
            ids=torch.full((N,), -1, dtype=torch.int32, device=device),
            track_cnt=zeros(N, dtype=torch.int32),
            alive=zeros(N, dtype=torch.bool),
            next_id=zeros(dtype=torch.int32),
            pyramid=pyr,
            grads=tuple((torch.zeros_like(p), torch.zeros_like(p)) for p in pyr),
            frame=zeros(dtype=torch.int32),
        )


class TrackOutput(NamedTuple):
    """Per-frame feature observations for the estimator."""
    ids: torch.Tensor        # (N,) int32, -1 for empty slots
    uv: torch.Tensor         # (N, 2) pixels
    norm: torch.Tensor       # (N, 2) normalized coords (x, y)
    velocity: torch.Tensor   # (N, 2) d(norm)/dt
    track_cnt: torch.Tensor  # (N,)
    alive: torch.Tensor      # (N,)


def tracker_step(state: TrackerState, image: torch.Tensor, cam: CameraModel,
                 cfg: TrackerConfig, gumbel: torch.Tensor, frame: int,
                 dt: float = 0.1) -> tuple[TrackerState, TrackOutput]:
    """Process one grayscale image (H, W) in [0,1].

    gumbel: (f_ransac_iters, 8, max_features) standard Gumbel noise for the
    RANSAC draws.  frame: the host copy of `state.frame`.  Frame 0 tracks
    like every other frame (fixed work per frame) with every slot masked.
    """
    pyr1 = tuple(build_pyramid(image, cfg.pyramid_levels))
    grads1 = tuple(scharr_gradients(p) for p in pyr1)

    # ---- 1. KLT forward-backward tracking of live slots
    mask = state.alive if frame > 0 else torch.zeros_like(state.alive)
    uv1, ok = track_fb(state.pyramid, state.grads, pyr1, grads1,
                       state.uv, mask, patch=cfg.lk_patch, iters=cfg.lk_iters,
                       eps=cfg.lk_eps, fb_thresh=cfg.fb_threshold)

    # ---- 2. fundamental-matrix RANSAC gate on normalized coords
    norm1 = cam.lift_to_normalized(uv1)
    # threshold: f_threshold px at the camera's focal length (a host float)
    f_px = float(cam.params.get("fx", cam.params.get("gamma1", 460.0)))
    thr = (cfg.f_threshold / f_px) ** 2
    with span("tracker.ransac"):
        inl, _ = ransac_fundamental(state.norm, norm1, ok,
                                    masked_categorical(ok, gumbel), thresh=thr)
    ok = ok & inl
    ids = torch.where(ok, state.ids, -1)
    cnt = torch.where(ok, state.track_cnt + 1, 0)

    # ---- 3. re-detect into dead slots (spacing enforced by grid cells)
    N = cfg.max_features
    n_free = torch.sum(~ok)
    new_uv, new_ok = detect_grid(
        image, cfg.min_dist, N, uv1, ok,
        min_quality_rel=cfg.min_track_quality, border=cfg.border_margin)
    # k-th new feature goes to the k-th dead slot (stable order)
    dest = torch.argsort(ok.to(torch.int32), stable=True)
    take = new_ok & (torch.arange(N, device=ok.device) < n_free)
    new_ids = state.next_id + torch.cumsum(take.to(torch.int32), 0) - 1

    # dest is a permutation, so each slot is written once
    uv = uv1.index_copy(0, dest, torch.where(take[:, None], new_uv, uv1[dest]))
    ids = ids.index_copy(0, dest, torch.where(take, new_ids, ids[dest]).to(torch.int32))
    cnt = cnt.index_copy(0, dest, torch.where(take, 1, cnt[dest]).to(cnt.dtype))
    alive = ok.index_copy(0, dest, take | ok[dest])
    norm = cam.lift_to_normalized(uv)

    velocity = torch.where(ok[:, None], (norm - state.norm) / dt, 0.0)

    new_state = TrackerState(
        uv=uv, norm=norm, ids=ids, track_cnt=cnt, alive=alive,
        next_id=state.next_id + torch.sum(take).to(torch.int32),
        pyramid=pyr1, grads=grads1, frame=state.frame + 1,
    )
    out = TrackOutput(ids=ids, uv=uv, norm=norm, velocity=velocity,
                      track_cnt=cnt, alive=alive)
    return new_state, out


class FeatureTracker:
    """Host-side runner holding the tracker state on one device, the CUDA
    card unless another is named (`default_device`).

    `process` runs one image per call.  `frame` is the host frame counter;
    the RANSAC noise comes from `generator` (one is made from seed 0 on
    `device` when none is given).
    """

    def __init__(self, cam: CameraModel, cfg: TrackerConfig,
                 height: int, width: int, device=None,
                 generator: torch.Generator | None = None):
        self.cam = cam
        self.cfg = cfg
        self.device = default_device(device)
        self.state = TrackerState.init(cfg, height, width, self.device)
        self.frame = 0
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.generator = generator

    def gumbel(self) -> torch.Tensor:
        """Standard Gumbel noise for one frame's RANSAC draws."""
        return gumbel_noise((self.cfg.f_ransac_iters, 8, self.cfg.max_features),
                            self.generator, self.device)

    def process(self, image, gumbel: torch.Tensor | None = None) -> TrackOutput:
        """image: (H, W) grayscale in [0,1], a numpy array or a tensor.
        gumbel: optional explicit RANSAC noise (see `tracker_step`)."""
        image = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        if gumbel is None:
            gumbel = self.gumbel()
        self.state, out = tracker_step(self.state, image, self.cam, self.cfg,
                                       gumbel, self.frame)
        self.frame += 1
        return out
