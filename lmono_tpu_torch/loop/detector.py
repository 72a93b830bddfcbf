"""Loop detection: place recognition + BRIEF matching + PnP verification.

Port of `lmono_tpu/loop/detector.py`: a keyframe's window landmarks (3D,
with descriptors) are matched against the top place-recognition candidates'
keypoints by Hamming distance, verified with PnP-RANSAC and gated
geometrically; the earliest verified candidate's relative pose is then
refined by LiDAR registration of the two keyframes' feature sets, which
runs kernel K1 (`lidar/registration.py:register` → `ops/knn.py:knn`).

The reference splits a JAX key per keyframe and per candidate; here the
PnP draws are Gumbel noise, one (iters, 6, Kw) block per candidate, drawn
from the detector's `torch.Generator`.  `LoopDetector.process_keyframe` is
the reference's fused path (`process_fused`): prep → detect → `db_add`.
The host keeps the keyframe count, so nothing is read back per keyframe.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lmono_tpu_torch import default_device
from lmono_tpu_torch.config import LoopConfig
from lmono_tpu_torch.lidar.registration import register
from lmono_tpu_torch.loop.keyframe_db import KeyframeDB, db_add, db_query
from lmono_tpu_torch.ops.brief import (brief_describe, make_codebook,
                                       match_descriptors, patch_orientation,
                                       unpack_bits)
from lmono_tpu_torch.ops.corners import detect_grid
from lmono_tpu_torch.ops.ransac import gumbel_noise, ransac_pnp
from lmono_tpu_torch.utils.lie import Pose, mat_to_ypr, quat_to_mat

TOP_K = 4   # place-recognition candidates verified per keyframe


class LoopResult(NamedTuple):
    found: torch.Tensor        # () bool
    old_slot: torch.Tensor     # () int32 db slot of matched keyframe
    old_seq: torch.Tensor      # () int32 global index of matched keyframe
    rel_t: torch.Tensor        # (3,) T_old_cur translation (camera frames)
    rel_q: torch.Tensor        # (4,)
    n_matches: torch.Tensor    # () int32 BRIEF matches
    n_inliers: torch.Tensor    # () int32 PnP inliers
    score: torch.Tensor        # () f32 place-recognition score
    refined: torch.Tensor      # () bool — LiDAR GN refinement accepted
    refine_inliers: torch.Tensor  # () int32


class CandidateRows(NamedTuple):
    """DB rows of the top-k place-recognition candidates (leading axis k)."""
    desc: torch.Tensor        # (k, K, B) ±1
    kp_norm: torch.Tensor     # (k, K, 2)
    kp_mask: torch.Tensor     # (k, K)
    t: torch.Tensor           # (k, 3)
    q: torch.Tensor           # (k, 4)
    seq: torch.Tensor         # (k,)
    lidar_edge: torch.Tensor        # (k, Ke, 3)
    lidar_edge_mask: torch.Tensor   # (k, Ke)
    lidar_planar: torch.Tensor      # (k, Kp, 3)
    lidar_planar_mask: torch.Tensor  # (k, Kp)


def gather_rows(db: KeyframeDB, slots: torch.Tensor) -> CandidateRows:
    """The candidates' rows; only their descriptors are unpacked."""
    s = slots.long()
    return CandidateRows(
        desc=unpack_bits(db.desc[s]), kp_norm=db.kp_norm[s],
        kp_mask=db.kp_mask[s], t=db.t[s], q=db.q[s], seq=db.seq[s],
        lidar_edge=db.lidar_edge[s], lidar_edge_mask=db.lidar_edge_mask[s],
        lidar_planar=db.lidar_planar[s],
        lidar_planar_mask=db.lidar_planar_mask[s])


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d device index, without reading it back."""
    return torch.index_select(x, 0, i.reshape(1))[0]


def verify_candidates(rows: CandidateRows, top_s, top_i, gate, cfg: LoopConfig,
                      *, win_desc, win_pts, win_norm, win_mask,
                      cur_pose: Pose, gumbel: torch.Tensor, win_pnp_mask,
                      lidar=None) -> LoopResult:
    """Geometric verification of the gated candidates, batched over them:
    BRIEF match → PnP-RANSAC → angle/translation gate; the earliest verified
    candidate is picked and its relative pose optionally refined by LiDAR
    registration.  gumbel: (k, pnp_ransac_iters, 6, Kw)."""
    # BRIEF matching: current window landmarks ↔ each old keyframe's keypoints
    idx_b, m_ok = match_descriptors(win_desc, win_mask, rows.desc, rows.kp_mask,
                                    max_hamming=cfg.hamming_max)      # (k, Kw)
    n_matches = torch.sum(m_ok, dim=-1)
    # PnP: current 3D world points vs the old keyframe's 2D normalized obs
    obs_old = torch.gather(rows.kp_norm, 1, idx_b.long()[..., None].expand(-1, -1, 2))
    # free hypothesis: at a true revisit the old keyframe's own
    # camera-from-world is nearly the answer
    prior = Pose(rows.t, rows.q).inverse()
    pose_pnp, inl, pnp_ok = ransac_pnp(
        win_pts, obs_old, m_ok & win_pnp_mask, gumbel,
        thresh=(cfg.pnp_reproj_px / 460.0) ** 2,
        min_inliers=cfg.min_pnp_inliers, prior_pose=prior)
    n_inl = torch.sum(inl, dim=-1)
    # pose_pnp: oldcam-from-world ⇒ T_old_cur = pose_pnp ∘ T_w_cur
    rels = pose_pnp.compose(Pose(cur_pose.t.expand_as(pose_pnp.t),
                                 cur_pose.q.expand_as(pose_pnp.q)))
    # geometric gate on the revisit: |Δyaw| < ANGLE_THRESHOLD, |Δt| < TRANS
    ypr = mat_to_ypr(quat_to_mat(rels.q))
    ang_ok = torch.abs(torch.rad2deg(ypr[..., 0])) < cfg.angle_threshold_deg
    trans_ok = torch.linalg.vector_norm(rels.t, dim=-1) < cfg.trans_threshold
    ok_k = (n_matches >= cfg.min_brief_matches) & pnp_ok & ang_ok & trans_ok & gate
    # earliest verified candidate (smallest global seq), reference-style
    seqs = torch.where(ok_k, rows.seq, torch.full_like(rows.seq, torch.iinfo(torch.int32).max))
    pick = torch.argmin(seqs)
    rel = Pose(_take(rels.t, pick), _take(rels.q, pick))
    found = torch.any(ok_k)

    refined = torch.zeros((), dtype=torch.bool, device=found.device)
    refine_inl = torch.zeros((), dtype=torch.int32, device=found.device)
    if lidar is not None:
        # LiDAR refinement of the loop relative pose: register the two
        # keyframes' edge/planar feature sets from the PnP estimate
        cur_edge, cur_edge_mask, cur_planar, cur_planar_mask, T_CL, lidar_cfg = lidar
        T_LC = T_CL.inverse()
        refined_laser, diag = register(
            T_LC.compose(rel).compose(T_CL),
            cur_edge, cur_edge_mask, cur_planar, cur_planar_mask,
            _take(rows.lidar_edge, pick), _take(rows.lidar_edge_mask, pick),
            _take(rows.lidar_planar, pick), _take(rows.lidar_planar_mask, pick),
            lidar_cfg, cfg.refine_iters)
        refine_inl = diag["inliers"][-1].to(torch.int32)
        refined = found & (refine_inl >= cfg.refine_min_inliers)
        rel_ref = T_CL.compose(refined_laser).compose(T_LC)
        rel = Pose(torch.where(refined, rel_ref.t, rel.t),
                   torch.where(refined, rel_ref.q, rel.q))

    return LoopResult(
        found=found,
        old_slot=_take(top_i, pick).to(torch.int32),
        old_seq=_take(rows.seq, pick).to(torch.int32),
        rel_t=rel.t, rel_q=rel.q,
        n_matches=_take(n_matches, pick).to(torch.int32),
        n_inliers=_take(n_inl, pick).to(torch.int32),
        score=_take(top_s, pick),
        refined=refined,
        refine_inliers=refine_inl,
    )


def detect_and_verify(db: KeyframeDB, codebook: torch.Tensor, cfg: LoopConfig,
                      *, desc, kp_mask, win_desc, win_pts, win_norm, win_mask,
                      cur_pose: Pose, cur_seq: int, cur_time: float,
                      gumbel: torch.Tensor, win_pnp_mask=None,
                      lidar=None) -> LoopResult:
    """Query the DB with the current keyframe and verify every gated
    candidate (the best must clear score_best_min, each score_accept,
    LoopDetector.cc:220-257), keeping the earliest that passes.

    win_mask gates descriptor matching; win_pnp_mask (default win_mask)
    additionally gates which matches enter PnP.
    """
    if win_pnp_mask is None:
        win_pnp_mask = win_mask
    top_s, top_i, top_ok = db_query(db, codebook, desc, kp_mask, cur_seq,
                                    cur_time, cfg, top_k=TOP_K)
    gate = top_ok & (top_s > cfg.score_accept) & (top_s[0] > cfg.score_best_min)
    return verify_candidates(
        gather_rows(db, top_i), top_s, top_i, gate, cfg,
        win_desc=win_desc, win_pts=win_pts, win_norm=win_norm,
        win_mask=win_mask, cur_pose=cur_pose, gumbel=gumbel,
        win_pnp_mask=win_pnp_mask, lidar=lidar)


class LoopDetector:
    """Host-side runner of the loop lane on one device, the CUDA card unless
    another is named (`default_device`): keyframe ingestion with the
    reference's skip gates (`loop_detection_node.cc:147-297`), detection
    and the DB append.

    lidar_cfg enables the LiDAR refinement of loop edges, with that
    configuration as it is: the reference's fused path registers with the
    odometry's own `corr_max_dist` (its widened copy, `detector.py:298-303`,
    reaches only the per-stage path, which the port does not keep).
    """

    def __init__(self, cfg: LoopConfig, image_shape: tuple[int, int],
                 focal: float = 460.0, lidar_cfg=None, device=None,
                 generator: torch.Generator | None = None):
        self.cfg = cfg
        self.lidar_cfg = lidar_cfg
        self.device = default_device(device)
        self.codebook = make_codebook(cfg.brief_bits, cfg.vocab_dim,
                                      device=self.device)
        self.db = KeyframeDB.empty(cfg, self.device)
        self.count = 0                 # keyframes added (the DB's next seq)
        self._last_time = -1e9
        self._last_pos = None
        self._last_loop_time = -1e9   # SKIP_LOOP_* gates (node.cc:284-285)
        self._last_loop_pos = None
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(7)
        self.generator = generator
        self.image_shape = image_shape

    def gumbel(self) -> torch.Tensor:
        """One keyframe's PnP noise: (TOP_K, pnp_ransac_iters, 6, Kw)."""
        return gumbel_noise((TOP_K, self.cfg.pnp_ransac_iters, 6,
                             self.cfg.window_points), self.generator, self.device)

    def prep(self, image, win_uv, win_mask):
        """Keypoints and BRIEF descriptors of the keyframe image, and the
        window landmarks' descriptors."""
        cfg = self.cfg
        H, W = self.image_shape
        dev = image.device
        kp_uv, kp_ok = detect_grid(image, max(8, H // 24), cfg.max_keypoints,
                                   torch.zeros((1, 2), device=dev),
                                   torch.zeros((1,), dtype=torch.bool, device=dev))
        if cfg.image_crop > 0:
            # IMAGE_CROP: drop keypoints near the left/right borders (the
            # reference's extension of the yaml's intent to the FAST path)
            c = float(cfg.image_crop)
            kp_ok = kp_ok & (kp_uv[:, 0] >= c) & (kp_uv[:, 0] <= W - c)
        if cfg.use_orb:
            desc = brief_describe(image, kp_uv, kp_ok,
                                  angle=patch_orientation(image, kp_uv))
            wdesc = brief_describe(image, win_uv, win_mask,
                                   angle=patch_orientation(image, win_uv))
        else:
            desc = brief_describe(image, kp_uv, kp_ok)
            wdesc = brief_describe(image, win_uv, win_mask)
        return kp_uv, kp_ok, desc, wdesc

    def detect_add(self, image, cam, win_uv, win_norm, win_pts, win_mask, wpnp,
                   cam_pose: Pose, time: float, gumbel: torch.Tensor,
                   lidar_pack=None) -> LoopResult:
        """The reference's `process_fused` without its gates: prep → detect
        → append the keyframe to the DB as number `self.count`.
        lidar_pack: (edge, edge_mask, planar, planar_mask, T_CL) or None."""
        time = float(np.float32(time))
        kp_uv, kp_ok, desc, wdesc = self.prep(image, win_uv, win_mask)
        kp_norm = cam.lift_to_normalized(kp_uv)
        lidar = None
        if lidar_pack is not None:
            lidar = (*lidar_pack, self.lidar_cfg)
        res = detect_and_verify(
            self.db, self.codebook, self.cfg,
            desc=desc, kp_mask=kp_ok, win_desc=wdesc, win_pts=win_pts,
            win_norm=win_norm, win_mask=win_mask, cur_pose=cam_pose,
            cur_seq=self.count, cur_time=time, gumbel=gumbel,
            win_pnp_mask=wpnp, lidar=lidar)
        kw = dict(desc=desc, kp_norm=kp_norm, kp_mask=kp_ok, win_desc=wdesc,
                  win_pts=win_pts, win_norm=win_norm, win_mask=win_mask,
                  t=cam_pose.t, q=cam_pose.q, time=time)
        if lidar_pack is not None:
            kw.update(lidar_edge=lidar_pack[0], lidar_edge_mask=lidar_pack[1],
                      lidar_planar=lidar_pack[2], lidar_planar_mask=lidar_pack[3])
        db_add(self.db, self.codebook, self.count, **kw)
        self.count += 1
        return res

    def process_keyframe(self, image, cam, win_uv, win_norm, win_pts,
                         win_mask, cam_pose: Pose, time: float,
                         win_pnp_mask=None, lidar_features=None,
                         extrinsic: Pose | None = None,
                         defer_note: bool = False, pos=None,
                         gumbel: torch.Tensor | None = None):
        """Returns a LoopResult, or None when skip-gated.

        lidar_features: optional (edge, edge_mask, planar, planar_mask) in
        the current sensor frame, at the DB's kf_edge_points /
        kf_planar_points; with `extrinsic` (T_CL) it enables the LiDAR
        refinement.  defer_note=True leaves `found` on the device (the
        caller reaps it and records accepted loops via `note_loop`).
        pos: the keyframe position as a host array, if the caller has it
        (else it is read back).  gumbel: the PnP noise (`gumbel()` draws it
        when not given).
        """
        pos = cam_pose.t.cpu().numpy() if pos is None else np.asarray(pos)
        if time - self._last_time < self.cfg.skip_time:
            return None
        # SKIP_LOOP_*: after an accepted loop, suppress processing for a
        # while / within a radius (loop_detection_node.cc:211,242)
        if time - self._last_loop_time < self.cfg.skip_loop_time:
            return None
        # the reference's last_skip_time advances once the time gates pass,
        # even when a distance gate then rejects the frame (:234)
        self._last_time = time
        if self._last_pos is not None and \
                np.linalg.norm(pos - self._last_pos) < self.cfg.skip_dis:
            return None
        if self._last_loop_pos is not None and \
                np.linalg.norm(pos - self._last_loop_pos) < self.cfg.skip_loop_dis:
            return None
        self._last_pos = pos

        if win_pnp_mask is None:
            win_pnp_mask = win_mask
        lidar_pack = None
        if (lidar_features is not None and self.lidar_cfg is not None
                and extrinsic is not None):
            lidar_pack = (*lidar_features, extrinsic)
        res = self.detect_add(image, cam, win_uv, win_norm, win_pts, win_mask,
                              win_pnp_mask, cam_pose, time,
                              self.gumbel() if gumbel is None else gumbel,
                              lidar_pack)
        if defer_note:
            return res
        if self.cfg.skip_loop_time > 0 or self.cfg.skip_loop_dis > 0:
            if bool(res.found):
                self.note_loop(time, pos)
        return res

    def note_loop(self, time, pos) -> None:
        """Record an accepted loop for the SKIP_LOOP_* gates."""
        self._last_loop_time = time
        self._last_loop_pos = pos
