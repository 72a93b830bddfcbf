"""The loop detector's keyframe DB sharded over DB slots on a mesh axis.

Port of `lmono_tpu/parallel/dist_loop.py`.  The loop lane's O(C) work, the
tf-idf cosine score over the whole keyframe bank and the rows it keeps,
splits over DB slots: rank d owns global slots [d·C/D, (d+1)·C/D).

* Query: the idf's counts are psum'd (one psum of integers, exact), each
  rank scores its own rows and takes its top 4; the (score, slot) pairs
  are gathered over the axis and merged by a stable sort, so a tie goes
  to the lower global slot, as in the single-device query.
* Fetch: each winner's row is contributed by its owner, zeros elsewhere,
  in one psum of the rows' 32-bit words (`mesh.pack_words`), which gives
  the owner's bits exactly.
* Add: only the owner of slot count % C writes; the count is the host's.

Verification (BRIEF match, PnP-RANSAC, LiDAR refinement through K1) is
O(1) in C and runs replicated: every rank draws the same PnP noise from an
identically seeded generator.  Query and fetch equal the single-device
detector's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from lmono_tpu_torch.config import LoopConfig
from lmono_tpu_torch.loop.detector import CandidateRows, verify_candidates
from lmono_tpu_torch.loop.keyframe_db import KeyframeDB, db_add
from lmono_tpu_torch.loop.landmarks import top_k_indices
from lmono_tpu_torch.ops.brief import global_descriptor, unpack_bits
from lmono_tpu_torch.parallel.mesh import (Mesh, gather_sharded, pack_words,
                                           put_sharded, unpack_words)


def db_specs(axis: str = "kf") -> KeyframeDB:
    """Spec tree: every (C, ...) field shards its slot axis; the count
    mirror is replicated."""
    return KeyframeDB(**{f: (None if f == "count" else axis)
                         for f in KeyframeDB._fields})


def put_db_sharded(mesh: Mesh, db: KeyframeDB, axis: str = "kf") -> KeyframeDB:
    return put_sharded(mesh, db, db_specs(axis))


def gather_db(mesh: Mesh, db: KeyframeDB, axis: str = "kf") -> KeyframeDB:
    """The whole DB from this rank's shard (the same on every rank)."""
    return gather_sharded(mesh, db, db_specs(axis))


_ROW_FIELDS = ("desc", "kp_norm", "kp_mask", "t", "q", "seq", "lidar_edge",
               "lidar_edge_mask", "lidar_planar", "lidar_planar_mask")


def sharded_query_fetch(db: KeyframeDB, g: torch.Tensor, cur_seq: int,
                        cur_time: float, cfg: LoopConfig, axis, top_k: int = 4):
    """tf-idf scores over this rank's shard, the global top-k merge and the
    candidates' rows.  Mirrors `keyframe_db.db_query` +
    `detector.gather_rows` exactly.  Returns (scores (k,), slots (k,)
    int32, mask (k,), CandidateRows)."""
    Cd = db.valid.shape[0]
    my = axis.index
    df_local = torch.sum((db.gdesc > 0) & db.valid[:, None], dim=0)
    counts = axis.psum(torch.cat([torch.sum(db.valid).reshape(1), df_local]))
    n_valid, df = counts[0].to(torch.float32), counts[1:]
    idf = torch.log((1.0 + n_valid) / (1.0 + df.to(torch.float32)))
    bank = db.gdesc * idf[None, :]
    bank = bank / torch.clamp(torch.linalg.vector_norm(bank, dim=1, keepdim=True),
                              min=1e-6)
    qv = g * idf
    qv = qv / torch.clamp(torch.linalg.vector_norm(qv), min=1e-6)
    scores = bank @ qv                                           # (Cd,)
    old_enough = ((cur_seq - db.seq > cfg.search_gap)
                  & (cur_time - db.time > cfg.search_time))
    scores = torch.where(db.valid & old_enough, scores,
                         torch.full_like(scores, -1.0))
    loc_i = top_k_indices(scores, top_k)
    # candidate merge over the axis (the dist_knn pattern)
    all_s = axis.all_gather(scores[loc_i], 0, tiled=True)        # (D·k,)
    all_g = axis.all_gather(loc_i + my * Cd, 0, tiled=True)
    sel = top_k_indices(all_s, top_k)
    top_s, top_slot = all_s[sel], all_g[sel]
    own = top_slot // Cd == my
    lslot = torch.clamp(top_slot - my * Cd, 0, Cd - 1)
    words, layout = pack_words([getattr(db, f)[lslot] for f in _ROW_FIELDS])
    rows = dict(zip(_ROW_FIELDS, unpack_words(
        axis.psum(torch.where(own[:, None], words, torch.zeros_like(words))),
        layout)))
    rows["desc"] = unpack_bits(rows["desc"])
    return top_s, top_slot.to(torch.int32), top_s > -0.5, CandidateRows(**rows)


def sharded_db_add(db: KeyframeDB, codebook: torch.Tensor, count: int, axis,
                   **row) -> KeyframeDB:
    """Ring append of keyframe number `count` where only the owner of
    global slot count % C writes; every rank advances the count mirror.
    `row` is `keyframe_db.db_add`'s keyword arguments."""
    Cd = db.valid.shape[0]
    slot = count % (Cd * axis.size)
    if slot // Cd == axis.index:
        return db_add(db, codebook, count, slot=slot - axis.index * Cd, **row)
    db.count.fill_(count + 1)
    return db


def make_dist_process_fused(mesh: Mesh, detector, cfg: LoopConfig,
                            axis: str = "kf"):
    """The sharded drop-in for `LoopDetector.detect_add` (same signature:
    prep → detect → add, the DB sharded over `axis`).  Install it as
    `detector.detect_add` with `detector.db = put_db_sharded(...)`."""
    ax = mesh.axis(axis)

    def detect_add(image, cam, win_uv, win_norm, win_pts, win_mask, wpnp,
                   cam_pose, time: float, gumbel: torch.Tensor, lidar_pack=None):
        time = float(np.float32(time))
        kp_uv, kp_ok, desc, wdesc = detector.prep(image, win_uv, win_mask)
        kp_norm = cam.lift_to_normalized(kp_uv)
        g = global_descriptor(desc, kp_ok, detector.codebook)
        top_s, top_i, top_ok, rows = sharded_query_fetch(
            detector.db, g, detector.count, time, cfg, ax)
        gate = top_ok & (top_s > cfg.score_accept) & (top_s[0] > cfg.score_best_min)
        lidar = None if lidar_pack is None else (*lidar_pack, detector.lidar_cfg)
        res = verify_candidates(
            rows, top_s, top_i, gate, cfg, win_desc=wdesc, win_pts=win_pts,
            win_norm=win_norm, win_mask=win_mask, cur_pose=cam_pose,
            gumbel=gumbel, win_pnp_mask=wpnp, lidar=lidar)
        kw = dict(desc=desc, kp_norm=kp_norm, kp_mask=kp_ok, win_desc=wdesc,
                  win_pts=win_pts, win_norm=win_norm, win_mask=win_mask,
                  t=cam_pose.t, q=cam_pose.q, time=time)
        if lidar_pack is not None:
            kw.update(lidar_edge=lidar_pack[0], lidar_edge_mask=lidar_pack[1],
                      lidar_planar=lidar_pack[2], lidar_planar_mask=lidar_pack[3])
        detector.db = sharded_db_add(detector.db, detector.codebook,
                                     detector.count, ax, **kw)
        detector.count += 1
        return res

    return detect_add
