"""Fixed-capacity keyframe database for place recognition.

Port of `lmono_tpu/loop/keyframe_db.py`: keyframes live in fixed tensors;
a query is one masked cosine matvec over the global-descriptor bank with
tf-idf weights, then the top 4.

`db_add` writes one ring slot in place: the host keeps the keyframe count
(`LoopDetector.count`), so the slot is a host index and nothing is read
back; `db.count` is its device mirror, kept for the converters.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lmono_tpu_torch.config import LoopConfig
from lmono_tpu_torch.loop.landmarks import top_k_indices
from lmono_tpu_torch.ops.brief import global_descriptor, pack_bits


class KeyframeDB(NamedTuple):
    gdesc: torch.Tensor       # (C, dim) global descriptors (L2-normalized)
    desc: torch.Tensor        # (C, K, B//8) bitpacked BRIEF descriptors
    kp_norm: torch.Tensor     # (C, K, 2) keypoint normalized coords
    kp_mask: torch.Tensor     # (C, K)
    win_desc: torch.Tensor    # (C, Kw, B//8) bitpacked window-landmark descs
    win_pts: torch.Tensor     # (C, Kw, 3) world 3D points of window landmarks
    win_norm: torch.Tensor    # (C, Kw, 2) their normalized obs in this keyframe
    win_mask: torch.Tensor    # (C, Kw)
    t: torch.Tensor           # (C, 3) keyframe pose (world-from-camera)
    q: torch.Tensor           # (C, 4)
    time: torch.Tensor        # (C,) timestamps
    seq: torch.Tensor         # (C,) global keyframe index
    valid: torch.Tensor       # (C,)
    count: torch.Tensor       # () int32 — keyframes added (device mirror)
    # LiDAR features in the keyframe's sensor frame (loop-edge refinement)
    lidar_edge: torch.Tensor       # (C, Ke, 3)
    lidar_edge_mask: torch.Tensor  # (C, Ke)
    lidar_planar: torch.Tensor     # (C, Kp, 3)
    lidar_planar_mask: torch.Tensor  # (C, Kp)

    @staticmethod
    def empty(cfg: LoopConfig, device=None) -> "KeyframeDB":
        C, K, Kw, B = (cfg.db_capacity, cfg.max_keypoints,
                       cfg.window_points, cfg.brief_bits)
        f32, b = dict(device=device), dict(dtype=torch.bool, device=device)
        return KeyframeDB(
            gdesc=torch.zeros((C, cfg.vocab_dim), **f32),
            # packed all-ones rows (= unpacked all +1, the masked filler)
            desc=torch.full((C, K, B // 8), 255, dtype=torch.uint8, device=device),
            kp_norm=torch.zeros((C, K, 2), **f32),
            kp_mask=torch.zeros((C, K), **b),
            win_desc=torch.full((C, Kw, B // 8), 255, dtype=torch.uint8,
                                device=device),
            win_pts=torch.zeros((C, Kw, 3), **f32),
            win_norm=torch.zeros((C, Kw, 2), **f32),
            win_mask=torch.zeros((C, Kw), **b),
            t=torch.zeros((C, 3), **f32),
            q=torch.tensor([1.0, 0, 0, 0], device=device).repeat(C, 1),
            time=torch.zeros((C,), **f32),
            seq=torch.zeros((C,), dtype=torch.int32, device=device),
            valid=torch.zeros((C,), **b),
            count=torch.zeros((), dtype=torch.int32, device=device),
            lidar_edge=torch.zeros((C, cfg.kf_edge_points, 3), **f32),
            lidar_edge_mask=torch.zeros((C, cfg.kf_edge_points), **b),
            lidar_planar=torch.zeros((C, cfg.kf_planar_points, 3), **f32),
            lidar_planar_mask=torch.zeros((C, cfg.kf_planar_points), **b),
        )


def db_add(db: KeyframeDB, codebook: torch.Tensor, count: int, *,
           desc, kp_norm, kp_mask, win_desc, win_pts, win_norm, win_mask,
           t, q, time: float, lidar_edge=None, lidar_edge_mask=None,
           lidar_planar=None, lidar_planar_mask=None,
           slot: int | None = None) -> KeyframeDB:
    """Write keyframe number `count` (the host's count of keyframes added
    so far) into ring slot count % C, in place, evicting the oldest at
    capacity.  `desc`/`win_desc` arrive unpacked (K, B) ±1 and are stored
    bitpacked.  `slot` overrides the slot (a sharded DB's local slot,
    `parallel/dist_loop.py`).  Returns `db`."""
    if slot is None:
        slot = count % db.valid.shape[0]
    db.gdesc[slot] = global_descriptor(desc, kp_mask, codebook)
    db.desc[slot] = pack_bits(desc)
    db.win_desc[slot] = pack_bits(win_desc)
    for name, v in (("kp_norm", kp_norm), ("kp_mask", kp_mask),
                    ("win_pts", win_pts), ("win_norm", win_norm),
                    ("win_mask", win_mask), ("t", t), ("q", q),
                    ("lidar_edge", lidar_edge),
                    ("lidar_edge_mask", lidar_edge_mask),
                    ("lidar_planar", lidar_planar),
                    ("lidar_planar_mask", lidar_planar_mask)):
        if v is not None:
            getattr(db, name)[slot] = v
    db.time[slot] = time
    db.seq[slot] = count
    db.valid[slot] = True
    db.count.fill_(count + 1)
    return db


def db_query(db: KeyframeDB, codebook: torch.Tensor, desc, kp_mask,
             cur_seq: int, cur_time: float, cfg: LoopConfig, top_k: int = 4):
    """tf-idf-weighted cosine scores against the bank, excluding the last
    `search_gap` keyframes and anything newer than `search_time` seconds
    before the query (reference `detectLoop`, LoopDetector.cc:167-260); idf
    comes from the live bank each query.

    Returns (scores (top_k,), slots (top_k,) int32, mask (top_k,)).
    """
    g = global_descriptor(desc, kp_mask, codebook)
    n_valid = torch.sum(db.valid).to(torch.float32)
    df = torch.sum((db.gdesc > 0) & db.valid[:, None], dim=0)       # (dim,)
    idf = torch.log((1.0 + n_valid) / (1.0 + df.to(torch.float32)))
    bank = db.gdesc * idf[None, :]
    bank = bank / torch.clamp(torch.linalg.vector_norm(bank, dim=1, keepdim=True),
                              min=1e-6)
    qv = g * idf
    qv = qv / torch.clamp(torch.linalg.vector_norm(qv), min=1e-6)
    scores = bank @ qv                                             # (C,)
    old_enough = ((cur_seq - db.seq > cfg.search_gap)
                  & (cur_time - db.time > cfg.search_time))
    scores = torch.where(db.valid & old_enough, scores,
                         torch.full_like(scores, -1.0))
    idx = top_k_indices(scores, top_k)
    top_s = scores[idx]
    return top_s, idx.to(torch.int32), top_s > -0.5
