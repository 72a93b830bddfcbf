"""Curvature-based edge/planar feature extraction from LiDAR range images.

Port of `lmono_tpu/lidar/features.py`.  The scan is a fixed-shape (rings, W)
range image; curvature is a stencil along each ring, and per-sector feature
selection is an unrolled masked argmax with neighbour suppression, so the
outputs have fixed capacity and nothing depends on a point count.

Sharp (edge) features feed point-to-line residuals; flat (planar) features
feed point-to-plane residuals in `lmono_tpu_torch.lidar.registration`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lmono_tpu_torch.config import LidarConfig


class ScanFeatures(NamedTuple):
    """Fixed-capacity feature sets (masked)."""

    edge_points: torch.Tensor    # (max_edge, 3) sensor frame
    edge_mask: torch.Tensor      # (max_edge,) bool
    planar_points: torch.Tensor  # (max_planar, 3)
    planar_mask: torch.Tensor    # (max_planar,) bool


def _ring_roll(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Roll along the azimuth axis (axis 1; wrap-around is physical for
    360° scans)."""
    return torch.roll(x, shift, dims=1)


def compute_curvature(points: torch.Tensor, valid: torch.Tensor,
                      cfg: LidarConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """A-LOAM-style curvature per point along each ring.

    c_i = || Σ_{j∈±k} (p_j − p_i) ||² normalized by range².
    Returns (curvature (R,W), curv_valid (R,W)).
    """
    k = cfg.curvature_half_window
    diff_sum = torch.zeros_like(points)
    nvalid = torch.ones_like(valid)
    for s in range(1, k + 1):
        for sh in (s, -s):
            diff_sum = diff_sum + (_ring_roll(points, sh) - points)
            nvalid = nvalid & _ring_roll(valid, sh)
    r2 = torch.sum(points * points, dim=-1)
    c = torch.sum(diff_sum * diff_sum, dim=-1) / torch.clamp(r2, min=1e-6)
    return c, valid & nvalid


def occlusion_mask(ranges: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mask out points on occlusion boundaries and near-parallel surfaces
    (the classic LOAM 'unreliable point' filters)."""
    r_next = _ring_roll(ranges, -1)
    r_prev = _ring_roll(ranges, 1)
    v_next = _ring_roll(valid, -1)
    v_prev = _ring_roll(valid, 1)
    # occlusion: this point is the far side of a large range jump
    occ_self = ((ranges - r_next > 0.3) & v_next) | ((ranges - r_prev > 0.3) & v_prev)
    # near-parallel beam: both neighbour diffs large relative to range
    d_next = torch.abs(r_next - ranges)
    d_prev = torch.abs(r_prev - ranges)
    parallel = (d_next > 0.02 * ranges) & (d_prev > 0.02 * ranges)
    return valid & ~occ_self & ~parallel


def _select_topk_spaced(score: torch.Tensor, mask: torch.Tensor, k: int,
                        suppress: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Pick k spaced maxima per row of score (..., W) under mask.

    Returns (int64 indices (..., k), validity (..., k)); an invalid pick
    holds whatever index argmax gave.  Each pick suppresses ±suppress
    neighbours (circularly).  `torch.argmax` returns the first maximum, as
    `jnp.argmax` does, so ties pick the same column in both packages.
    """
    W = score.shape[-1]
    col = torch.arange(W, device=score.device).expand(score.shape)
    neg = torch.finfo(score.dtype).min
    s = torch.where(mask, score, torch.full_like(score, neg))
    picks = []
    pick_valid = []
    for _ in range(k):
        idx = torch.argmax(s, dim=-1)
        val = torch.gather(s, -1, idx[..., None])[..., 0]
        picks.append(idx)
        pick_valid.append(val > neg * 0.5)
        dist = torch.abs(col - idx[..., None])
        dist = torch.minimum(dist, W - dist)  # circular distance
        s = torch.where(dist <= suppress, torch.full_like(s, neg), s)
    return torch.stack(picks, dim=-1), torch.stack(pick_valid, dim=-1)


def extract_features(points: torch.Tensor, ranges: torch.Tensor,
                     valid: torch.Tensor, cfg: LidarConfig) -> ScanFeatures:
    """Full extraction: curvature → reliability filters → per-sector picks.

    points: (R, W, 3) sensor-frame; ranges: (R, W); valid: (R, W).
    """
    R, W = ranges.shape
    S = cfg.num_sectors
    if W % S != 0:
        raise ValueError(f"horiz_res {W} must be divisible by num_sectors {S}")
    Ws = W // S

    curv, curv_valid = compute_curvature(points, valid, cfg)
    reliable = occlusion_mask(ranges, valid) & curv_valid

    # sector view: (R, S, Ws)
    curv_s = curv.reshape(R, S, Ws)
    rel_s = reliable.reshape(R, S, Ws)

    # edges: largest curvature above threshold, spaced picks
    e_idx, e_ok = _select_topk_spaced(
        curv_s, rel_s & (curv_s > cfg.edge_curvature_min),
        cfg.edges_per_sector, cfg.curvature_half_window)
    # planars: smallest curvature below threshold
    p_idx, p_ok = _select_topk_spaced(
        -curv_s, rel_s & (curv_s < cfg.planar_curvature_max),
        cfg.planars_per_sector, cfg.curvature_half_window)

    pts_s = points.reshape(R, S, Ws, 3)

    def gather(idx, ok, cap):
        # idx: (R,S,k) sector-local cols → points (R,S,k,3)
        g = torch.gather(pts_s, 2, idx[..., None].expand(idx.shape + (3,)))
        flat_pts = g.reshape(-1, 3)
        flat_ok = ok.reshape(-1)
        n = flat_pts.shape[0]
        if n >= cap:
            return flat_pts[:cap], flat_ok[:cap]
        pad = cap - n
        return (torch.cat([flat_pts, flat_pts.new_zeros((pad, 3))]),
                torch.cat([flat_ok, flat_ok.new_zeros(pad)]))

    ep, em = gather(e_idx, e_ok, cfg.max_edge_features)
    pp, pm = gather(p_idx, p_ok, cfg.max_planar_features)
    return ScanFeatures(ep, em, pp, pm)
