"""Fixed-capacity voxel-deduplicated point banks.

Port of `lmono_tpu/ops/voxelmap.py`.  The local map is a fixed-shape
(capacity, 3) masked array; updates are plain tensor ops with no host
interaction.  Both update paths give banks bit-equal to the JAX package's:
the integer keys are formed in int64 and masked to the bits the int32
reference keeps, so nothing depends on signed overflow, and JAX's
out-of-range scatters (`mode="drop"`) write into one padding slot past the
end that is then cut off.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PointBank(NamedTuple):
    points: torch.Tensor  # (capacity, 3) world frame
    mask: torch.Tensor    # (capacity,) bool

    @staticmethod
    def empty(capacity: int, dtype=torch.float32, device=None) -> "PointBank":
        return PointBank(torch.zeros((capacity, 3), dtype=dtype, device=device),
                         torch.zeros((capacity,), dtype=torch.bool, device=device))

    @property
    def capacity(self) -> int:
        return self.points.shape[0]


def _voxel_keys(pts: torch.Tensor, voxel: float,
                origin: torch.Tensor) -> torch.Tensor:
    """Exact packed voxel id: 10 bits per axis around `origin` (int64 values
    below 2^30).  Points outside the ±511-voxel cube clamp to the boundary
    cell; the radius gate evicts them anyway for sane voxel/radius configs.
    """
    ij = torch.floor((pts - origin) / voxel).to(torch.int64)
    ij = torch.clamp(ij + 512, 0, 1023)
    return (ij[:, 0] << 20) | (ij[:, 1] << 10) | ij[:, 2]


def bank_update(bank: PointBank, new_pts: torch.Tensor, new_mask: torch.Tensor,
                voxel: float, center: torch.Tensor,
                keep_radius: float) -> PointBank:
    """Merge new points into the bank with voxel dedup + radius eviction.

    Existing bank points win their voxel; the result is compacted to the
    front and truncated at capacity, preferring older points.
    """
    cap = bank.capacity
    pts = torch.cat([bank.points, new_pts], dim=0)
    mask = torch.cat([bank.mask, new_mask], dim=0)
    # radius eviction relative to the current pose
    d2 = torch.sum((pts - center) ** 2, dim=-1)
    mask = mask & (d2 < keep_radius * keep_radius)

    sentinel = 2 ** 30
    keys = _voxel_keys(pts, voxel, center)
    # invalid entries get a sentinel key that sorts last
    keys = torch.where(mask, keys, torch.full_like(keys, sentinel))
    # stable sort by key keeps bank-before-new within equal keys
    k_sorted, order = torch.sort(keys, stable=True)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=keys.device),
                       k_sorted[1:] != k_sorted[:-1]])
    keep = first & (k_sorted < sentinel)
    # map the keep decision back to original (age) order so that capacity
    # truncation drops the newest points, not a spatial chunk of key space
    n = pts.shape[0]
    keep_orig = torch.zeros(n, dtype=torch.bool, device=keys.device)
    keep_orig[order] = keep
    rank = torch.cumsum(keep_orig, dim=0) - 1
    dest = torch.where(keep_orig, rank, torch.full_like(rank, n))
    # slot n collects every dropped write and is cut off
    out_pts = pts.new_zeros((n + 1, 3))
    out_pts[dest] = pts
    n_keep = torch.sum(keep_orig)
    out_msk = torch.arange(n, device=keys.device) < n_keep
    return PointBank(out_pts[:cap], out_msk[:cap])


# --------------------------------------------------------------------------
# O(N) spatial-hash variant (the per-frame odometry map)
# --------------------------------------------------------------------------

_HP = (73856093, 19349663, 83492791)   # classic spatial-hash primes


def _hash_slots(pts: torch.Tensor, voxel: float, capacity: int) -> torch.Tensor:
    """World-stable voxel hash slot per point (no origin, no range limit).

    The reference multiplies int32 cells by the primes with wraparound,
    XORs, and keeps the low 31 bits.  The products here are int64 (exact
    for any int32 cell), and the low 31 bits of their XOR are the same.
    """
    ijk = torch.floor(pts / voxel).to(torch.int64)
    h = (ijk[:, 0] * _HP[0]) ^ (ijk[:, 1] * _HP[1]) ^ (ijk[:, 2] * _HP[2])
    return (h & 0x7FFFFFFF) % capacity


def bank_update_hash(bank: PointBank, new_pts: torch.Tensor,
                     new_mask: torch.Tensor, voxel: float,
                     center: torch.Tensor, keep_radius: float,
                     axis=None) -> PointBank:
    """O(N) scatter-based merge: each voxel hashes to one bank slot.

    Semantics vs `bank_update` (the sort-based exact dedup):
      * existing points still win their voxel (slot occupancy blocks writes);
      * hash collisions (different voxels, same slot) drop the newcomer;
      * contested slots (several new points, one slot, one frame) go to the
        lowest point index, deterministically;
      * point indices are stable across frames, and there is no compaction.

    axis: a mesh `Axis` (`parallel/mesh.py`) over which the global slot
    space of C·axis_size slots is sharded: this rank holds slots
    [my·C, (my+1)·C), `new_pts` is the whole (replicated) frame, and the
    rank keeps only the writes landing in its range.  The ranks' banks,
    concatenated, are the single-device bank bit for bit.
    """
    C = bank.capacity
    r2 = keep_radius * keep_radius
    d2 = torch.sum((bank.points - center) ** 2, dim=-1)
    mask = bank.mask & (d2 < r2)
    nd2 = torch.sum((new_pts - center) ** 2, dim=-1)
    new_mask = new_mask & (nd2 < r2)

    if axis is None:
        slots = _hash_slots(new_pts, voxel, C)
    else:
        slots = _hash_slots(new_pts, voxel, C * axis.size)
        my = axis.index
        new_mask = new_mask & (slots // C == my)
        slots = torch.clamp(slots - my * C, 0, C - 1)
    occupied = mask[slots]
    write = new_mask & ~occupied
    n = new_pts.shape[0]
    dest = torch.where(write, slots, torch.full_like(slots, C))  # C: dropped
    winner = torch.full((C + 1,), n, dtype=torch.int64, device=slots.device)
    winner = winner.scatter_reduce(
        0, dest, torch.arange(n, device=slots.device), reduce="amin",
        include_self=True)[:C]
    won = winner < n
    widx = torch.clamp(winner, 0, n - 1)
    pts = torch.where(won[:, None], new_pts[widx], bank.points)
    return PointBank(pts, mask | won)
