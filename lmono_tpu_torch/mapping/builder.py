"""Dense colored world map accumulation + PLY export.

Port of `lmono_tpu/mapping/builder.py`: per frame the LiDAR cloud is
projected through the live extrinsic into the image, depth-completed,
back-projected with colour, moved to the world and merged into a
fixed-capacity voxel-deduplicated colored bank; the bank is archived to
host memory when it fills, and the whole map exports to PLY.

The hash merge reuses the odometry bank's int32-wraparound voxel hash
(`ops/voxelmap.py:_hash_slots`), and contested slots go to the lowest point
index through `scatter_reduce` "amin", so the bank's slots equal the
reference's bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lmono_tpu_torch import default_device
from lmono_tpu_torch.camera.base import CameraModel
from lmono_tpu_torch.config import MappingConfig
from lmono_tpu_torch.mapping.depth import (backproject_colored, complete_depth,
                                           project_cloud)
from lmono_tpu_torch.ops.voxelmap import _hash_slots, _voxel_keys
from lmono_tpu_torch.parallel.mesh import all_gather_rows
from lmono_tpu_torch.utils.lie import Pose
from lmono_tpu_torch.utils.timing import read


class ColorMap(NamedTuple):
    points: torch.Tensor  # (C, 3) world
    colors: torch.Tensor  # (C, 3) in [0,1]
    mask: torch.Tensor    # (C,)

    @staticmethod
    def empty(capacity: int, device=None) -> "ColorMap":
        return ColorMap(
            points=torch.zeros((capacity, 3), device=device),
            colors=torch.zeros((capacity, 3), device=device),
            mask=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )


def colormap_update(cm: ColorMap, new_pts, new_colors, new_mask,
                    voxel: float, center) -> ColorMap:
    """Voxel-dedup merge of colored points (existing points win their voxel;
    the same compaction as `ops.voxelmap.bank_update`)."""
    cap = cm.points.shape[0]
    pts = torch.cat([cm.points, new_pts])
    cols = torch.cat([cm.colors, new_colors])
    mask = torch.cat([cm.mask, new_mask])

    sentinel = 2 ** 30
    keys = _voxel_keys(pts, voxel, center)
    keys = torch.where(mask, keys, torch.full_like(keys, sentinel))
    k_sorted, order = torch.sort(keys, stable=True)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=keys.device),
                       k_sorted[1:] != k_sorted[:-1]])
    keep = first & (k_sorted < sentinel)
    n = pts.shape[0]
    keep_orig = torch.zeros(n, dtype=torch.bool, device=keys.device)
    keep_orig[order] = keep
    rank = torch.cumsum(keep_orig, dim=0) - 1
    # slot n collects every dropped write and is cut off
    dest = torch.where(keep_orig, rank, torch.full_like(rank, n))
    out_p = pts.new_zeros((n + 1, 3))
    out_c = cols.new_zeros((n + 1, 3))
    out_p[dest] = pts
    out_c[dest] = cols
    out_m = torch.arange(n, device=keys.device) < torch.sum(keep_orig)
    return ColorMap(out_p[:cap], out_c[:cap], out_m[:cap])


def colormap_update_hash(cm: ColorMap, new_pts, new_colors, new_mask,
                         voxel: float, axis=None) -> ColorMap:
    """O(N) scatter merge: each voxel hashes to one bank slot (the scheme of
    `ops.voxelmap.bank_update_hash`).  Existing points win their voxel; hash
    collisions drop the newcomer; contested slots go to the lowest point
    index.

    axis: a mesh `Axis` sharding the global slot space as
    `bank_update_hash` does; the ranks' maps, concatenated, are the
    single-device map bit for bit."""
    C = cm.points.shape[0]
    if axis is None:
        slots = _hash_slots(new_pts, voxel, C)
    else:
        slots = _hash_slots(new_pts, voxel, C * axis.size)
        new_mask = new_mask & (slots // C == axis.index)
        slots = torch.clamp(slots - axis.index * C, 0, C - 1)
    write = new_mask & ~cm.mask[slots]
    n = new_pts.shape[0]
    dest = torch.where(write, slots, torch.full_like(slots, C))  # C: dropped
    winner = torch.full((C + 1,), n, dtype=torch.int64, device=slots.device)
    winner = winner.scatter_reduce(
        0, dest, torch.arange(n, device=slots.device), reduce="amin",
        include_self=True)[:C]
    won = winner < n
    widx = torch.clamp(winner, 0, n - 1)
    pts = torch.where(won[:, None], new_pts[widx], cm.points)
    cols = torch.where(won[:, None], new_colors[widx], cm.colors)
    return ColorMap(pts, cols, cm.mask | won)


def build_frame(points_laser: torch.Tensor, points_valid: torch.Tensor,
                image: torch.Tensor, T_CL: Pose, T_WC: Pose,
                cam: CameraModel, cfg: MappingConfig):
    """One mapping step: laser cloud + image + poses → world colored points.

    Returns (pts_w (P,3), colors (P,3), valid (P,), depth (H,W), mask)."""
    pts_cam = T_CL.apply(points_laser)
    depth, dmask = project_cloud(pts_cam, points_valid, cam,
                                 cfg.depth_min, cfg.depth_max)
    depth_f, fmask = complete_depth(depth, dmask, cfg)
    pts_c, colors, ok = backproject_colored(depth_f, fmask, image, cam, cfg)
    # height crop relative to the camera (camera y points down)
    keep = ok & (pts_c[:, 1] > -cfg.crop_height)
    return T_WC.apply(pts_c), colors, keep, depth_f, fmask


def _host_rows(cm: ColorMap):
    """The bank's valid (points, colors) as host arrays, None if empty."""
    idx = torch.nonzero(cm.mask).squeeze(1)
    if not idx.numel():
        return None
    return cm.points[idx].cpu().numpy(), cm.colors[idx].cpu().numpy()


class MapBuilder:
    """Host-side runner of the dense map on one device, the CUDA card
    unless another is named (`default_device`).

    Per-frame points merge into a bounded *active* bank; when it fills past
    `flush_frac` (or every `flush_every` frames) it is drained to a host
    archive, which `save_ply` writes out with the active rows.

    mesh: a `parallel.mesh.Mesh` whose "map" axis shards the active bank by
    slot range (`colormap_update_hash`'s `axis`); occupancy counts are
    psum'd, so every rank flushes at the same frame, and a flush or
    `save_ply` gathers the shards first, so the archive and the PLY hold
    the single-device map's points in its order.
    """

    # active colored bank: 24 MiB at 2^20 rows (points + colours, f32)
    ACTIVE_CAPACITY = 1 << 20

    def __init__(self, cam: CameraModel, cfg: MappingConfig, device=None,
                 mesh=None):
        self.cfg = cfg
        self.cam = cam
        self.device = default_device(device)
        self._use_hash = cfg.map_update == "hash"
        self.axis = None if mesh is None else mesh.axis("map")
        if self.axis is not None and not self._use_hash:
            raise ValueError("sharded mapping requires map_update='hash'")
        # the global capacity; a rank holds capacity / map_shards slots
        self.capacity = min(cfg.map_capacity, self.ACTIVE_CAPACITY)
        self._shards = 1 if self.axis is None else self.axis.size
        if self.capacity % self._shards:
            raise ValueError(f"active map capacity {self.capacity} % map shards "
                             f"{self._shards}")
        self.map = ColorMap.empty(self.capacity // self._shards, self.device)
        self._archive: list[tuple[np.ndarray, np.ndarray]] = []
        self._archived_n = 0
        self.frames = 0
        # occupancy count queued on an earlier check: (host copy, event)
        self._occ = None

    def _global_map(self) -> ColorMap:
        """The whole active bank (the shards gathered on a mesh)."""
        if self.axis is None:
            return self.map
        return all_gather_rows(self.axis, self.map)

    def _count(self) -> torch.Tensor:
        """Occupied slots of the whole active bank, a 0-d device tensor."""
        n = torch.sum(self.map.mask)
        return n if self.axis is None else self.axis.psum(n)

    def _flush_active(self) -> None:
        """Archive the active bank's valid rows to host memory and reset it.
        Reading the mask waits for every queued program, so this runs only
        when the bank is full."""
        rows = read(_host_rows, self._global_map())
        if rows is not None:
            self._archive.append(rows)
            self._archived_n += rows[0].shape[0]
        self.map = ColorMap.empty(self.map.points.shape[0], self.device)
        self._occ = None   # a queued count refers to the drained bank

    def _maybe_flush(self) -> None:
        """Occupancy-driven flush read one check late: the count queued on
        the previous check is long computed, and its copy waits only for its
        own event, not for the programs queued since."""
        if self.cfg.flush_every > 0:
            return
        if self._occ is not None:
            host, event = self._occ
            if event is not None:
                read(event.synchronize)
            if int(host) >= self.cfg.flush_frac * self.capacity:
                self._flush_active()
        count = self._count()
        if count.is_cuda:
            host = torch.empty((), dtype=count.dtype, pin_memory=True)
            host.copy_(count, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            self._occ = (host, event)
        else:
            self._occ = (count, None)

    def process(self, points_laser, points_valid, image, T_CL: Pose,
                T_WC: Pose) -> dict:
        """One frame: (N,3) laser points, (N,) validity, the image, the
        camera-from-laser extrinsic and the world-from-camera pose."""
        pts_w, colors, keep, depth, dmask = build_frame(
            points_laser, points_valid, image, T_CL, T_WC, self.cam, self.cfg)
        if self._use_hash:
            self.map = colormap_update_hash(self.map, pts_w, colors, keep,
                                            self.cfg.map_voxel, axis=self.axis)
        else:
            self.map = colormap_update(self.map, pts_w, colors, keep,
                                       self.cfg.map_voxel, T_WC.t)
        self.frames += 1
        if self.cfg.flush_every > 0:
            if self.frames % self.cfg.flush_every == 0:
                self._flush_active()
        elif self.frames % 16 == 0:
            self._maybe_flush()
        # a device count: reading it is the caller's sync to pay
        return {"depth": depth, "depth_mask": dmask,
                "n_points": self._archived_n + self._count()}

    def absorb_chunk(self, cmap: ColorMap, n_frames: int) -> None:
        """Adopt the active bank carried through `fused.system_chunk`.  In
        cadence mode flushes land on chunk boundaries; in occupancy mode the
        caller hands `flush_if_full` the chunk's `map_fill`, read with the
        chunk's keyframe flags."""
        prev = self.frames
        self.map = cmap
        self.frames += n_frames
        if self.cfg.flush_every > 0:
            if (self.frames // self.cfg.flush_every
                    > prev // self.cfg.flush_every):
                self._flush_active()

    def flush_if_full(self, n_points: int) -> None:
        """Occupancy-mode flush decision from an already-read count."""
        if self.cfg.flush_every > 0:
            return
        if n_points >= self.cfg.flush_frac * self.capacity:
            self._flush_active()

    @property
    def n_points(self) -> int:
        """Archived plus active points (reads the active mask back)."""
        return self._archived_n + int(self._count())

    def save_ply(self, path: str, write: bool = True) -> int:
        """Write the archive and the active bank; returns the point count.
        On a mesh every rank takes part in the gather, and the caller
        lets one of them write (`write`)."""
        cm = self._global_map()
        m = cm.mask.cpu().numpy()
        parts_p = [p for p, _ in self._archive] + [cm.points.cpu().numpy()[m]]
        parts_c = [c for _, c in self._archive] + [cm.colors.cpu().numpy()[m]]
        pts = np.concatenate(parts_p)
        cols = np.concatenate(parts_c)
        return write_ply(path, pts, cols) if write else len(pts)


def write_ply(path: str, pts: np.ndarray, cols: np.ndarray) -> int:
    """Binary little-endian PLY of (n,3) points and (n,3) colours in [0,1]."""
    pts = np.asarray(pts).astype("<f4")
    cols = (np.clip(np.asarray(cols), 0, 1) * 255).astype(np.uint8)
    n = len(pts)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    ).encode()
    rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    rec["xyz"] = pts
    rec["rgb"] = cols
    with open(path, "wb") as f:
        f.write(header)
        f.write(rec.tobytes())
    return n


def save_ply(path: str, cm: ColorMap) -> int:
    """Binary little-endian PLY export of a bank's masked rows."""
    m = cm.mask.cpu().numpy()
    return write_ply(path, cm.points.cpu().numpy()[m], cm.colors.cpu().numpy()[m])
