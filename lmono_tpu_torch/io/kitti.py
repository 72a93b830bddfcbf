"""KITTI odometry dataset loaders (velodyne .bin, images, calib, poses).

The port's copy of `lmono_tpu/io/kitti.py`: numpy on the host with the same
arithmetic line for line, so range images are bit-equal to the reference's.
PNGs are decoded by the port's own codec (`lmono_tpu_torch.io.png`), which
returns what the reference's PIL reader returns; ground-truth poses are a
`Pose` of f32 CPU tensors.

In place of replaying rosbags through ROS topics (A-LOAM's `kitti_helper`),
frames are read straight from the KITTI odometry layout:

    <root>/sequences/<seq>/velodyne/000000.bin   (Nx4 float32 x,y,z,intensity)
    <root>/sequences/<seq>/image_0/000000.png    (grayscale left)
    <root>/sequences/<seq>/calib.txt             (P0..P3, Tr)
    <root>/sequences/<seq>/times.txt
    <root>/poses/<seq>.txt                       (ground truth, 3x4 row-major)

Scans are re-gridded into the fixed (rings, horiz_res) range-image layout the
rest of the engine consumes (`lmono_tpu_torch.lidar.features`), with ring
indices recovered from the scan order or the HDL-64 elevation model.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

import torch

from lmono_tpu_torch.config import LidarConfig
from lmono_tpu_torch.io.png import read_png
from lmono_tpu_torch.utils.lie import Pose


def read_velodyne_bin(path: str) -> np.ndarray:
    """Raw Nx4 (x, y, z, intensity) float32 point cloud."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


# HDL-64E S2 vertical layout: two 32-laser blocks with DIFFERENT angular
# spacing — upper block ≈ +2.0°…−8.33° at 1/3° steps, lower block ≈
# −8.83°…−24.33° at 1/2° steps.  A uniform elevation→ring map mis-assigns
# nearly every lower-block point (what A-LOAM's scanRegistration handles for
# the reference via its per-model branches).
HDL64_UPPER_TOP_DEG = 2.0
HDL64_UPPER_STEP_DEG = 1.0 / 3.0
HDL64_LOWER_TOP_DEG = -8.83
HDL64_LOWER_STEP_DEG = 0.5
HDL64_BLOCK_SPLIT_DEG = -8.58       # midpoint between the two blocks


def hdl64_ring_from_elevation(elev_rad: np.ndarray) -> np.ndarray:
    """Two-block HDL-64E ring index (0 = topmost) from elevation angles."""
    deg = np.rad2deg(elev_rad)
    upper = np.round((HDL64_UPPER_TOP_DEG - deg) / HDL64_UPPER_STEP_DEG)
    lower = 32 + np.round((HDL64_LOWER_TOP_DEG - deg) / HDL64_LOWER_STEP_DEG)
    ring = np.where(deg > HDL64_BLOCK_SPLIT_DEG, upper, lower)
    return np.clip(ring, 0, 63).astype(np.int64)


def recover_rings_scanorder(xyz: np.ndarray, num_rings: int = 64
                            ) -> Optional[np.ndarray]:
    """Ring indices from the .bin's native per-ring point ordering.

    KITTI velodyne files store points laser-by-laser (top ring first), each
    ring sweeping a full azimuth circle; ring boundaries show up as a large
    backward azimuth jump.  This is exact regardless of the elevation
    calibration.  Returns None if the detected ring count is implausible
    (file not in native order) — callers then fall back to the elevation
    model."""
    azim = np.arctan2(xyz[:, 1], xyz[:, 0])
    # unwrapped forward progress resets by ~2π at each ring boundary
    d = np.diff(azim)
    # KITTI scans sweep clockwise (azimuth decreasing); a new ring restarts
    # the sweep with a jump of ≈ +2π (or −2π for ccw storage) — detect both
    jump = np.abs(d) > np.pi
    boundaries = np.flatnonzero(jump) + 1
    n_rings = len(boundaries) + 1
    if not (0.8 * num_rings <= n_rings <= 1.5 * num_rings):
        return None
    ring = np.zeros(len(xyz), np.int64)
    ring[boundaries] = 1
    ring = np.cumsum(ring)
    if n_rings > num_rings:
        # merge spurious splits (a ring broken by a mid-sweep gap): keep the
        # first num_rings boundaries ranked by segment length
        seg_len = np.diff(np.concatenate([[0], boundaries, [len(xyz)]]))
        order = np.argsort(seg_len)[: n_rings - num_rings]
        drop = np.sort(order)
        keep_mask = np.ones(n_rings, bool)
        keep_mask[drop] = False
        remap = np.cumsum(keep_mask) - 1
        ring = remap[ring]
    return np.clip(ring, 0, num_rings - 1)


def scan_to_range_image(xyz: np.ndarray, cfg: LidarConfig,
                        ring_mode: str = "auto") -> dict:
    """Project a raw scan into the fixed (rings, W) grid (numpy, host-side).

    ring_mode:
      "auto"    — recover rings from the .bin's native scan order (exact);
                  fall back to the hdl64 two-block model, then uniform.
      "hdl64"   — two-block HDL-64E elevation model.
      "uniform" — uniform elevation split over cfg.vertical_fov_deg
                  (synthetic scans).
    Column from azimuth; nearest point wins per cell.
    """
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    r = np.sqrt(x * x + y * y + z * z)

    ring_full = None
    if ring_mode == "auto" and cfg.num_rings == 64:
        ring_full = recover_rings_scanorder(xyz, cfg.num_rings)
    ok = (r > cfg.min_range) & (r < cfg.max_range)
    x, y, z, r = x[ok], y[ok], z[ok], r[ok]
    elev = np.arcsin(np.clip(z / np.maximum(r, 1e-6), -1, 1))
    if ring_full is not None:
        ring = ring_full[ok]
    elif (ring_mode in ("auto", "hdl64")) and cfg.num_rings == 64:
        ring = hdl64_ring_from_elevation(elev)
    else:
        lo = np.deg2rad(cfg.vertical_fov_deg[0])
        hi = np.deg2rad(cfg.vertical_fov_deg[1])
        ring = np.round(
            (hi - elev) / (hi - lo) * (cfg.num_rings - 1)).astype(np.int64)
    azim = np.arctan2(y, x)
    # centered binning (round, not floor): cell k is centered on the ray
    # grid's azimuth_k, so exact grid points survive the atan2 roundtrip
    col = np.round((azim + np.pi) / (2 * np.pi) * cfg.horiz_res).astype(
        np.int64) % cfg.horiz_res
    keep = (ring >= 0) & (ring < cfg.num_rings)
    ring, col, r = ring[keep], col[keep], r[keep]
    pts = np.stack([x[keep], y[keep], z[keep]], -1)

    ranges = np.zeros((cfg.num_rings, cfg.horiz_res), np.float32)
    points = np.zeros((cfg.num_rings, cfg.horiz_res, 3), np.float32)
    # nearest point per cell: sort by descending range so closest writes last
    order = np.argsort(-r)
    ri, ci, rr, pp = ring[order], col[order], r[order], pts[order]
    ranges[ri, ci] = rr
    points[ri, ci] = pp
    valid = ranges > 0
    return {"ranges": ranges, "points": points, "valid": valid}


def read_calib(path: str) -> dict:
    """Parse calib.txt → dict of 3x4 matrices (P0..P3, Tr)."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            vals = np.array([float(t) for t in v.split()], np.float64)
            out[k.strip()] = vals.reshape(3, 4)
    return out


def config_from_calib(calib: dict, base=None):
    """SystemConfig with camera intrinsics from P0 and T_CL from Tr.

    Replaces the reference's hand-copied per-sequence YAML calib blocks
    (`mono_lidar_mapping/config/kitti_config_{00..08}.yaml`): `P0 = K[I|0]`
    gives the gray-left intrinsics, `Tr` is exactly the camera0-from-
    velodyne transform the reference calls `laser_to_camera0`."""
    import dataclasses

    from lmono_tpu_torch.config import kitti_config

    base = base or kitti_config()
    P0 = calib["P0"]
    cam = dataclasses.replace(
        base.camera, fx=float(P0[0, 0]), fy=float(P0[1, 1]),
        cx=float(P0[0, 2]), cy=float(P0[1, 2]))
    cfg = base.replace(camera=cam)
    if "Tr" in calib:
        T = np.eye(4)
        T[:3, :] = calib["Tr"]
        cfg = cfg.replace(laser_to_camera=tuple(float(v)
                                                for v in T.reshape(-1)))
    return cfg


def read_poses(path: str) -> Pose:
    """KITTI ground-truth poses file → batched Pose (camera-0 frame)."""
    data = np.loadtxt(path).reshape(-1, 3, 4)
    mats = np.concatenate(
        [data, np.tile(np.array([[[0, 0, 0, 1.0]]]), (len(data), 1, 1))], axis=1)
    return Pose.from_mat4(torch.tensor(mats, dtype=torch.float32))


class KittiSequence:
    """Frame iterator over one KITTI odometry sequence."""

    def __init__(self, root: str, sequence: int, cfg: Optional[LidarConfig] = None):
        self.cfg = cfg or LidarConfig()
        self.sequence = sequence
        seq = f"{sequence:02d}"
        self.seq_dir = os.path.join(root, "sequences", seq)
        self.velo_dir = os.path.join(self.seq_dir, "velodyne")
        self.img_dir = os.path.join(self.seq_dir, "image_0")
        self.calib = read_calib(os.path.join(self.seq_dir, "calib.txt"))
        times_path = os.path.join(self.seq_dir, "times.txt")
        self.times = (np.loadtxt(times_path).astype(np.float64)
                      if os.path.exists(times_path) else None)
        pose_path = os.path.join(root, "poses", seq + ".txt")
        self.gt_poses = read_poses(pose_path) if os.path.exists(pose_path) else None
        self.n_frames = len(
            [f for f in os.listdir(self.velo_dir) if f.endswith(".bin")]
        ) if os.path.isdir(self.velo_dir) else 0

    def image(self, i: int):
        """Grayscale left image (H, W) in [0,1], or None if the file is
        missing; a PNG the codec cannot decode raises `PngError`."""
        img_path = os.path.join(self.img_dir, f"{i:06d}.png")
        if os.path.exists(img_path):
            return read_png(img_path)
        return None

    def system_config(self, base=None):
        """SystemConfig for this sequence: the reference's per-sequence knob
        deltas (`config._KITTI_SEQ_DELTAS`, from `kitti_config_{00..08}.yaml`)
        + calibration from the sequence's own calib.txt (+ image size from
        frame 0) — zero hand-entered calibration."""
        import dataclasses

        from lmono_tpu_torch.config import kitti_config

        base = base or kitti_config(self.sequence)
        cfg = config_from_calib(self.calib, base)
        img = self.image(0)
        if img is not None:
            cfg = cfg.replace(camera=dataclasses.replace(
                cfg.camera, height=int(img.shape[0]), width=int(img.shape[1])))
        return cfg

    def time(self, i: int) -> float:
        return float(self.times[i]) if self.times is not None else i * 0.1

    def frame(self, i: int) -> dict:
        scan = scan_to_range_image(
            read_velodyne_bin(os.path.join(self.velo_dir, f"{i:06d}.bin"))[:, :3],
            self.cfg,
        )
        out = {"index": i, "scan": scan,
               "time": float(self.times[i]) if self.times is not None else i * 0.1}
        img = self.image(i)
        if img is not None:
            out["image"] = img
        return out

    def __len__(self) -> int:
        return self.n_frames

    def __iter__(self) -> Iterator[dict]:
        for i in range(self.n_frames):
            yield self.frame(i)
