"""Deterministic synthetic world simulator: ray-cast LiDAR and camera, in
PyTorch.

Port of `lmono_tpu/io/synthetic.py`: an analytic world of axis-aligned
building boxes, vertical poles and a ground plane, ray-cast exactly into a
per-ring range image or a pinhole camera image with a procedural texture,
plus the ground-truth circuit and figure-8 trajectories and, for scoring
feature tracks, where a pixel's scene point appears in another camera.
The scene comes from numpy's `RandomState`, so its arrays are bit-equal to
the JAX package's.  Scan noise comes from a `torch.Generator` (or an explicit
standard-normal tensor), since JAX keys cannot be replayed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from lmono_tpu_torch.config import CameraConfig, LidarConfig
from lmono_tpu_torch.ops.image import to_int32_xla
from lmono_tpu_torch.utils.lie import Pose, quat_mul, quat_rotate, so3_exp_quat

_BIG = 1e9


class Scene(NamedTuple):
    """Axis-aligned world geometry (fixed shapes; mask via validity flags)."""

    box_min: torch.Tensor      # (B, 3) lower corners
    box_max: torch.Tensor      # (B, 3) upper corners
    box_valid: torch.Tensor    # (B,) bool
    cyl_center: torch.Tensor   # (C, 2) x,y of vertical poles
    cyl_radius: torch.Tensor   # (C,)
    cyl_height: torch.Tensor   # (C,)
    cyl_valid: torch.Tensor    # (C,) bool
    ground_z: torch.Tensor     # () scalar


def make_city_scene(n_blocks: int = 24, n_poles: int = 40,
                    extent: float = 90.0, seed: int = 7,
                    device=None) -> Scene:
    """A deterministic 'city block' scene around a central circuit road."""
    rng = np.random.RandomState(seed)
    boxes_min, boxes_max = [], []
    # buildings on a grid, leaving a ring road free around radius ~ 28-40 m
    grid = np.arange(-extent, extent + 1, 30.0)
    for gx in grid:
        for gy in grid:
            r = np.hypot(gx, gy)
            if 22.0 < r < 46.0:   # keep the circuit road clear
                continue
            if r < 8.0:
                continue
            jx, jy = rng.uniform(-4, 4, 2)
            sx, sy = rng.uniform(6, 14, 2)
            sz = rng.uniform(6, 18)
            cx, cy = gx + jx, gy + jy
            boxes_min.append([cx - sx / 2, cy - sy / 2, 0.0])
            boxes_max.append([cx + sx / 2, cy + sy / 2, sz])
    boxes_min = np.array(boxes_min[:n_blocks], np.float32)
    boxes_max = np.array(boxes_max[:n_blocks], np.float32)
    nb = len(boxes_min)
    if nb < n_blocks:
        pad = n_blocks - nb
        boxes_min = np.concatenate([boxes_min, np.zeros((pad, 3), np.float32)])
        boxes_max = np.concatenate([boxes_max, np.zeros((pad, 3), np.float32)])
    box_valid = np.arange(n_blocks) < nb

    # poles along the ring road edges
    ang = rng.uniform(0, 2 * np.pi, n_poles)
    rad = rng.choice([24.0, 43.0], n_poles) + rng.uniform(-1, 1, n_poles)
    cyl_center = np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1).astype(np.float32)
    cyl_radius = rng.uniform(0.1, 0.25, n_poles).astype(np.float32)
    cyl_height = rng.uniform(3.0, 7.0, n_poles).astype(np.float32)

    def dev(a):
        return torch.as_tensor(a, device=device)

    return Scene(
        box_min=dev(boxes_min),
        box_max=dev(boxes_max),
        box_valid=dev(box_valid),
        cyl_center=dev(cyl_center),
        cyl_radius=dev(cyl_radius),
        cyl_height=dev(cyl_height),
        cyl_valid=torch.ones(n_poles, dtype=torch.bool, device=device),
        ground_z=torch.zeros((), dtype=torch.float32, device=device),
    )


# --------------------------------------------------------------------------
# Ray casting
# --------------------------------------------------------------------------

def _nonzero(x: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(torch.abs(x) < eps, torch.full_like(x, eps), x)


def _ray_ground(o, d, ground_z):
    """Ray-plane z=ground_z. o,d: (...,3). Returns t (...,) (_BIG if miss)."""
    dz = d[..., 2]
    t = (ground_z - o[..., 2]) / _nonzero(dz, 1e-9)
    return torch.where((t > 1e-3) & (dz < -1e-6), t, torch.full_like(t, _BIG))


def _ray_boxes(o, d, bmin, bmax, valid):
    """Slab-method ray-AABB. o,d: (...,3); boxes (B,3). Returns min t (...)."""
    o = o[..., None, :]
    d = d[..., None, :]
    inv = 1.0 / _nonzero(d, 1e-9)
    t0 = (bmin - o) * inv
    t1 = (bmax - o) * inv
    tnear = torch.amax(torch.minimum(t0, t1), dim=-1)
    tfar = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = (tnear <= tfar) & (tfar > 1e-3) & valid
    t = torch.where(tnear > 1e-3, tnear, tfar)   # inside a box → exit face
    return torch.amin(torch.where(hit, t, torch.full_like(t, _BIG)), dim=-1)


def _ray_cyls(o, d, center, radius, height, valid):
    """Vertical finite cylinders. Returns min t (...)."""
    ox = o[..., None, 0] - center[:, 0]
    oy = o[..., None, 1] - center[:, 1]
    dx = d[..., None, 0]
    dy = d[..., None, 1]
    a = dx * dx + dy * dy
    b = 2.0 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - radius * radius
    disc = b * b - 4 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    a_safe = torch.where(a < 1e-12, torch.full_like(a, 1e-12), a)
    t = (-b - sq) / (2 * a_safe)
    z = o[..., None, 2] + t * d[..., None, 2]
    hit = (disc > 0) & (t > 1e-3) & (z > 0.0) & (z < height) & valid
    return torch.amin(torch.where(hit, t, torch.full_like(t, _BIG)), dim=-1)


def ray_cast(scene: Scene, origins: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Closest-hit distance for rays (...,3)+(...,3) → (...)."""
    return torch.minimum(
        _ray_ground(origins, dirs, scene.ground_z),
        torch.minimum(
            _ray_boxes(origins, dirs, scene.box_min, scene.box_max,
                       scene.box_valid),
            _ray_cyls(origins, dirs, scene.cyl_center, scene.cyl_radius,
                      scene.cyl_height, scene.cyl_valid),
        ),
    )


# --------------------------------------------------------------------------
# Procedural intensity texture (viewpoint-consistent; smooth for LK)
# --------------------------------------------------------------------------

def _hash3(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor) -> torch.Tensor:
    """Integer lattice hash → [0,1) float, deterministic.

    The reference multiplies int32 lattice coordinates with wraparound and
    keeps the low 31 bits.  The products here are int64 (exact for any
    int32 input), and their low 31 bits are the same.
    """
    ix, iy, iz = ix.long(), iy.long(), iz.long()
    h = (ix * 374761393 + iy * 668265263 + iz * 2147483647) & 0x7FFFFFFF
    h = ((h ^ (h >> 13)) * 1274126177) & 0x7FFFFFFF
    return ((h ^ (h >> 16)) & 0xFFFF).to(torch.float32) / 65535.0


def value_noise3(p: torch.Tensor) -> torch.Tensor:
    """Trilinear value noise of 3D points (...,3) → (...), C1-smooth."""
    pf = torch.floor(p)
    ip = to_int32_xla(pf)
    f = p - pf
    f = f * f * (3.0 - 2.0 * f)  # smoothstep

    def corner(dx, dy, dz):
        return _hash3(ip[..., 0] + dx, ip[..., 1] + dy, ip[..., 2] + dz)

    c000, c100 = corner(0, 0, 0), corner(1, 0, 0)
    c010, c110 = corner(0, 1, 0), corner(1, 1, 0)
    c001, c101 = corner(0, 0, 1), corner(1, 0, 1)
    c011, c111 = corner(0, 1, 1), corner(1, 1, 1)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    x00 = c000 + fx * (c100 - c000)
    x10 = c010 + fx * (c110 - c010)
    x01 = c001 + fx * (c101 - c001)
    x11 = c011 + fx * (c111 - c011)
    y0 = x00 + fy * (x10 - x00)
    y1 = x01 + fy * (x11 - x01)
    return y0 + fz * (y1 - y0)


def world_intensity(p: torch.Tensor) -> torch.Tensor:
    """Multi-octave procedural albedo at world points (...,3) → [0,1]."""
    v = (0.55 * value_noise3(p * 0.9)
         + 0.3 * value_noise3(p * 3.7 + 11.3)
         + 0.15 * value_noise3(p * 13.1 + 71.7))
    return torch.clamp(v, 0.0, 1.0)


def world_color(p: torch.Tensor) -> torch.Tensor:
    """Procedural RGB at world points (...,3) → (...,3) in [0,1]."""
    r = world_intensity(p)
    g = world_intensity(p + 101.0)
    b = world_intensity(p + 202.0)
    return torch.stack([r, g, b], dim=-1)


# --------------------------------------------------------------------------
# Sensor
# --------------------------------------------------------------------------

def lidar_ray_dirs(cfg: LidarConfig, device=None) -> torch.Tensor:
    """Sensor-frame unit ray directions, (rings, horiz_res, 3).

    Sensor frame: x forward, y left, z up (velodyne convention).  The grids
    are f32 like the JAX package's, but may differ from `jnp.linspace` in
    the last ulp.
    """
    lo, hi = cfg.vertical_fov_deg
    elev = torch.deg2rad(torch.linspace(hi, lo, cfg.num_rings,
                                        dtype=torch.float32, device=device))
    azim = torch.linspace(-math.pi, math.pi, cfg.horiz_res + 1,
                          dtype=torch.float32, device=device)[:-1]
    ce, se = torch.cos(elev)[:, None], torch.sin(elev)[:, None]
    ca, sa = torch.cos(azim)[None, :], torch.sin(azim)[None, :]
    return torch.stack(
        [ce * ca, ce * sa, se.expand(cfg.num_rings, cfg.horiz_res)], dim=-1)


def simulate_lidar(scene: Scene, pose: Pose, cfg: LidarConfig,
                   noise_std: float = 0.01,
                   generator: torch.Generator | None = None,
                   noise: torch.Tensor | None = None) -> dict:
    """One LiDAR sweep from world-frame sensor `pose`.

    Range noise is `noise_std` times a standard-normal (rings, W) tensor:
    `noise` if given, else one drawn from `generator`; with neither, the
    sweep is noise-free.

    Returns dict with:
      ranges  (rings, W)   — measured range, 0 where invalid/out of range
      points  (rings, W, 3)— sensor-frame xyz (0 where invalid)
      valid   (rings, W)   — bool
    """
    device = pose.t.device
    dirs_s = lidar_ray_dirs(cfg, device)
    dirs_w = quat_rotate(pose.q[None, None, :], dirs_s)
    origin = pose.t.expand(dirs_w.shape)
    t = ray_cast(scene, origin, dirs_w)
    if noise is None and generator is not None:
        noise = torch.randn(t.shape, generator=generator, dtype=t.dtype,
                            device=device)
    if noise is not None and noise_std > 0:
        t = t + noise_std * noise
    valid = (t > cfg.min_range) & (t < cfg.max_range)
    ranges = torch.where(valid, t, torch.zeros_like(t))
    points = dirs_s * ranges[..., None]
    return {"ranges": ranges, "points": points, "valid": valid}


def camera_ray_dirs(cam: CameraConfig, device=None) -> torch.Tensor:
    """Camera-frame unit rays per pixel, (H, W, 3). z forward, x right, y
    down; pixel (u, v) is sampled at its centre (u + 0.5, v + 0.5)."""
    u = torch.arange(cam.width, dtype=torch.float32, device=device) + 0.5
    v = torch.arange(cam.height, dtype=torch.float32, device=device) + 0.5
    x = ((u[None, :] - cam.cx) / cam.fx).expand(cam.height, cam.width)
    y = ((v[:, None] - cam.cy) / cam.fy).expand(cam.height, cam.width)
    d = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def render_camera(scene: Scene, pose_wc: Pose, cam: CameraConfig,
                  rgb: bool = False) -> torch.Tensor:
    """Render a grayscale (H,W) [or RGB (H,W,3)] image from camera pose.

    pose_wc: world-from-camera.  Sky (no hit) renders as a horizon
    gradient.
    """
    dirs_c = camera_ray_dirs(cam, pose_wc.t.device)
    dirs_w = quat_rotate(pose_wc.q[None, None, :], dirs_c)
    origin = pose_wc.t.expand(dirs_w.shape)
    t = ray_cast(scene, origin, dirs_w)
    hit = t < (_BIG * 0.5)
    pts = origin + dirs_w * torch.where(hit, t, torch.ones_like(t))[..., None]
    # simple distance attenuation so far geometry is dimmer (adds gradient)
    atten = 1.0 / (1.0 + 0.004 * torch.where(hit, t, torch.zeros_like(t)))
    if rgb:
        albedo = world_color(pts)
        sky = torch.stack([0.7 + 0.2 * dirs_w[..., 2]] * 3, -1)
        img = torch.where(hit[..., None], albedo * atten[..., None], sky)
    else:
        albedo = world_intensity(pts)
        sky = 0.7 + 0.2 * dirs_w[..., 2]
        img = torch.where(hit, albedo * atten, sky)
    return torch.clamp(img, 0.0, 1.0)


def reproject_pixels(scene: Scene, pose_wc0: Pose, pose_wc1: Pose,
                     cam: CameraConfig, uv0: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Where the scene points seen at pixels uv0 (N,2) of camera 0 appear
    in camera 1: the ground truth of a feature track.

    A pixel's ray passes through its centre (u + 0.5, v + 0.5), as
    `render_camera` samples.  Returns (uv1 (N,2), ok (N,)): ok is false
    where the ray misses the scene or the point is behind camera 1
    (occlusion in camera 1 is not checked).
    """
    x = (uv0[:, 0] + 0.5 - cam.cx) / cam.fx
    y = (uv0[:, 1] + 0.5 - cam.cy) / cam.fy
    d = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    d = quat_rotate(pose_wc0.q, d / torch.linalg.norm(d, dim=-1, keepdim=True))
    origin = pose_wc0.t.expand(d.shape)
    t = ray_cast(scene, origin, d)
    hit = t < (_BIG * 0.5)
    p1 = pose_wc1.apply_inv(origin + d * torch.where(hit, t, 0.0)[:, None])
    z = p1[:, 2]
    safe_z = torch.where(z > 1e-6, z, 1.0)
    uv1 = torch.stack([cam.fx * p1[:, 0] / safe_z + cam.cx - 0.5,
                       cam.fy * p1[:, 1] / safe_z + cam.cy - 0.5], dim=-1)
    return uv1, hit & (z > 1e-6)


# --------------------------------------------------------------------------
# Trajectory and rig
# --------------------------------------------------------------------------

def circuit_trajectory(n_frames: int, radius: float = 32.0, dt: float = 0.1,
                       speed: float = 8.0, z: float = 1.7,
                       wobble: float = 0.15, device=None) -> Pose:
    """Ground-truth LiDAR-frame trajectory: a circuit with gentle wobble.

    Returns a batched Pose with leading dim n_frames.  The sensor x-axis
    points along the direction of travel (velodyne convention).
    """
    t = torch.arange(n_frames, dtype=torch.float32, device=device) * dt
    theta = speed * t / radius
    # wobble makes pitch/roll and z vary slightly → exercises full 6-DoF
    x = radius * torch.cos(theta)
    y = radius * torch.sin(theta)
    zz = z + wobble * torch.sin(3.1 * theta)
    pos = torch.stack([x, y, zz], dim=-1)
    yaw = theta + math.pi / 2.0
    pitch = wobble * 0.2 * torch.cos(3.1 * theta)
    roll = wobble * 0.15 * torch.sin(2.3 * theta)
    zero = torch.zeros_like(yaw)
    q_yaw = so3_exp_quat(torch.stack([zero, zero, yaw], -1))
    q_pitch = so3_exp_quat(torch.stack([zero, pitch, zero], -1))
    q_roll = so3_exp_quat(torch.stack([roll, zero, zero], -1))
    q = quat_mul(q_yaw, quat_mul(q_pitch, q_roll))
    return Pose(pos, q)


def figure8_trajectory(n_frames: int, radius: float = 26.0, dt: float = 0.1,
                       speed: float = 8.0, z: float = 1.7, tilt: float = 0.18,
                       device=None) -> Pose:
    """Rotation-rich ground truth: a figure-eight (Gerono lemniscate) with
    pitch/roll oscillation of ~10°, exciting all three rotation axes.

    Yaw-only motion (the circuit) leaves the hand-eye system AX = XB
    rank-deficient, so its σ₂ gate refuses it; the estimate_laser == 2
    presets are driven on this trajectory instead.
    """
    t = torch.arange(n_frames, dtype=torch.float32, device=device) * dt
    s = speed * t / radius
    # Gerono lemniscate; direction from the analytic derivative
    x = radius * torch.cos(s)
    y = radius * torch.sin(s) * torch.cos(s)
    dx = -radius * torch.sin(s)
    dy = radius * (torch.cos(s) ** 2 - torch.sin(s) ** 2)
    zz = z + 0.8 * torch.sin(1.7 * s)
    pos = torch.stack([x, y, zz], dim=-1)
    yaw = torch.atan2(dy, dx)
    pitch = tilt * torch.sin(2.3 * s)
    roll = tilt * 0.7 * torch.cos(1.9 * s)
    zero = torch.zeros_like(yaw)
    q_yaw = so3_exp_quat(torch.stack([zero, zero, yaw], -1))
    q_pitch = so3_exp_quat(torch.stack([zero, pitch, zero], -1))
    q_roll = so3_exp_quat(torch.stack([roll, zero, zero], -1))
    q = quat_mul(q_yaw, quat_mul(q_pitch, q_roll))
    return Pose(pos, q)


def synthetic_T_CL(device=None) -> Pose:
    """Camera-from-laser extrinsic of the synthetic rig: the camera looks
    forward (+x sensor), as on the KITTI mounting, with a small lever arm."""
    R = torch.tensor([
        [0.0, -1.0, 0.0],
        [0.0, 0.0, -1.0],
        [1.0, 0.0, 0.0],
    ], dtype=torch.float32, device=device)
    t = torch.tensor([0.06, -0.05, 0.27], dtype=torch.float32, device=device)
    return Pose.from_Rt(R, t)


# --------------------------------------------------------------------------
# A simulated drive written as a KITTI odometry tree
# --------------------------------------------------------------------------

def write_kitti_tree(root: str, lidar: LidarConfig, camera: CameraConfig,
                     n_frames: int, noise_std: float = 0.01,
                     generator: torch.Generator | None = None,
                     device=None, seq: int = 0):
    """Simulate `n_frames` along the circuit and write them in the KITTI
    odometry layout that `io/kitti.py` reads: `velodyne/*.bin` (x, y, z,
    intensity 0, f32; the valid points in ring-major order, as KITTI
    stores them laser by laser), `image_0/*.png` (the rig camera's render,
    8-bit gray, by the port's PNG encoder), `calib.txt` (P0..P3 from the
    camera, Tr = `synthetic_T_CL`), `times.txt` (10 Hz) and
    `poses/<seq>.txt` (the LiDAR-frame truth, 3×4 rows).

    Returns (trajectory, frame 0's simulated {ranges, valid} as numpy)."""
    import os

    from lmono_tpu_torch.io.png import write_png

    seq_dir = os.path.join(root, "sequences", f"{seq:02d}")
    velo, imgd = os.path.join(seq_dir, "velodyne"), os.path.join(seq_dir, "image_0")
    for d in (velo, imgd, os.path.join(root, "poses")):
        os.makedirs(d, exist_ok=True)
    scene = make_city_scene(device=device)
    traj = circuit_trajectory(n_frames, device=device)
    T_CL = synthetic_T_CL(device=device)
    T_LC = T_CL.inverse()
    first = None
    for i in range(n_frames):
        pose = Pose(traj.t[i], traj.q[i])
        scan = simulate_lidar(scene, pose, lidar, noise_std, generator=generator)
        valid = scan["valid"].reshape(-1)
        xyz = scan["points"].reshape(-1, 3)[valid]
        xyzi = torch.cat([xyz, torch.zeros_like(xyz[:, :1])], 1)
        xyzi.cpu().numpy().astype(np.float32).tofile(
            os.path.join(velo, f"{i:06d}.bin"))
        img = render_camera(scene, pose.compose(T_LC), camera)
        write_png(os.path.join(imgd, f"{i:06d}.png"),
                  (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8))
        if i == 0:
            first = {k: scan[k].cpu().numpy() for k in ("ranges", "valid")}
    np.savetxt(os.path.join(root, "poses", f"{seq:02d}.txt"),
               traj.to_mat4()[:, :3].reshape(n_frames, 12).cpu().numpy())
    P = (f"{camera.fx:.6e} 0 {camera.cx:.6e} 0 "
         f"0 {camera.fy:.6e} {camera.cy:.6e} 0 0 0 1 0")
    Tr = T_CL.to_mat4()[:3].reshape(-1).cpu().numpy()
    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        for k in ("P0", "P1", "P2", "P3"):
            f.write(f"{k}: {P}\n")
        f.write("Tr: " + " ".join(f"{v:.9e}" for v in Tr) + "\n")
    with open(os.path.join(seq_dir, "times.txt"), "w") as f:
        for i in range(n_frames):
            f.write(f"{i * 0.1:.6f}\n")
    return traj, first
