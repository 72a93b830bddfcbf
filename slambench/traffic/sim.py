"""The benchmark's frozen simulator: the city scene, the LiDAR ray cast, the
camera render, the circuit and the rig's camera-from-laser extrinsic.

A plain-torch copy of `lmono_tpu_torch/io/synthetic.py` (the functions of
the same names) that imports nothing of the port, so that the frames a run
feeds the port and the truth its outputs are judged against come from code
that no later change of the program can move.  Two changes:

* `circuit_pose` takes the circuit's speed from the lap length, so that one
  lap is `lap_frames` frames exactly (250 at 10 Hz: 2π·32 m / 25 s), and
  the pose of frame i is a function of i alone;
* every function takes its arithmetic's dtype from its inputs (the control
  of `correct` runs the same code in bfloat16), and the lattice hash of the
  texture takes `torch.floor` where the port takes an XLA-rule int cast
  (the same integers for every finite coordinate).

Quaternions are Hamilton (w, x, y, z); a pose (t, q) maps body to world.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_BIG = 1e9


# --------------------------------------------------------------------------
# Quaternions and poses
# --------------------------------------------------------------------------

def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], -1)


def quat_mul(a, b):
    a, b = torch.broadcast_tensors(a, b)
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def quat_rotate(q, v):
    qw, qv = q[..., :1], q[..., 1:]
    t = 2.0 * _cross(qv, v)
    return v + qw * t + _cross(qv, t)


def quat_from_axis_angle(theta):
    """Axis-angle (..., 3) → unit quaternion."""
    angle = torch.sqrt(torch.sum(theta * theta, -1, keepdim=True) + 1e-16)
    k = torch.sin(0.5 * angle) / angle
    return torch.cat([torch.cos(0.5 * angle), k * theta], -1)


def quat_from_mat(R):
    """3×3 rotation (float64 numpy) → unit quaternion (w, x, y, z)."""
    w = math.sqrt(max(1e-12, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
    if w > 0.1:
        return np.array([w, (R[2, 1] - R[1, 2]) / (4 * w),
                         (R[0, 2] - R[2, 0]) / (4 * w), (R[1, 0] - R[0, 1]) / (4 * w)])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = math.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k]) * 2.0
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = s / 4.0
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def compose(a, b):
    """(ta, qa) ∘ (tb, qb)."""
    return a[0] + quat_rotate(a[1], b[0]), quat_mul(a[1], b[1])


def inverse(a):
    qi = quat_conj(a[1])
    return -quat_rotate(qi, a[0]), qi


def relative(a, b):
    """a⁻¹ ∘ b: pose b seen from pose a."""
    return compose(inverse(a), b)


def apply(a, p):
    return quat_rotate(a[1], p) + a[0]


def apply_inv(a, p):
    return quat_rotate(quat_conj(a[1]), p - a[0])


# --------------------------------------------------------------------------
# Scene and ray casting
# --------------------------------------------------------------------------

def make_city_scene(n_blocks: int = 24, n_poles: int = 40, extent: float = 90.0,
                    seed: int = 7, device=None, dtype=torch.float32) -> dict:
    """The 'city block' scene around the circuit road (numpy RandomState, so
    the same arrays as the port's simulator)."""
    rng = np.random.RandomState(seed)
    boxes_min, boxes_max = [], []
    grid = np.arange(-extent, extent + 1, 30.0)
    for gx in grid:
        for gy in grid:
            r = np.hypot(gx, gy)
            if 22.0 < r < 46.0:
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
        pad = np.zeros((n_blocks - nb, 3), np.float32)
        boxes_min = np.concatenate([boxes_min, pad])
        boxes_max = np.concatenate([boxes_max, pad])
    ang = rng.uniform(0, 2 * np.pi, n_poles)
    rad = rng.choice([24.0, 43.0], n_poles) + rng.uniform(-1, 1, n_poles)
    cyl_center = np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1).astype(np.float32)
    cyl_radius = rng.uniform(0.1, 0.25, n_poles).astype(np.float32)
    cyl_height = rng.uniform(3.0, 7.0, n_poles).astype(np.float32)

    def dev(a):
        return torch.as_tensor(a, device=device).to(dtype)

    return {"box_min": dev(boxes_min), "box_max": dev(boxes_max),
            "box_valid": torch.as_tensor(np.arange(n_blocks) < nb, device=device),
            "cyl_center": dev(cyl_center), "cyl_radius": dev(cyl_radius),
            "cyl_height": dev(cyl_height),
            "cyl_valid": torch.ones(n_poles, dtype=torch.bool, device=device)}


def _nonzero(x, eps):
    return torch.where(torch.abs(x) < eps, torch.full_like(x, eps), x)


def ray_cast(scene: dict, o, d):
    """Closest-hit distance of rays o + s·d (..., 3) → (...), _BIG on a miss."""
    big = torch.full_like(o[..., 0], _BIG)
    dz = d[..., 2]
    t_g = -o[..., 2] / _nonzero(dz, 1e-9)
    t_g = torch.where((t_g > 1e-3) & (dz < -1e-6), t_g, big)
    # slab method against the boxes
    ob, db = o[..., None, :], d[..., None, :]
    inv = 1.0 / _nonzero(db, 1e-9)
    t0 = (scene["box_min"] - ob) * inv
    t1 = (scene["box_max"] - ob) * inv
    tnear = torch.amax(torch.minimum(t0, t1), -1)
    tfar = torch.amin(torch.maximum(t0, t1), -1)
    hit = (tnear <= tfar) & (tfar > 1e-3) & scene["box_valid"]
    t = torch.where(tnear > 1e-3, tnear, tfar)
    t_b = torch.amin(torch.where(hit, t, torch.full_like(t, _BIG)), -1)
    # vertical poles
    cc = scene["cyl_center"]
    ox, oy = o[..., None, 0] - cc[:, 0], o[..., None, 1] - cc[:, 1]
    dx, dy = d[..., None, 0], d[..., None, 1]
    a = dx * dx + dy * dy
    b = 2.0 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - scene["cyl_radius"] ** 2
    disc = b * b - 4 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    a_safe = torch.where(a < 1e-12, torch.full_like(a, 1e-12), a)
    t = (-b - sq) / (2 * a_safe)
    z = o[..., None, 2] + t * d[..., None, 2]
    hit = ((disc > 0) & (t > 1e-3) & (z > 0.0) & (z < scene["cyl_height"])
           & scene["cyl_valid"])
    t_c = torch.amin(torch.where(hit, t, torch.full_like(t, _BIG)), -1)
    return torch.minimum(t_g, torch.minimum(t_b, t_c))


# --------------------------------------------------------------------------
# Texture
# --------------------------------------------------------------------------

def _hash3(ix, iy, iz):
    h = (ix * 374761393 + iy * 668265263 + iz * 2147483647) & 0x7FFFFFFF
    h = ((h ^ (h >> 13)) * 1274126177) & 0x7FFFFFFF
    return ((h ^ (h >> 16)) & 0xFFFF).to(torch.float32) / 65535.0


def _value_noise3(p):
    pf = torch.floor(p)
    ip = pf.to(torch.int64)
    f = (p - pf).to(torch.float32)
    f = f * f * (3.0 - 2.0 * f)

    def corner(dx, dy, dz):
        return _hash3(ip[..., 0] + dx, ip[..., 1] + dy, ip[..., 2] + dz)

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c000, c100, c010, c110 = corner(0, 0, 0), corner(1, 0, 0), corner(0, 1, 0), corner(1, 1, 0)
    c001, c101, c011, c111 = corner(0, 0, 1), corner(1, 0, 1), corner(0, 1, 1), corner(1, 1, 1)
    x00 = c000 + fx * (c100 - c000)
    x10 = c010 + fx * (c110 - c010)
    x01 = c001 + fx * (c101 - c001)
    x11 = c011 + fx * (c111 - c011)
    y0 = x00 + fy * (x10 - x00)
    y1 = x01 + fy * (x11 - x01)
    return y0 + fz * (y1 - y0)


def _intensity(p):
    v = (0.55 * _value_noise3(p * 0.9) + 0.3 * _value_noise3(p * 3.7 + 11.3)
         + 0.15 * _value_noise3(p * 13.1 + 71.7))
    return torch.clamp(v, 0.0, 1.0)


# --------------------------------------------------------------------------
# Sensors
# --------------------------------------------------------------------------

def lidar_ray_dirs(rings: int, cols: int, fov_deg, device=None, dtype=torch.float32):
    """Sensor-frame unit rays (rings, cols, 3): x forward, y left, z up."""
    lo, hi = fov_deg
    elev = torch.deg2rad(torch.linspace(hi, lo, rings, dtype=torch.float32, device=device))
    azim = torch.linspace(-math.pi, math.pi, cols + 1, dtype=torch.float32,
                          device=device)[:-1]
    ce, se = torch.cos(elev)[:, None], torch.sin(elev)[:, None]
    ca, sa = torch.cos(azim)[None, :], torch.sin(azim)[None, :]
    return torch.stack([ce * ca, ce * sa, se.expand(rings, cols)], -1).to(dtype)


def simulate_lidar(scene: dict, pose, dirs_s, min_range: float, max_range: float,
                   noise: torch.Tensor | None = None, noise_std: float = 0.0) -> dict:
    """One sweep from world-frame sensor `pose` (t, q): ranges, sensor-frame
    points and validity, with `noise_std` × `noise` added to each range."""
    dirs_w = quat_rotate(pose[1][None, None, :], dirs_s)
    t = ray_cast(scene, pose[0].expand(dirs_w.shape), dirs_w)
    if noise is not None and noise_std > 0:
        t = t + noise_std * noise
    valid = (t > min_range) & (t < max_range)
    ranges = torch.where(valid, t, torch.zeros_like(t))
    return {"points": dirs_s * ranges[..., None], "ranges": ranges, "valid": valid}


def camera_ray_dirs(cam: dict, device=None, dtype=torch.float32):
    """Camera-frame unit rays per pixel centre (H, W, 3): z forward, y down."""
    u = torch.arange(cam["width"], dtype=torch.float32, device=device) + 0.5
    v = torch.arange(cam["height"], dtype=torch.float32, device=device) + 0.5
    x = ((u[None, :] - cam["cx"]) / cam["fx"]).expand(cam["height"], cam["width"])
    y = ((v[:, None] - cam["cy"]) / cam["fy"]).expand(cam["height"], cam["width"])
    d = torch.stack([x, y, torch.ones_like(x)], -1)
    return (d / torch.linalg.norm(d, dim=-1, keepdim=True)).to(dtype)


def render_camera(scene: dict, pose_wc, dirs_c):
    """Grey render (H, W) in [0, 1] and the z depth of each pixel's hit (0 on
    a miss) from world-from-camera `pose_wc`."""
    dirs_w = quat_rotate(pose_wc[1][None, None, :], dirs_c)
    origin = pose_wc[0].expand(dirs_w.shape)
    t = ray_cast(scene, origin, dirs_w)
    hit = t < _BIG * 0.5
    pts = origin + dirs_w * torch.where(hit, t, torch.ones_like(t))[..., None]
    atten = 1.0 / (1.0 + 0.004 * torch.where(hit, t, torch.zeros_like(t)))
    sky = 0.7 + 0.2 * dirs_w[..., 2]
    img = torch.where(hit, _intensity(pts) * atten, sky)
    depth = torch.where(hit, t * dirs_c[..., 2], torch.zeros_like(t))
    return torch.clamp(img, 0.0, 1.0).to(torch.float32), depth


def reproject_pixels(scene: dict, pose_wc0, pose_wc1, cam: dict, uv0):
    """Where the scene points seen at pixels uv0 (N, 2) of camera 0 appear in
    camera 1 (pixel centres at +0.5, as the render samples); (uv1, ok)."""
    x = (uv0[:, 0] + 0.5 - cam["cx"]) / cam["fx"]
    y = (uv0[:, 1] + 0.5 - cam["cy"]) / cam["fy"]
    d = torch.stack([x, y, torch.ones_like(x)], -1)
    d = quat_rotate(pose_wc0[1], d / torch.linalg.norm(d, dim=-1, keepdim=True))
    origin = pose_wc0[0].expand(d.shape)
    t = ray_cast(scene, origin, d)
    hit = t < _BIG * 0.5
    p1 = apply_inv(pose_wc1, origin + d * torch.where(hit, t, torch.zeros_like(t))[:, None])
    z = p1[:, 2]
    safe_z = torch.where(z > 1e-6, z, torch.ones_like(z))
    uv1 = torch.stack([cam["fx"] * p1[:, 0] / safe_z + cam["cx"] - 0.5,
                       cam["fy"] * p1[:, 1] / safe_z + cam["cy"] - 0.5], -1)
    return uv1, hit & (z > 1e-6)


# --------------------------------------------------------------------------
# Trajectory and rig
# --------------------------------------------------------------------------

def circuit_pose(idx: torch.Tensor, lap_frames: int, radius: float, height: float,
                 wobble: float, dt: float = 0.1, dtype=torch.float32):
    """Laser poses of frames `idx` on the circuit: one lap in `lap_frames`
    frames, the sensor's x axis along the road, a gentle wobble in height,
    pitch and roll (the port's `circuit_trajectory` at the lap's speed)."""
    t = idx.to(dtype) * dt
    speed = 2.0 * math.pi * radius / (lap_frames * dt)
    theta = speed * t / radius
    pos = torch.stack([radius * torch.cos(theta), radius * torch.sin(theta),
                       height + wobble * torch.sin(3.1 * theta)], -1)
    yaw = theta + math.pi / 2.0
    pitch = wobble * 0.2 * torch.cos(3.1 * theta)
    roll = wobble * 0.15 * torch.sin(2.3 * theta)
    zero = torch.zeros_like(yaw)
    q = quat_mul(quat_from_axis_angle(torch.stack([zero, zero, yaw], -1)),
                 quat_mul(quat_from_axis_angle(torch.stack([zero, pitch, zero], -1)),
                          quat_from_axis_angle(torch.stack([roll, zero, zero], -1))))
    return pos, q


def rig_T_CL(device=None, dtype=torch.float32):
    """Camera-from-laser extrinsic of the rig: the camera looks along the
    sensor's +x with a small lever arm (the port's `synthetic_T_CL`)."""
    R = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    q = torch.tensor(quat_from_mat(R), device=device, dtype=dtype)
    t = torch.tensor([0.06, -0.05, 0.27], device=device, dtype=dtype)
    return t, q


def rig_T_CL_mat4() -> list:
    """The rig's extrinsic as a row-major 4×4 list (a configuration's
    `laser_to_camera`)."""
    R = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    m = np.eye(4)
    m[:3, :3], m[:3, 3] = R, [0.06, -0.05, 0.27]
    return [float(v) for v in m.reshape(-1)]
