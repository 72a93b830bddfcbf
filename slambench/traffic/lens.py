"""The benchmark's lens: a pinhole camera with radial-tangential distortion
(k1, k2, p1, p2), as camodocal's `PinholeCamera` models it.

A distorted pixel is  u = fx·x_d + cx,  v = fy·y_d + cy,  where the
normalized point (x, y) = (X/Z, Y/Z) moves to

    x_d = x + x (k1 r² + k2 r⁴) + 2 p1 x y + p2 (r² + 2 x²)
    y_d = y + y (k1 r² + k2 r⁴) + p1 (r² + 2 y²) + 2 p2 x y,   r² = x² + y².

Pixels are sampled at their centres (+0.5), as `sim.render_camera` samples
them.  The render's ray of a pixel and every lift of a pixel invert the
distortion by iterating x ← x_d − D(x) in float64 until it no longer moves,
then cast to the caller's dtype; projections apply the forward distortion in
the caller's dtype (the control's bfloat16, or float32).  A camera whose
distortion is all zero never comes here: `drive.Drive` takes `sim`'s pinhole
for it, unchanged.  Imports nothing of the port.
"""

from __future__ import annotations

import torch

from slambench.traffic import sim

MODELS = ("pinhole",)
_ITERS = 200
_TOL = 1e-13


def lens_of(camera: dict):
    """The distortion (k1, k2, p1, p2) of a configuration's camera block,
    or None for a pinhole without any."""
    model = camera.get("model", "pinhole")
    dist = [float(v) for v in camera.get("distortion", ())]
    if model not in MODELS:
        raise ValueError(f"camera model {model!r} is not in the simulator")
    if any(dist[4:]):
        raise ValueError(f"pinhole distortion {dist} has more than k1, k2, p1, p2: "
                         "not in the simulator")
    k = (dist + [0.0] * 4)[:4]
    return tuple(k) if any(k) else None


def distort(xy, k):
    """Normalized undistorted points (..., 2) → distorted, in their dtype."""
    k1, k2, p1, p2 = k
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    rad = k1 * r2 + k2 * r2 * r2
    return torch.stack([x + x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x),
                        y + y * rad + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y], -1)


def undistort(xy_d, k):
    """Normalized distorted points (..., 2) → undistorted, in float64,
    iterated to a fixed point; raises where the lens does not invert."""
    xd = xy_d.double()
    x = xd
    for _ in range(_ITERS):
        nxt = xd - (distort(x, k) - x)
        step = float(torch.max(torch.abs(nxt - x))) if nxt.numel() else 0.0
        x = nxt
        if step < _TOL:
            return x
    raise ValueError(f"the lens {k} does not invert within {_ITERS} steps (last step {step})")


def lift(cam: dict, k, u, v):
    """Pixel coordinates (sampled at u, v as given) → normalized undistorted
    (x, y), float64."""
    xd = (u.double() - cam["cx"]) / cam["fx"]
    yd = (v.double() - cam["cy"]) / cam["fy"]
    xy = undistort(torch.stack([xd, yd], -1), k)
    return xy[..., 0], xy[..., 1]


def project(cam: dict, k, p):
    """Camera-frame points (..., 3) in front of the camera → pixel coordinates
    (..., 2) through the forward distortion, in the points' dtype."""
    xy = distort(p[..., :2] / p[..., 2:3], k)
    return torch.stack([cam["fx"] * xy[..., 0] + cam["cx"],
                        cam["fy"] * xy[..., 1] + cam["cy"]], -1)


def camera_ray_dirs(cam: dict, k, device=None, dtype=torch.float32):
    """Camera-frame unit rays per pixel centre (H, W, 3) through the lens:
    z forward, y down."""
    u = torch.arange(cam["width"], dtype=torch.float64, device=device) + 0.5
    v = torch.arange(cam["height"], dtype=torch.float64, device=device) + 0.5
    x, y = lift(cam, k, u[None, :].expand(cam["height"], cam["width"]),
                v[:, None].expand(cam["height"], cam["width"]))
    d = torch.stack([x, y, torch.ones_like(x)], -1)
    return (d / torch.linalg.norm(d, dim=-1, keepdim=True)).to(dtype)


def reproject_pixels(scene: dict, pose_wc0, pose_wc1, cam: dict, k, uv0):
    """Where the scene points seen at pixels uv0 (N, 2) of camera 0 appear in
    camera 1, both through the lens; (uv1, ok), as `sim.reproject_pixels`."""
    x, y = lift(cam, k, uv0[:, 0] + 0.5, uv0[:, 1] + 0.5)
    d = torch.stack([x, y, torch.ones_like(x)], -1)
    d = (d / torch.linalg.norm(d, dim=-1, keepdim=True)).to(uv0.dtype)
    d = sim.quat_rotate(pose_wc0[1], d)
    origin = pose_wc0[0].expand(d.shape)
    t = sim.ray_cast(scene, origin, d)
    hit = t < sim._BIG * 0.5
    p1 = sim.apply_inv(pose_wc1, origin + d * torch.where(hit, t, torch.zeros_like(t))[:, None])
    z = p1[:, 2]
    front = z > 1e-6
    safe = torch.where(front[:, None], p1, torch.ones_like(p1))
    return project(cam, k, safe) - 0.5, hit & front
