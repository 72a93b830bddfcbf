"""Camera models of the reference's camera_models package.

Port of `lmono_tpu/camera/models.py`, the pinhole (radtan k1 k2 p1 p2)
model (`:27-62`).  pinhole_full, mei, equidistant and scaramuzza are still
to port (ROADMAP Queue 1).
"""

from __future__ import annotations

import numpy as np
import torch

from lmono_tpu_torch.camera.base import CameraModel, _iterative_undistort


def _f32(v) -> float:
    return float(np.float32(v))


def _radtan_distort(k1, k2, p1, p2, xy):
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    rad = k1 * r2 + k2 * r2 * r2
    dx = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    dy = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([dx, dy], dim=-1)


def _pinhole_s2p(p, P):
    xy = P[..., :2] / torch.clamp(P[..., 2:3], min=1e-9)
    xy_d = xy + _radtan_distort(p["k1"], p["k2"], p["p1"], p["p2"], xy)
    u = p["fx"] * xy_d[..., 0] + p["cx"]
    v = p["fy"] * xy_d[..., 1] + p["cy"]
    return torch.stack([u, v], dim=-1)


def _pinhole_lift(p, uv):
    xd = (uv[..., 0] - p["cx"]) / p["fx"]
    yd = (uv[..., 1] - p["cy"]) / p["fy"]
    xy_d = torch.stack([xd, yd], dim=-1)
    xy_u = _iterative_undistort(
        lambda xy: _radtan_distort(p["k1"], p["k2"], p["p1"], p["p2"], xy),
        xy_d)
    ray = torch.cat([xy_u, torch.ones_like(xy_u[..., :1])], dim=-1)
    return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)


def pinhole_camera(width, height, fx, fy, cx, cy,
                   k1=0.0, k2=0.0, p1=0.0, p2=0.0) -> CameraModel:
    params = {k: _f32(v) for k, v in dict(fx=fx, fy=fy, cx=cx, cy=cy, k1=k1,
                                          k2=k2, p1=p1, p2=p2).items()}
    return CameraModel("pinhole", params, width, height,
                       _pinhole_s2p, _pinhole_lift)
