"""The five camera models of the reference's camera_models package.

Port of `lmono_tpu/camera/models.py`:
  pinhole        — radtan k1 k2 p1 p2
  pinhole_full   — 8-parameter rational radtan (k1..k6, p1 p2)
  mei            — unified omnidirectional (xi + radtan)
  equidistant    — Kannala–Brandt θ-polynomial
  scaramuzza     — OCAM polynomial + affine

Parameters are host floats rounded to float32, as the reference stores them
(`jnp.float32`); scaramuzza's polynomial is a tuple of them.  Every
`space_to_plane` and lift is plain tensor arithmetic with the reference's
fixed iteration counts, so it is differentiable under `torch.func` with
respect to the points and to parameters passed as tensors (the intrinsic
calibration does that, `camera/calibration.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from lmono_tpu_torch.camera.base import CameraModel, _iterative_undistort


def _f32(v) -> float:
    return float(np.float32(v))


# --------------------------------------------------------------------------
# pinhole (radtan k1 k2 p1 p2)
# --------------------------------------------------------------------------

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


# --------------------------------------------------------------------------
# pinhole_full (rational model: k1..k6, p1 p2)
# --------------------------------------------------------------------------

def _rational_distort_xy(p, xy):
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    r4, r6 = r2 * r2, r2 * r2 * r2
    num = 1 + p["k1"] * r2 + p["k2"] * r4 + p["k3"] * r6
    den = 1 + p["k4"] * r2 + p["k5"] * r4 + p["k6"] * r6
    s = num / torch.clamp(den, min=1e-9)
    dx = x * s + 2 * p["p1"] * x * y + p["p2"] * (r2 + 2 * x * x)
    dy = y * s + p["p1"] * (r2 + 2 * y * y) + 2 * p["p2"] * x * y
    return torch.stack([dx, dy], dim=-1)


def _pinhole_full_s2p(p, P):
    xy = P[..., :2] / torch.clamp(P[..., 2:3], min=1e-9)
    xy_d = _rational_distort_xy(p, xy)
    u = p["fx"] * xy_d[..., 0] + p["cx"]
    v = p["fy"] * xy_d[..., 1] + p["cy"]
    return torch.stack([u, v], dim=-1)


def _pinhole_full_lift(p, uv):
    xd = (uv[..., 0] - p["cx"]) / p["fx"]
    yd = (uv[..., 1] - p["cy"]) / p["fy"]
    xy_d = torch.stack([xd, yd], dim=-1)
    # fixed point x_{n+1} = x_n + (xy_d − D(x_n)), 10 steps
    xy_u = xy_d
    for _ in range(10):
        xy_u = xy_u + (xy_d - _rational_distort_xy(p, xy_u))
    ray = torch.cat([xy_u, torch.ones_like(xy_u[..., :1])], dim=-1)
    return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)


def pinhole_full_camera(width, height, fx, fy, cx, cy,
                        k1=0.0, k2=0.0, k3=0.0, k4=0.0, k5=0.0, k6=0.0,
                        p1=0.0, p2=0.0) -> CameraModel:
    params = {k: _f32(v) for k, v in dict(
        fx=fx, fy=fy, cx=cx, cy=cy, k1=k1, k2=k2, k3=k3, k4=k4, k5=k5,
        k6=k6, p1=p1, p2=p2).items()}
    return CameraModel("pinhole_full", params, width, height,
                       _pinhole_full_s2p, _pinhole_full_lift)


# --------------------------------------------------------------------------
# MEI / unified omnidirectional (xi + radtan + gamma)
# --------------------------------------------------------------------------

def _mei_s2p(p, P):
    Pn = P / torch.linalg.norm(P, dim=-1, keepdim=True)
    z = Pn[..., 2] + p["xi"]
    xy = Pn[..., :2] / torch.clamp(z, min=1e-9)[..., None]
    xy_d = xy + _radtan_distort(p["k1"], p["k2"], p["p1"], p["p2"], xy)
    u = p["gamma1"] * xy_d[..., 0] + p["u0"]
    v = p["gamma2"] * xy_d[..., 1] + p["v0"]
    return torch.stack([u, v], dim=-1)


def _mei_lift(p, uv):
    mx = (uv[..., 0] - p["u0"]) / p["gamma1"]
    my = (uv[..., 1] - p["v0"]) / p["gamma2"]
    xy_d = torch.stack([mx, my], dim=-1)
    xy_u = _iterative_undistort(
        lambda xy: _radtan_distort(p["k1"], p["k2"], p["p1"], p["p2"], xy),
        xy_d)
    # unproject from the unit sphere model (CataCamera::liftProjective)
    r2 = torch.sum(xy_u * xy_u, dim=-1)
    xi = p["xi"]
    disc = 1.0 + (1.0 - xi * xi) * r2
    z = 1.0 - xi * (r2 + 1.0) / (xi + torch.sqrt(torch.clamp(disc, min=0.0)))
    ray = torch.cat([xy_u, z[..., None]], dim=-1)
    return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)


def mei_camera(width, height, gamma1, gamma2, u0, v0, xi,
               k1=0.0, k2=0.0, p1=0.0, p2=0.0) -> CameraModel:
    params = {k: _f32(v) for k, v in dict(
        gamma1=gamma1, gamma2=gamma2, u0=u0, v0=v0, xi=xi,
        k1=k1, k2=k2, p1=p1, p2=p2).items()}
    return CameraModel("mei", params, width, height, _mei_s2p, _mei_lift)


# --------------------------------------------------------------------------
# equidistant / Kannala–Brandt (θ + k2θ³ + k3θ⁵ + k4θ⁷ + k5θ⁹)
# --------------------------------------------------------------------------

def _kb_theta_poly(p, theta):
    t2 = theta * theta
    return theta * (1 + t2 * (p["k2"] + t2 * (p["k3"] + t2 * (
        p["k4"] + t2 * p["k5"]))))


def _kb_theta_poly_deriv(p, theta):
    t2 = theta * theta
    return 1 + t2 * (3 * p["k2"] + t2 * (5 * p["k3"] + t2 * (
        7 * p["k4"] + t2 * 9 * p["k5"])))


def _equi_s2p(p, P):
    r_xy = torch.linalg.norm(P[..., :2], dim=-1)
    theta = torch.atan2(r_xy, P[..., 2])
    rd = _kb_theta_poly(p, theta)
    scale = rd / torch.clamp(r_xy, min=1e-9)
    u = p["mu"] * scale * P[..., 0] + p["u0"]
    v = p["mv"] * scale * P[..., 1] + p["v0"]
    return torch.stack([u, v], dim=-1)


def _equi_lift(p, uv):
    x = (uv[..., 0] - p["u0"]) / p["mu"]
    y = (uv[..., 1] - p["v0"]) / p["mv"]
    rd = torch.sqrt(x * x + y * y)
    # Newton-invert the θ-polynomial, 8 steps
    # (EquidistantCamera::backprojectSymmetric)
    theta = rd
    for _ in range(8):
        f = _kb_theta_poly(p, theta) - rd
        theta = theta - f / torch.clamp(_kb_theta_poly_deriv(p, theta), min=1e-6)
    s = torch.sin(theta)
    phi_cos = x / torch.clamp(rd, min=1e-9)
    phi_sin = y / torch.clamp(rd, min=1e-9)
    return torch.stack([s * phi_cos, s * phi_sin, torch.cos(theta)], dim=-1)


def equidistant_camera(width, height, mu, mv, u0, v0,
                       k2=0.0, k3=0.0, k4=0.0, k5=0.0) -> CameraModel:
    params = {k: _f32(v) for k, v in dict(
        mu=mu, mv=mv, u0=u0, v0=v0, k2=k2, k3=k3, k4=k4, k5=k5).items()}
    return CameraModel("equidistant", params, width, height,
                       _equi_s2p, _equi_lift)


# --------------------------------------------------------------------------
# Scaramuzza OCAM (polynomial world→cam via Newton on the forward poly)
# --------------------------------------------------------------------------

def _ocam_poly(coeffs, rho):
    """Σ c_i ρ^i by Horner's rule (coeffs: a sequence of D floats)."""
    out = torch.zeros_like(rho)
    for c in reversed(coeffs):
        out = out * rho + c
    return out


def _poly_deriv(coeffs) -> tuple:
    return tuple(_f32(i * c) for i, c in enumerate(coeffs) if i > 0)


def _scara_lift(p, uv):
    # affine correction: [u;v] = [c d; e 1][x;y] + [cx;cy]
    up = uv[..., 0] - p["cx"]
    vp = uv[..., 1] - p["cy"]
    det = max(_f32(np.float32(p["c"]) - np.float32(p["d"]) * np.float32(p["e"])),
              1e-9)
    x = (up - p["d"] * vp) / det
    y = (-p["e"] * up + p["c"] * vp) / det
    rho = torch.sqrt(x * x + y * y)
    z = -_ocam_poly(p["poly"], rho)  # OCAM convention: z points into image
    ray = torch.stack([x, y, z], dim=-1)
    return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)


def _scara_s2p(p, P):
    # ray ∝ (x, y, −poly(ρ)) ⇒ solve poly(ρ) + (z/r_xy)·ρ = 0 by 20 Newton steps
    r_xy = torch.linalg.norm(P[..., :2], dim=-1)
    m = P[..., 2] / torch.clamp(r_xy, min=1e-9)
    dpoly = _poly_deriv(p["poly"])
    rho = torch.full(P.shape[:-1], 100.0, dtype=P.dtype, device=P.device)
    for _ in range(20):
        f = _ocam_poly(p["poly"], rho) + m * rho
        df = _ocam_poly(dpoly, rho) + m
        rho = torch.clamp(rho - f / torch.where(torch.abs(df) < 1e-9, 1e-9, df),
                          0.0, 1e4)
    scale = rho / torch.clamp(r_xy, min=1e-9)
    x = P[..., 0] * scale
    y = P[..., 1] * scale
    u = x * p["c"] + y * p["d"] + p["cx"]
    v = x * p["e"] + y + p["cy"]
    return torch.stack([u, v], dim=-1)


def scaramuzza_camera(width, height, poly, cx, cy,
                      c=1.0, d=0.0, e=0.0) -> CameraModel:
    params = dict(poly=tuple(_f32(v) for v in poly), cx=_f32(cx), cy=_f32(cy),
                  c=_f32(c), d=_f32(d), e=_f32(e))
    return CameraModel("scaramuzza", params, width, height,
                       _scara_s2p, _scara_lift)
