"""SO(2)/SE(2)/Sim(3) Lie-group operations, batched over leading dimensions.

Port of `lmono_tpu/utils/groups.py`: the 2D groups and Sim(3) of the
vendored Sophus library (`so2.hpp`, `se2.hpp`, `sim3.hpp`).  Conventions
match `lmono_tpu_torch.utils.lie`: Hamilton quaternions ``(w,x,y,z)``,
right (local-frame) perturbations.

Small-angle branches are picked with `torch.where`, which evaluates both
branches, so every division runs on a shielded denominator (`_safe`): a bare
division in the branch that is not taken would still put NaN into the
gradients that autograd sends through `torch.where`.

Tangent layouts:
* se2: ``(vx, vy, theta)`` (translation first, as Sophus `se2.hpp`)
* sim3: ``(rho[3], phi[3], sigma)`` — translation, rotation, log-scale.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lmono_tpu_torch.utils.lie import (
    quat_conj,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_mat,
    skew,
    so3_exp_quat,
    so3_log_quat,
)

_EPS = 1e-6


def _safe(x: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """Magnitude-clamped denominator (keeps sign, never < eps)."""
    return torch.where(torch.abs(x) < eps,
                       torch.where(x < 0, -eps, eps).to(x.dtype), x)


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", M, v)


# --------------------------------------------------------------------------
# SO(2)
# --------------------------------------------------------------------------

def so2_exp(theta: torch.Tensor) -> torch.Tensor:
    """Angle → 2x2 rotation matrix (batched over leading dims)."""
    c, s = torch.cos(theta), torch.sin(theta)
    row0 = torch.stack([c, -s], dim=-1)
    row1 = torch.stack([s, c], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def so2_log(R: torch.Tensor) -> torch.Tensor:
    """2x2 rotation matrix → angle in (-pi, pi]."""
    return torch.atan2(R[..., 1, 0], R[..., 0, 0])


# --------------------------------------------------------------------------
# SE(2)
# --------------------------------------------------------------------------

class SE2(NamedTuple):
    """Planar rigid transform: ``x_out = R(theta) @ x + t`` (batched)."""

    t: torch.Tensor      # (..., 2)
    theta: torch.Tensor  # (...,)

    @staticmethod
    def identity(dtype=torch.float32, device=None) -> "SE2":
        return SE2(torch.zeros(2, dtype=dtype, device=device),
                   torch.zeros((), dtype=dtype, device=device))

    def matrix(self) -> torch.Tensor:
        R = so2_exp(self.theta)
        top = torch.cat([R, self.t[..., :, None]], dim=-1)
        bottom = torch.tensor([0.0, 0.0, 1.0], dtype=top.dtype,
                              device=top.device).expand(top.shape[:-2] + (1, 3))
        return torch.cat([top, bottom], dim=-2)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return _matvec(so2_exp(self.theta), x) + self.t

    def compose(self, other: "SE2") -> "SE2":
        R = so2_exp(self.theta)
        return SE2(_matvec(R, other.t) + self.t, self.theta + other.theta)

    def inverse(self) -> "SE2":
        Rinv = so2_exp(-self.theta)
        return SE2(-_matvec(Rinv, self.t), -self.theta)


def _se2_V(theta: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(2) lifted to the SE(2) translation block."""
    th = _safe(theta)
    small = torch.abs(theta) < _EPS
    a = torch.where(small, 1.0 - theta * theta / 6.0, torch.sin(th) / th)
    b = torch.where(small, theta / 2.0, (1.0 - torch.cos(th)) / th)
    row0 = torch.stack([a, -b], dim=-1)
    row1 = torch.stack([b, a], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def se2_exp(xi: torch.Tensor) -> SE2:
    """Tangent ``(vx, vy, theta)`` → SE2 via the closed-form V matrix."""
    v, theta = xi[..., :2], xi[..., 2]
    return SE2(_matvec(_se2_V(theta), v), theta)


def se2_log(g: SE2) -> torch.Tensor:
    """SE2 → ``(vx, vy, theta)`` on the principal branch: SE2.theta is
    unbounded (compose adds angles) and V(θ) is singular at θ = ±2π, so the
    angle is wrapped to (-π, π] first, as Sophus `se2.hpp` returns it."""
    theta = torch.atan2(torch.sin(g.theta), torch.cos(g.theta))
    V = _se2_V(theta)
    # V is 2x2: invert in closed form
    det = V[..., 0, 0] * V[..., 1, 1] - V[..., 0, 1] * V[..., 1, 0]
    inv00 = V[..., 1, 1] / det
    inv11 = V[..., 0, 0] / det
    inv01 = -V[..., 0, 1] / det
    inv10 = -V[..., 1, 0] / det
    vx = inv00 * g.t[..., 0] + inv01 * g.t[..., 1]
    vy = inv10 * g.t[..., 0] + inv11 * g.t[..., 1]
    return torch.stack([vx, vy, theta], dim=-1)


# --------------------------------------------------------------------------
# Sim(3)
# --------------------------------------------------------------------------

class Sim3(NamedTuple):
    """Similarity transform: ``x_out = s * R(q) @ x + t`` (batched)."""

    q: torch.Tensor  # (..., 4) unit quaternion (w,x,y,z)
    t: torch.Tensor  # (..., 3)
    s: torch.Tensor  # (...,) positive scale

    @staticmethod
    def identity(dtype=torch.float32, device=None) -> "Sim3":
        return Sim3(torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device),
                    torch.zeros(3, dtype=dtype, device=device),
                    torch.ones((), dtype=dtype, device=device))

    def matrix(self) -> torch.Tensor:
        """4x4 homogeneous matrix with sR upper-left block."""
        sR = self.s[..., None, None] * quat_to_mat(self.q)
        top = torch.cat([sR, self.t[..., :, None]], dim=-1)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                              device=top.device).expand(top.shape[:-2] + (1, 4))
        return torch.cat([top, bottom], dim=-2)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.s[..., None] * quat_rotate(self.q, x) + self.t

    def compose(self, other: "Sim3") -> "Sim3":
        return Sim3(quat_normalize(quat_mul(self.q, other.q)),
                    self.s[..., None] * quat_rotate(self.q, other.t) + self.t,
                    self.s * other.s)

    def inverse(self) -> "Sim3":
        qinv = quat_conj(self.q)
        sinv = 1.0 / self.s
        return Sim3(qinv, -sinv[..., None] * quat_rotate(qinv, self.t), sinv)


def _sim3_W(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The Sim(3) translation mixer: ``t = W @ rho`` in exp (Strasdat's W).

    Closed form with four regimes (sigma→0 × theta→0) selected by
    `torch.where` over safe denominators.
    """
    theta = torch.linalg.vector_norm(phi, dim=-1)
    Om = skew(phi)
    Om2 = Om @ Om
    s = torch.exp(sigma)

    th = _safe(theta)
    sig = _safe(sigma)
    small_th = theta < _EPS
    small_sig = torch.abs(sigma) < _EPS

    # sigma ≈ 0 branch
    A0 = torch.where(small_th, 0.5 - theta * theta / 24.0,
                     (1.0 - torch.cos(th)) / (th * th))
    B0 = torch.where(small_th, 1.0 / 6.0 - theta * theta / 120.0,
                     (th - torch.sin(th)) / (th * th * th))
    C0 = torch.ones_like(sigma)

    # sigma != 0 branch
    C1 = (s - 1.0) / sig
    a = s * torch.sin(th)
    b = s * torch.cos(th)
    c = th * th + sigma * sigma
    A1_big = (a * sigma + (1.0 - b) * th) / (th * c)
    B1_big = (C1 - ((b - 1.0) * sigma + a * th) / c) / (th * th)
    A1_small = ((sigma - 1.0) * s + 1.0) / (sig * sig)
    B1_small = ((0.5 * sigma * sigma - sigma + 1.0) * s - 1.0) / (sig ** 3)
    A1 = torch.where(small_th, A1_small, A1_big)
    B1 = torch.where(small_th, B1_small, B1_big)

    A = torch.where(small_sig, A0, A1)
    B = torch.where(small_sig, B0, B1)
    C = torch.where(small_sig, C0, C1)

    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return (A[..., None, None] * Om + B[..., None, None] * Om2
            + C[..., None, None] * eye)


def sim3_exp(xi: torch.Tensor) -> Sim3:
    """Tangent ``(rho[3], phi[3], sigma)`` → Sim3."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    W = _sim3_W(phi, sigma)
    return Sim3(so3_exp_quat(phi), _matvec(W, rho), torch.exp(sigma))


def sim3_log(g: Sim3) -> torch.Tensor:
    """Sim3 → ``(rho[3], phi[3], sigma)``."""
    phi = so3_log_quat(g.q)
    sigma = torch.log(g.s)
    W = _sim3_W(phi, sigma)
    rho = torch.linalg.solve(W, g.t[..., :, None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)
