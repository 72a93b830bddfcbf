"""SO(3)/SE(3) operations on quaternions and rotation matrices, in PyTorch.

Port of `lmono_tpu/utils/lie.py`.

Conventions
-----------
* Quaternions are Hamilton, stored ``(w, x, y, z)``, unit-norm.
* ``boxminus(q1, q2)`` is ``log(q1⁻¹ ⊗ q2)``; a retraction applies a *right*
  (local-frame) perturbation ``q ⊗ exp(dθ/2)``.
* All functions broadcast over leading batch dimensions and branch on no
  tensor value (small-angle cases use `torch.where` with Taylor guards), so
  nothing here waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_EPS = 1e-8


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx],
                       dim=-1)


# --------------------------------------------------------------------------
# Quaternion primitives
# --------------------------------------------------------------------------

def quat_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_positify(q: torch.Tensor) -> torch.Tensor:
    """Flip sign so the scalar part is non-negative."""
    return torch.where(q[..., :1] < 0.0, -q, q)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b, broadcasting over leading dims."""
    a, b = torch.broadcast_tensors(a, b)
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q: R(q) @ v."""
    qw = q[..., :1]
    qv = q[..., 1:]
    t = 2.0 * _cross(qv, v)
    return v + qw * t + _cross(qv, t)


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conj(q), v)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion → 3x3 rotation matrix (batched)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix → unit quaternion (w,x,y,z), branch-free Shepperd:
    all four candidates are formed and the best-conditioned one is taken."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    # four candidates, each scaled by 4*q_i^2 >= 0
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)

    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                          1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    idx = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)      # (..., 4 candidates, 4)
    idx = idx[..., None, None].expand(idx.shape + (1, 4))
    q = torch.gather(cands, -2, idx).squeeze(-2)
    return quat_positify(quat_normalize(q))


# --------------------------------------------------------------------------
# exp / log maps
# --------------------------------------------------------------------------

def so3_exp_quat(theta: torch.Tensor) -> torch.Tensor:
    """Axis-angle vector (..., 3) → unit quaternion exp(theta/2)."""
    angle2 = torch.sum(theta * theta, dim=-1, keepdim=True)
    angle = torch.sqrt(angle2 + _EPS * _EPS)
    half = 0.5 * angle
    # sinc-style guard: sin(half)/angle ≈ 0.5 - angle^2/48 for small angle
    small = angle2 < 1e-8
    k = torch.where(small, 0.5 - angle2 / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - angle2 / 8.0, torch.cos(half))
    return torch.cat([w, k * theta], dim=-1)


def so3_log_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion → axis-angle vector (inverse of so3_exp_quat)."""
    q = quat_positify(q)
    w = q[..., :1]
    v = q[..., 1:]
    vn2 = torch.sum(v * v, dim=-1, keepdim=True)
    vn = torch.sqrt(vn2 + _EPS * _EPS)
    angle = 2.0 * torch.atan2(vn, w)
    small = vn2 < 1e-10
    k = torch.where(small, 2.0 / torch.clamp(w, min=_EPS), angle / vn)
    return k * v


def so3_exp_mat(theta: torch.Tensor) -> torch.Tensor:
    return quat_to_mat(so3_exp_quat(theta))


def so3_log_mat(m: torch.Tensor) -> torch.Tensor:
    return so3_log_quat(mat_to_quat(m))


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [v]_x (reference `SkewSymmetric`)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def boxplus(q: torch.Tensor, dtheta: torch.Tensor) -> torch.Tensor:
    """Right-perturbation retraction q ⊞ dθ = q ⊗ exp(dθ/2)."""
    return quat_normalize(quat_mul(q, so3_exp_quat(dtheta)))


def boxminus(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Local difference q2 ⊟ q1 = log(q1⁻¹ ⊗ q2)."""
    return so3_log_quat(quat_mul(quat_conj(q1), q2))


# --------------------------------------------------------------------------
# Euler helpers (for the 4-DoF pose graph; reference `R2ypr` / `ypr2R`)
# --------------------------------------------------------------------------

def mat_to_ypr(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix → (yaw, pitch, roll) in radians (ZYX)."""
    yaw = torch.atan2(m[..., 1, 0], m[..., 0, 0])
    pitch = torch.atan2(-m[..., 2, 0],
                        torch.sqrt(m[..., 2, 1] ** 2 + m[..., 2, 2] ** 2))
    roll = torch.atan2(m[..., 2, 1], m[..., 2, 2])
    return torch.stack([yaw, pitch, roll], dim=-1)


def ypr_to_mat(ypr: torch.Tensor) -> torch.Tensor:
    """(yaw, pitch, roll) radians → rotation matrix Rz(y) Ry(p) Rx(r)."""
    y, p, r = ypr[..., 0], ypr[..., 1], ypr[..., 2]
    cy, sy = torch.cos(y), torch.sin(y)
    cp, sp = torch.cos(p), torch.sin(p)
    cr, sr = torch.cos(r), torch.sin(r)
    m = torch.stack(
        [
            cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
            sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
            -sp, cp * sr, cp * cr,
        ],
        dim=-1,
    )
    return m.reshape(ypr.shape[:-1] + (3, 3))


# --------------------------------------------------------------------------
# Pose (SE(3)) value type
# --------------------------------------------------------------------------

class Pose(NamedTuple):
    """Rigid transform: x_world = R(q) @ x_local + t."""

    t: torch.Tensor  # (..., 3)
    q: torch.Tensor  # (..., 4) unit (w,x,y,z)

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device=None) -> "Pose":
        batch_shape = tuple(batch_shape)
        t = torch.zeros(batch_shape + (3,), dtype=dtype, device=device)
        q = quat_identity(dtype, device).expand(batch_shape + (4,)).clone()
        return Pose(t, q)

    @staticmethod
    def from_mat4(m: torch.Tensor) -> "Pose":
        return Pose(m[..., :3, 3], mat_to_quat(m[..., :3, :3]))

    @staticmethod
    def from_Rt(R: torch.Tensor, t: torch.Tensor) -> "Pose":
        return Pose(t, mat_to_quat(R))

    def to_mat4(self) -> torch.Tensor:
        R = quat_to_mat(self.q)
        top = torch.cat([R, self.t[..., :, None]], dim=-1)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=self.t.dtype,
                              device=self.t.device)
        bottom = bottom.expand(self.t.shape[:-1] + (1, 4))
        return torch.cat([top, bottom], dim=-2)

    @property
    def R(self) -> torch.Tensor:
        return quat_to_mat(self.q)

    def compose(self, other: "Pose") -> "Pose":
        """self ∘ other: apply `other` first, then `self`."""
        return Pose(self.t + quat_rotate(self.q, other.t),
                    quat_normalize(quat_mul(self.q, other.q)))

    def inverse(self) -> "Pose":
        qinv = quat_conj(self.q)
        return Pose(-quat_rotate(qinv, self.t), qinv)

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        """Transform points (..., 3)."""
        return quat_rotate(self.q, pts) + self.t

    def apply_inv(self, pts: torch.Tensor) -> torch.Tensor:
        return quat_rotate_inv(self.q, pts - self.t)

    def between(self, other: "Pose") -> "Pose":
        """Relative transform self⁻¹ ∘ other."""
        return self.inverse().compose(other)

    def retract(self, delta: torch.Tensor) -> "Pose":
        """⊞ with 6-vector delta = (dp[3], dθ[3]): t+dp, q⊗exp(dθ/2)
        (global translation increment, local rotation increment)."""
        return Pose(self.t + delta[..., :3], boxplus(self.q, delta[..., 3:6]))

    def local(self, other: "Pose") -> torch.Tensor:
        """6-vector such that (approximately) self.retract(v) == other."""
        return torch.cat([other.t - self.t, boxminus(self.q, other.q)], dim=-1)


def pose_stack(poses: list) -> Pose:
    return Pose(torch.stack([p.t for p in poses]), torch.stack([p.q for p in poses]))


def pose_slerp(p0: Pose, p1: Pose, alpha) -> Pose:
    """Linear/slerp interpolation between two poses (for timestamp alignment)."""
    alpha = torch.as_tensor(alpha, dtype=p0.t.dtype, device=p0.t.device)
    t = p0.t + alpha[..., None] * (p1.t - p0.t)
    dq = quat_mul(quat_conj(p0.q), p1.q)
    q = quat_mul(p0.q, so3_exp_quat(alpha[..., None] * so3_log_quat(dq)))
    return Pose(t, quat_normalize(q))
