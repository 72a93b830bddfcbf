"""Splines: natural cubic interpolation and cumulative SE(3) B-splines.

Port of `lmono_tpu/utils/spline.py` (the reference's camodocal `Spline`
surface).  The natural spline's knot curvatures come from a tridiagonal
(Thomas) solve; evaluation is a gather and a polynomial, batched over the
queries.

The cumulative SE(3) B-spline (`pose_bspline_eval`) is the pose-trajectory
analogue (Lovegrove-style cumulative form on quaternion poses): it
resamples a fused trajectory at arbitrary timestamps, where the reference
outputs poses at frame timestamps only (`Estimator.cc:642-644`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lmono_tpu_torch.utils.lie import Pose, boxplus, quat_conj, quat_mul, so3_log_quat


class CubicSpline(NamedTuple):
    """Natural cubic spline y(x) through knots (x strictly increasing)."""

    x: torch.Tensor   # (N,)
    y: torch.Tensor   # (N, ...) values (trailing dims broadcast)
    m: torch.Tensor   # (N, ...) second derivatives at the knots


def _thomas_solve(lower: torch.Tensor, main: torch.Tensor, upper: torch.Tensor,
                  d: torch.Tensor) -> torch.Tensor:
    """Tridiagonal solve (Thomas algorithm): a forward and a backward sweep
    over the rows, in the reference's order of operations (its two
    `lax.scan`s).  The natural-spline system is diagonally dominant, so no
    pivoting is needed.  lower[0] and upper[-1] are ignored."""
    n = d.shape[0]
    cp_prev = torch.zeros_like(main[0])
    dp_prev = torch.zeros_like(d[0])
    cps, dps = [], []
    for i in range(n):
        denom = main[i] - lower[i] * cp_prev
        cp_prev = upper[i] / denom
        dp_prev = (d[i] - lower[i] * dp_prev) / denom
        cps.append(cp_prev)
        dps.append(dp_prev)
    x_next = torch.zeros_like(d[0])
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        x_next = dps[i] - cps[i] * x_next
        xs[i] = x_next
    return torch.stack(xs) if n else d.clone()


def cubic_spline_fit(x: torch.Tensor, y: torch.Tensor) -> CubicSpline:
    """Solve the natural-spline tridiagonal system for knot curvatures."""
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device)
    N = x.shape[0]
    h = x[1:] - x[:-1]                       # (N-1,)
    yf = y.reshape(N, -1)                    # flatten value dims
    d = 6.0 * ((yf[2:] - yf[1:-1]) / h[1:, None]
               - (yf[1:-1] - yf[:-2]) / h[:-1, None])   # (N-2, D)
    # A m_inner = d with natural end conditions m_0 = m_{N-1} = 0
    main = 2.0 * (h[:-1] + h[1:])
    zero = torch.zeros((1,), dtype=h.dtype, device=h.device)
    lower = torch.cat([zero, h[1:-1]])
    upper = torch.cat([h[1:-1], zero])
    m_inner = _thomas_solve(lower[:, None], main[:, None], upper[:, None], d)
    zeros = torch.zeros((1, yf.shape[1]), dtype=yf.dtype, device=yf.device)
    m = torch.cat([zeros, m_inner, zeros], dim=0)
    return CubicSpline(x, y, m.reshape(y.shape))


def _segment(knots: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """Index i of the knot interval [knots[i], knots[i+1]] holding each
    query (searchsorted from the right, clamped to 0 … N-2)."""
    N = knots.shape[0]
    i = torch.searchsorted(knots, xq.contiguous(), right=True) - 1
    return torch.clamp(i, 0, N - 2)


def cubic_spline_eval(sp: CubicSpline, xq: torch.Tensor) -> torch.Tensor:
    """Evaluate the spline at query points (clamped to the knot range)."""
    x, y, m = sp.x, sp.y, sp.m
    xq = torch.clamp(torch.as_tensor(xq, dtype=x.dtype, device=x.device),
                     x[0], x[-1])
    i = _segment(x, xq)
    x0, x1 = x[i], x[i + 1]
    h = x1 - x0
    t0 = (x1 - xq) / h
    t1 = (xq - x0) / h
    y0, y1 = y[i], y[i + 1]
    m0, m1 = m[i], m[i + 1]
    # broadcast the scalars over trailing value dims
    extra = (1,) * (y.ndim - 1)
    t0e = t0.reshape(t0.shape + extra)
    t1e = t1.reshape(t1.shape + extra)
    he = h.reshape(h.shape + extra)
    return (t0e * y0 + t1e * y1
            + ((t0e ** 3 - t0e) * m0 + (t1e ** 3 - t1e) * m1) * (he ** 2) / 6.0)


# --------------------------------------------------------------------------
# Cumulative SE(3) B-spline
# --------------------------------------------------------------------------

# Cumulative cubic B-spline basis: Btilde(u) = C @ [1, u, u², u³]ᵀ rows 1..3
_CUM_C = ((5.0 / 6.0, 3.0 / 6.0, -3.0 / 6.0, 1.0 / 6.0),
          (1.0 / 6.0, 3.0 / 6.0, 3.0 / 6.0, -2.0 / 6.0),
          (0.0, 0.0, 0.0, 1.0 / 6.0))


def _cumulative_basis(u: torch.Tensor) -> list:
    """The three cumulative basis weights at u, each summed term by term in
    one fixed order (the same bits on every device)."""
    uu = (torch.ones_like(u), u, u * u, u * u * u)
    out = []
    for row in _CUM_C:
        b = row[0] * uu[0]
        for c, p in zip(row[1:], uu[1:]):
            b = b + c * p
        out.append(b)
    return out


def pose_bspline_eval(poses: Pose, u: torch.Tensor, i0: torch.Tensor) -> Pose:
    """Evaluate a cumulative cubic B-spline over control poses.

    poses: (N,) Pose control points (uniform knots).
    u in [0,1): normalized position inside the segment starting at control
    i0 (needs i0 … i0+3 in range).  Batched over u/i0 leading dims.
    """
    B = _cumulative_basis(u)
    q, t = poses.q, poses.t
    q_out, t_out = q[i0], t[i0]
    for k in (1, 2, 3):
        w = B[k - 1]
        dphi = so3_log_quat(quat_mul(quat_conj(q[i0 + k - 1]), q[i0 + k]))
        dt = t[i0 + k] - t[i0 + k - 1]
        q_out = boxplus(q_out, w[..., None] * dphi)
        t_out = t_out + w[..., None] * dt
    return Pose(t=t_out, q=q_out)


def pose_bspline_resample(poses: Pose, times: torch.Tensor,
                          query: torch.Tensor) -> Pose:
    """Resample a discrete pose trajectory at arbitrary timestamps.

    Control points are the trajectory poses themselves with their (sorted)
    timestamps as knots; each query lands in a cubic segment via
    searchsorted.  The control sequence is padded at both ends with
    *linearly extrapolated* virtual poses (p₋₁ = p₀ ∘ (p₀⁻¹p₁)⁻¹ and its
    mirror at the tail), so a constant-velocity trajectory is reproduced
    exactly everywhere, the first and last knot intervals included.
    """
    q, t = poses.q, poses.t
    # virtual controls by mirroring the boundary relative motion
    q_pre = quat_mul(q[0], quat_mul(quat_conj(q[1]), q[0]))     # p1→p0 motion
    t_pre = t[0] + (t[0] - t[1])
    q_post = quat_mul(q[-1], quat_mul(quat_conj(q[-2]), q[-1]))  # pN-2→pN-1
    t_post = t[-1] + (t[-1] - t[-2])
    padded = Pose(t=torch.cat([t_pre[None], t, t_post[None]]),
                  q=torch.cat([q_pre[None], q, q_post[None]]))

    query = torch.as_tensor(query, dtype=times.dtype, device=times.device)
    idx = _segment(times, query)
    t0, t1 = times[idx], times[idx + 1]
    u = torch.clamp((query - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)
    # segment [times[idx], times[idx+1]] uses padded controls idx … idx+3,
    # the original idx-1 … idx+2
    return pose_bspline_eval(padded, u, idx)
