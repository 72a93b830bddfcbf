"""SO(2)/SE(2)/Sim(3) groups and splines of the port
(`lmono_tpu_torch.utils.groups` / `.spline`) against the JAX package's, on
the same numpy inputs: every groups and spline case of
`tests/test_groups_spline_sync.py`, each holding the port to the JAX
function within 1e-5 (rtol and atol) and to the case's own property; and
finite autograd gradients at θ = 0, where the small-angle branches of
`torch.where` meet their shielded denominators."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmono_tpu.utils import groups as jg
from lmono_tpu.utils import lie as jl
from lmono_tpu.utils import spline as js
from lmono_tpu_torch.utils import groups as tg
from lmono_tpu_torch.utils import lie as tl
from lmono_tpu_torch.utils import spline as ts

TOL = 1e-5
# the JAX references, jitted: op by op, each of their many small ops
# compiles on its first call
_j_resample = jax.jit(js.pose_bspline_resample)
_j_fit = jax.jit(js.cubic_spline_fit)
_j_eval = jax.jit(js.cubic_spline_eval)
_j_sim3_exp = jax.jit(jax.vmap(jg.sim3_exp))
_j_sim3_log = jax.jit(jax.vmap(jg.sim3_log))


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=tol, atol=tol)


def T(x):
    return torch.from_numpy(np.array(x, np.float32))


def J(x):
    return jnp.asarray(np.asarray(x, np.float32))


def _se2_tangents(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)) * np.array([2.0, 2.0, 1.5])).astype(np.float32)


def _sim3_tangents():
    rng = np.random.default_rng(2)
    xi = np.concatenate([rng.normal(size=(64, 3)) * 2.0,
                         rng.normal(size=(64, 3)) * 1.0,
                         rng.normal(size=(64, 1)) * 0.5], axis=-1)
    xi[0] = 0.0
    xi[1, 3:6] = 0.0            # no rotation, with scale
    xi[2, 6] = 0.0              # rotation, no scale
    xi[3, 3:] = 0.0             # pure translation
    nrm = np.linalg.norm(xi[:, 3:6], axis=-1, keepdims=True)
    xi[:, 3:6] *= np.minimum(1.0, 2.9 / np.maximum(nrm, 1e-9))
    return xi.astype(np.float32)


# ---------------------------------------------------------------- SO2 / SE2

def test_so2_roundtrip():
    th = np.linspace(-3.0, 3.0, 13, dtype=np.float32)
    R = tg.so2_exp(T(th))
    close(R, jg.so2_exp(J(th)))
    close(tg.so2_log(R), jg.so2_log(jg.so2_exp(J(th))))
    assert np.allclose(tg.so2_log(R), th, atol=1e-6)


def test_se2_exp_log_roundtrip():
    xi = _se2_tangents(0, 32)
    g, gj = tg.se2_exp(T(xi)), jg.se2_exp(J(xi))
    close(g.t, gj.t)
    close(g.theta, gj.theta)
    back = tg.se2_log(g)
    close(back, jg.se2_log(gj))
    assert np.allclose(back, xi, atol=1e-4)


def test_se2_compose_inverse_matrix():
    rng = np.random.default_rng(1)
    xa, xb = (rng.normal(size=3).astype(np.float32) for _ in range(2))
    a, b = tg.se2_exp(T(xa)), tg.se2_exp(T(xb))
    aj, bj = jg.se2_exp(J(xa)), jg.se2_exp(J(xb))
    ab = a.compose(b)
    close(ab.matrix(), aj.compose(bj).matrix())
    close(a.inverse().t, aj.inverse().t)
    assert np.allclose(ab.matrix(), a.matrix() @ b.matrix(), atol=1e-5)
    assert np.allclose(a.compose(a.inverse()).matrix(), np.eye(3), atol=1e-5)
    x = np.array([0.3, -1.2], np.float32)
    close(a.apply(T(x)), aj.apply(J(x)))
    assert np.allclose(a.apply(T(x)),
                       (a.matrix() @ T([0.3, -1.2, 1.0]))[:2], atol=1e-5)


def test_se2_log_wraps_to_principal_angle():
    xi = np.array([1.0, 0.5, 2.5], np.float32)
    acc, accj = tg.se2_exp(T(xi)), jg.se2_exp(J(xi))
    g, gj = acc, accj
    for _ in range(3):          # total theta = 7.5 rad > 2*pi
        acc, accj = acc.compose(g), accj.compose(gj)
    out = tg.se2_log(acc)
    close(out, jg.se2_log(accj))
    assert torch.isfinite(out).all()
    assert -np.pi < float(out[2]) <= np.pi
    g2 = tg.se2_exp(out)
    assert np.allclose(g2.t, acc.t, atol=1e-4)
    assert np.isclose(np.cos(float(g2.theta)), np.cos(float(acc.theta)), atol=1e-5)
    assert np.isclose(np.sin(float(g2.theta)), np.sin(float(acc.theta)), atol=1e-5)


# -------------------------------------------------------------------- Sim3

def test_sim3_exp_log_roundtrip():
    xi = _sim3_tangents()
    g = tg.sim3_exp(T(xi))
    gj = _j_sim3_exp(J(xi))
    for a, b in zip(g, gj):
        close(a, b)
    back = tg.sim3_log(g)
    close(back, _j_sim3_log(gj))
    assert np.allclose(back, xi, atol=2e-4, rtol=1e-4)
    close(tg.sim3_exp(back).matrix(), g.matrix(), tol=1e-4)


def test_sim3_apply_matches_matrix():
    rng = np.random.default_rng(3)
    xi = (rng.normal(size=7) * 0.7).astype(np.float32)
    x = rng.normal(size=(5, 3)).astype(np.float32)
    g, gj = tg.sim3_exp(T(xi)), jg.sim3_exp(J(xi))
    close(g.matrix(), gj.matrix())
    close(g.apply(T(x)), gj.apply(J(x)))
    xh = np.concatenate([x, np.ones((5, 1), np.float32)], -1)
    assert np.allclose(g.apply(T(x)), (g.matrix() @ T(xh).T).T[:, :3], atol=1e-5)


def test_sim3_compose_inverse():
    rng = np.random.default_rng(4)
    xa, xb = ((rng.normal(size=7) * 0.5).astype(np.float32) for _ in range(2))
    a, b = tg.sim3_exp(T(xa)), tg.sim3_exp(T(xb))
    aj, bj = jg.sim3_exp(J(xa)), jg.sim3_exp(J(xb))
    for p, r in zip(a.compose(b), aj.compose(bj)):
        close(p, r)
    for p, r in zip(a.inverse(), aj.inverse()):
        close(p, r)
    assert np.allclose(a.compose(b).matrix(), a.matrix() @ b.matrix(), atol=1e-5)
    assert np.allclose(a.compose(a.inverse()).matrix(), np.eye(4), atol=1e-5)


@pytest.mark.parametrize("name", ["se2_exp", "se2_log", "sim3_exp", "sim3_log"])
def test_gradients_are_finite_at_zero_angle(name):
    # θ = 0 (and σ = 0) takes the Taylor branches; the other branch's
    # division must not send NaN through torch.where
    if name.startswith("se2"):
        xi = torch.tensor([0.4, -0.3, 0.0], requires_grad=True)
        out = tg.se2_exp(xi) if name == "se2_exp" else tg.se2_log(
            tg.SE2(xi[:2], xi[2]))
    else:
        xi = torch.tensor([0.4, -0.3, 0.2, 0.0, 0.0, 0.0, 0.0], requires_grad=True)
        g = tg.sim3_exp(xi)
        out = g if name == "sim3_exp" else tg.sim3_log(g)
    loss = sum(torch.sum(o) for o in (out if isinstance(out, tuple) else (out,)))
    (grad,) = torch.autograd.grad(loss, xi)
    assert torch.isfinite(grad).all(), grad


# ------------------------------------------------------------------ splines

def test_cubic_spline_interpolates_knots_and_midpoints():
    x = np.linspace(0.0, 2.0 * np.pi, 24, dtype=np.float32)
    y = np.sin(x)
    sp, spj = ts.cubic_spline_fit(T(x), T(y)), _j_fit(J(x), J(y))
    close(sp.m, spj.m)
    xm = (0.5 * (x[:-1] + x[1:])).astype(np.float32)
    for q in (x, xm):
        close(ts.cubic_spline_eval(sp, T(q)), _j_eval(spj, J(q)))
    assert np.allclose(ts.cubic_spline_eval(sp, T(x)), y, atol=1e-5)
    assert np.allclose(ts.cubic_spline_eval(sp, T(xm)), np.sin(xm), atol=1e-3)


def test_cubic_spline_vector_values():
    x = np.linspace(0.0, 1.0, 9, dtype=np.float32)
    y = np.stack([x ** 2, -x], axis=-1)
    sp, spj = ts.cubic_spline_fit(T(x), T(y)), _j_fit(J(x), J(y))
    q = np.array([0.25, 0.8], np.float32)
    out = ts.cubic_spline_eval(sp, T(q))
    close(out, _j_eval(spj, J(q)))
    assert out.shape == (2, 2)
    assert np.allclose(out[:, 1], [-0.25, -0.8], atol=1e-4)


def _resample(t, q, times, query):
    port = ts.pose_bspline_resample(tl.Pose(T(t), T(q)), T(times), T(query))
    ref = _j_resample(jl.Pose(J(t), J(q)), J(times), J(query))
    close(port.t, ref.t)
    close(port.q, ref.q)
    return port


def test_pose_bspline_constant_and_line():
    N = 10
    ident = np.broadcast_to(np.array([1.0, 0, 0, 0], np.float32), (N, 4))
    times = np.arange(N, dtype=np.float32)
    query = np.array([2.3, 4.7, 6.1], np.float32)
    const = np.zeros((N, 3), np.float32) + np.array([1.0, 2.0, 3.0], np.float32)
    out = _resample(const, ident, times, query)
    assert np.allclose(out.t, [[1.0, 2.0, 3.0]], atol=1e-5)
    line = np.stack([times, 0 * times, 0 * times], -1)
    out2 = _resample(line, ident, times, query)
    assert np.allclose(out2.t[:, 1:], 0.0, atol=1e-5)
    assert np.allclose(out2.t[:, 0], query, atol=1e-4)


def test_pose_bspline_endpoint_intervals():
    N = 10
    times = np.arange(N, dtype=np.float32)
    line = np.stack([times, 0 * times, 0 * times], -1)
    ident = np.broadcast_to(np.array([1.0, 0, 0, 0], np.float32), (N, 4))
    query = np.array([0.0, 0.5, 1.0, 8.0, 8.5, 9.0], np.float32)
    out = _resample(line, ident, times, query)
    assert np.allclose(out.t[:, 0], query, atol=1e-4)


def test_pose_bspline_rotation_smooth():
    N = 8
    angles = np.linspace(0.0, 1.4, N, dtype=np.float32)
    qs = np.asarray(jl.so3_exp_quat(J(angles[:, None] * np.array([0.0, 0.0, 1.0],
                                                                  np.float32))))
    out = _resample(np.zeros((N, 3), np.float32), qs,
                    np.arange(N, dtype=np.float32), np.array([3.5], np.float32))
    assert abs(float(out.q[0, 1])) < 1e-5
    assert abs(float(out.q[0, 2])) < 1e-5


def test_pose_bspline_resample_on_a_wobbling_circuit():
    # a circuit with roll/pitch wobble, resampled at twice the frame rate
    from lmono_tpu_torch.io.synthetic import circuit_trajectory

    traj = circuit_trajectory(40)
    times = np.arange(40, dtype=np.float32) * 0.1
    query = np.arange(79, dtype=np.float32) * 0.05
    _resample(np.asarray(traj.t), np.asarray(traj.q), times, query)


def test_utils_reexports_like_the_reference():
    import lmono_tpu.utils as jutils
    import lmono_tpu_torch.utils as tutils

    names = ["SE2", "Sim3", "se2_exp", "se2_log", "sim3_exp", "sim3_log",
             "so2_exp", "so2_log", "CubicSpline", "cubic_spline_eval",
             "cubic_spline_fit", "pose_bspline_eval", "pose_bspline_resample"]
    for n in names:
        assert hasattr(jutils, n) and hasattr(tutils, n), n
