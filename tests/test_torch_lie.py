"""Quaternion and Pose ops of the port against `lmono_tpu.utils.lie`.

Tolerance: atol 1e-6 (f32 arithmetic in the same order, up to a few ulps
of values of order 1; translations and points are drawn at that scale)."""

import jax.numpy as jnp
import numpy as np
import torch

from lmono_tpu.utils import lie as jl
from lmono_tpu_torch.utils import lie as tl

ATOL = 1e-6


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=ATOL)


def test_quaternion_ops_match():
    rng = np.random.default_rng(0)
    a, b = _quats(rng, 64), _quats(rng, 64)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    th = rng.normal(size=(64, 3)).astype(np.float32)
    th[:8] *= 1e-5                        # small-angle branches
    ta, tb, tv, tth = (torch.from_numpy(x) for x in (a, b, v, th))
    _close(jl.quat_mul(a, b), tl.quat_mul(ta, tb))
    _close(jl.quat_rotate(a, v), tl.quat_rotate(ta, tv))
    _close(jl.quat_conj(a), tl.quat_conj(ta))
    _close(jl.quat_normalize(a * 3.0), tl.quat_normalize(ta * 3.0))
    _close(jl.quat_to_mat(a), tl.quat_to_mat(ta))
    _close(jl.mat_to_quat(jl.quat_to_mat(a)), tl.mat_to_quat(tl.quat_to_mat(ta)))
    _close(jl.so3_exp_quat(th), tl.so3_exp_quat(tth))
    _close(jl.so3_log_quat(a), tl.so3_log_quat(ta))
    _close(jl.boxminus(a, b), tl.boxminus(ta, tb))


def test_pose_ops_match():
    rng = np.random.default_rng(1)
    qa, qb = _quats(rng, 16), _quats(rng, 16)
    ta_, tb_ = (rng.normal(size=(16, 3)).astype(np.float32) for _ in range(2))
    pts = rng.normal(size=(16, 3)).astype(np.float32)
    J = jl.Pose(jnp.asarray(ta_), jnp.asarray(qa))
    K = jl.Pose(jnp.asarray(tb_), jnp.asarray(qb))
    T = tl.Pose(torch.from_numpy(ta_), torch.from_numpy(qa))
    U = tl.Pose(torch.from_numpy(tb_), torch.from_numpy(qb))
    tp = torch.from_numpy(pts)
    for j, t in [(J.compose(K), T.compose(U)), (J.inverse(), T.inverse()),
                 (J.between(K), T.between(U))]:
        _close(j.t, t.t)
        _close(j.q, t.q)
    _close(J.apply(pts), T.apply(tp))
    _close(J.apply_inv(pts), T.apply_inv(tp))
    _close(J.to_mat4()[..., :3, :3], T.to_mat4()[..., :3, :3])
    _close(J.R, T.R)
    P = jl.Pose.from_Rt(J.R, J.t)
    Q = tl.Pose.from_Rt(T.R, T.t)
    _close(P.q, Q.q)
    I = tl.Pose.identity((2,))
    assert I.t.shape == (2, 3) and torch.equal(I.q[:, 0], torch.ones(2))
    S = tl.pose_stack([T, U])
    assert S.t.shape == (2, 16, 3)


def test_estimator_lie_ops_match():
    """skew, boxplus and Pose.retract / Pose.local, which the estimator
    slice uses."""
    rng = np.random.default_rng(2)
    q, p = _quats(rng, 32), _quats(rng, 32)
    t = rng.normal(size=(32, 3)).astype(np.float32)
    d = 0.3 * rng.normal(size=(32, 6)).astype(np.float32)
    d[:4, 3:] *= 1e-5                     # small-angle branches
    tq, tp, tt, td = (torch.from_numpy(x) for x in (q, p, t, d))
    _close(jl.skew(t), tl.skew(tt))
    _close(jl.boxplus(q, d[:, 3:]), tl.boxplus(tq, td[:, 3:]))
    J, T = jl.Pose(jnp.asarray(t), jnp.asarray(q)), tl.Pose(tt, tq)
    K, U = jl.Pose(jnp.asarray(t + 1.0), jnp.asarray(p)), tl.Pose(tt + 1.0, tp)
    r_j, r_t = J.retract(jnp.asarray(d)), T.retract(td)
    _close(r_j.t, r_t.t)
    _close(r_j.q, r_t.q)
    _close(J.local(K), T.local(U))
    # local undoes retract
    np.testing.assert_allclose(T.local(r_t).numpy(), d, rtol=0, atol=1e-5)
