"""The port's initializer (`lmono_tpu_torch.estimator.initializer`) against
`lmono_tpu.estimator.initializer`, on inputs made from a seed with numpy.

Tolerances:
* `decompose_essential`: {R1, R2} equal as a set within 1e-5, t within 1e-5
  up to sign (the SVD fixes each basis only up to signs);
* `_cheirality_count`: counts equal;
* `relative_pose_from_tracks`, with the Gumbel noise behind the JAX key's
  draws (`jax.random.gumbel(key, (96, 8, N))`): `ok` equal, the inliers
  equal on 97% of the slots (a Sampson distance on the threshold flips
  with the rounding), the best F within 1e-4 of its largest entry, and the
  rotation within 1e-4 (as a quaternion up to sign).  The reference runs
  eagerly here: jitted, XLA's fusions move its Sampson scores enough that
  another hypothesis wins on seed 3, with another rotation;
* `handeye_update` over 20 pairs: `q_ex` within 1e-4 up to sign,
  `converged`, `stable`, `n` and the ring (masks equal, quaternions within
  1e-6) equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmono_tpu.estimator import initializer as ji
from lmono_tpu.io.synthetic import synthetic_T_CL
from lmono_tpu.ops import ransac as jr
from lmono_tpu.utils import lie as jl
from lmono_tpu_torch.estimator import initializer as ti
from lmono_tpu_torch.ops import ransac as tr

Q_ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _same_quat(a, b, atol=Q_ATOL):
    a, b = np.asarray(a), np.asarray(b)
    assert min(np.abs(a - b).max(), np.abs(a + b).max()) <= atol, (a, b, atol)


def _two_views(seed, n=60, outliers=8):
    """Normalized correspondences of a landmark cloud seen from two camera
    poses (cam1-from-cam0 rotation R, translation t), with a few outliers."""
    rng = np.random.default_rng(seed)
    p0 = np.stack([rng.uniform(-4, 4, n), rng.uniform(-2, 2, n),
                   rng.uniform(5, 20, n)], -1).astype(np.float32)
    q = np.asarray(jl.so3_exp_quat(jnp.asarray(
        rng.normal(scale=0.05, size=3).astype(np.float32))))
    R = np.asarray(jl.quat_to_mat(q))
    t = np.array([0.1, -0.05, 1.0], np.float32)
    p1 = p0 @ R.T + t
    x0 = (p0[:, :2] / p0[:, 2:]).astype(np.float32)
    x1 = (p1[:, :2] / p1[:, 2:]).astype(np.float32)
    x1 = x1 + 1e-4 * rng.normal(size=x1.shape).astype(np.float32)
    x1[:outliers] += rng.normal(scale=0.1, size=(outliers, 2)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[-3:] = False
    return x0, x1, mask, q


def test_decompose_essential_matches():
    x0, x1, _, q = _two_views(0)
    R = np.asarray(jl.quat_to_mat(q))
    t = np.array([0.1, -0.05, 1.0], np.float32)
    tx = np.asarray(jl.skew(jnp.asarray(t)))
    E = (tx @ R).astype(np.float32)
    j = ji.decompose_essential(jnp.asarray(E))
    t_ = ti.decompose_essential(_t(E))
    jR, tR = [np.asarray(r) for r in j[:2]], [r.numpy() for r in t_[:2]]
    for r in jR:      # the same two rotations, in either order
        assert min(np.abs(r - s).max() for s in tR) <= 1e-5
    assert min(np.abs(np.asarray(j[2]) - t_[2].numpy()).max(),
               np.abs(np.asarray(j[2]) + t_[2].numpy()).max()) <= 1e-5
    # one candidate is the true rotation
    assert min(np.abs(r - R).max() for r in tR) <= 1e-4


def test_cheirality_count_matches():
    x0, x1, mask, q = _two_views(1)
    R = np.asarray(jl.quat_to_mat(q))
    rng = np.random.default_rng(2)
    for tt in (np.array([0.1, -0.05, 1.0], np.float32),
               rng.normal(size=3).astype(np.float32)):
        for s in (1.0, -1.0):
            c_j = int(ji._cheirality_count(jnp.asarray(R), jnp.asarray(s * tt),
                                           jnp.asarray(x0), jnp.asarray(x1),
                                           jnp.asarray(mask)))
            c_t = int(ti._cheirality_count(_t(R), _t(s * tt), _t(x0), _t(x1),
                                           _t(mask)))
            assert c_t == c_j


@pytest.mark.parametrize("seed,outliers", [(3, 8), (4, 0), (5, 40)])
def test_relative_pose_from_tracks_matches(seed, outliers):
    x0, x1, mask, q = _two_views(seed, outliers=outliers)
    key = jax.random.PRNGKey(seed)
    g = jax.random.gumbel(key, (ti.RP_ITERS, 8, x0.shape[0]))
    # eager JAX: jitted, XLA's fusions move the Sampson scores enough to
    # make another hypothesis win on seed 3
    qj, okj = ji.relative_pose_from_tracks(
        jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(mask), key)
    qt, okt = ti.relative_pose_from_tracks(_t(x0), _t(x1), _t(mask), _t(g))
    assert bool(okt) == bool(okj)
    # the RANSAC inside: same inliers, F to its rounding
    inl_j, F_j = jr.ransac_fundamental(jnp.asarray(x0), jnp.asarray(x1),
                                       jnp.asarray(mask), key, iters=ti.RP_ITERS,
                                       thresh=ti.RP_THRESH)
    inl_t, F_t = tr.ransac_fundamental(_t(x0), _t(x1), _t(mask),
                                       tr.masked_categorical(_t(mask), _t(g)),
                                       thresh=ti.RP_THRESH)
    assert (inl_t.numpy() == np.asarray(inl_j)).mean() >= 0.97
    F_j = np.asarray(F_j)
    assert np.abs(F_t.numpy() - F_j).max() <= 1e-4 * np.abs(F_j).max()
    _same_quat(qt.numpy(), qj)
    if outliers < 40:
        assert bool(okt)
        # the frames' relative rotation is the transpose of cam1-from-cam0's
        _same_quat(qt.numpy(), np.asarray(jl.quat_conj(q)), atol=5e-3)


def _pairs(n, seed):
    """Rotation pairs of one extrinsic X = R_CL: q_cam = X q_las X⁻¹ with a
    little noise; one pair with disagreeing angles."""
    rng = np.random.default_rng(seed)
    X = synthetic_T_CL().q
    out = []
    for i in range(n):
        q_las = jl.so3_exp_quat(jnp.asarray(rng.normal(scale=0.08, size=3), jnp.float32))
        q_cam = jl.quat_mul(jl.quat_mul(X, q_las), jl.quat_conj(X))
        q_cam = jl.boxplus(q_cam, jnp.asarray(rng.normal(scale=2e-4, size=3), jnp.float32))
        if i == 7:
            q_cam = jl.boxplus(q_cam, jnp.asarray([0.3, 0.0, 0.0], jnp.float32))
        out.append((np.asarray(q_cam), np.asarray(q_las), i != 11))
    return out, np.asarray(X)


@pytest.mark.parametrize("capacity", [512, 8])
def test_handeye_update_matches(capacity):
    pairs, X = _pairs(20, seed=6)
    js = ji.HandEyeState.init(capacity)
    ts = ti.HandEyeState.init(capacity)
    for f in ts._fields:
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)))
    step = jax.jit(ji.handeye_update)
    for q_cam, q_las, ok in pairs:
        js = step(js, jnp.asarray(q_cam), jnp.asarray(q_las), jnp.asarray(ok))
        ts = ti.handeye_update(ts, _t(q_cam), _t(q_las), torch.tensor(ok))
        _same_quat(ts.q_ex.numpy(), js.q_ex)
        for f in ("n", "stable", "converged", "mask"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                          err_msg=f)
        for f in ("q_cam", "q_las"):
            np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                       rtol=0, atol=1e-6, err_msg=f)
    assert int(ts.n) == 18                 # one bad-angle pair, one not ok
    assert int(ts.stable) >= 10
    _same_quat(ts.q_ex.numpy(), X, atol=2e-3)


def test_quat_matrices_match():
    rng = np.random.default_rng(7)
    q = rng.normal(size=(16, 4)).astype(np.float32)
    np.testing.assert_array_equal(ti._quat_left(_t(q)).numpy(), np.asarray(ji._quat_left(q)))
    np.testing.assert_array_equal(ti._quat_right(_t(q)).numpy(), np.asarray(ji._quat_right(q)))
