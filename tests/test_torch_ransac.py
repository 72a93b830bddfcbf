"""RANSAC of the port (`lmono_tpu_torch.ops.ransac`: fundamental matrix and
PnP) against `lmono_tpu.ops.ransac`, on the same numpy correspondences and
the same random draws: the port takes the Gumbel noise that
`jax.random.categorical` adds to its logits.

Tolerances: the draws equal; the QR nullspace vector within 1e-5 and the
power-iteration one within 1e-4 (f32 sums in another order); F within
1e-4 and Sampson distances within 1e-3 relative (plus 1e-12); the inlier
masks equal except points whose Sampson distance lies within 1e-3
relative of the threshold (printed).  PnP: the DLT pose within 1e-4 (the
same 12×12 QR and polar iteration), the RANSAC pose within 1e-4 m and
1e-4 in q, the inlier mask equal except points whose reprojection error
lies within 1e-5 relative of the threshold, `ok` equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmono_tpu.ops import ransac as jr
from lmono_tpu_torch.ops import ransac as tr

ITERS = 64
F_PX = 460.0
THRESH = (1.0 / F_PX) ** 2
NEAR_REL = 1e-3
_jransac = jax.jit(jr.ransac_fundamental, static_argnames=("iters", "thresh"))


def _two_view(seed, n=150, outliers=0.25, noise_px=0.3):
    """Normalized correspondences (x0, x1) (n, 2) f32 of a moving camera,
    with pixel noise and a share of random outliers."""
    rng = np.random.default_rng(seed)
    P = np.stack([rng.uniform(-8, 8, n), rng.uniform(-3, 3, n),
                  rng.uniform(4, 40, n)], -1)
    a = rng.normal(size=3) * 0.05
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    R = np.eye(3) + K + K @ K / 2
    Q = P @ R.T + np.array([0.3, 0.05, 1.2]) * rng.uniform(0.5, 1.5)
    x0 = P[:, :2] / P[:, 2:]
    x1 = Q[:, :2] / Q[:, 2:]
    x0 = x0 + rng.normal(size=x0.shape) * noise_px / F_PX
    x1 = x1 + rng.normal(size=x1.shape) * noise_px / F_PX
    bad = rng.random(n) < outliers
    x1[bad] = rng.uniform(-0.5, 0.5, (bad.sum(), 2))
    return x0.astype(np.float32), x1.astype(np.float32)


def _noise(seed, n):
    key = jax.random.PRNGKey(seed)
    return key, np.asarray(jax.random.gumbel(key, (ITERS, 8, n)))


@pytest.mark.parametrize("seed,keep", [(0, 0.7), (1, 0.3), (2, 0.06)])
def test_draws_equal_jax_categorical(seed, keep):
    mask = np.random.default_rng(seed).random(150) < keep
    key, g = _noise(seed, 150)
    logits = jnp.where(jnp.asarray(mask), 0.0, -1e9)
    want = np.asarray(jax.random.categorical(key, logits[None], shape=(ITERS, 8)))
    got = tr.masked_categorical(torch.from_numpy(mask), torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), want)
    assert mask[got.numpy()].all()


@pytest.mark.parametrize("m,n", [(8, 9), (5, 6)])
def test_qr_nullvec_matches(m, n):
    A = np.random.default_rng(m).normal(size=(32, m, n)).astype(np.float32)
    want = np.asarray(jax.jit(jr._qr_nullvec)(jnp.asarray(A)))
    got = tr._qr_nullvec(torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(np.einsum("bij,bj->bi", A, got)).max() < 1e-4


def test_nullvec_matches():
    F = np.random.default_rng(3).normal(size=(32, 3, 3)).astype(np.float32)
    F[:, 2] = F[:, 0] * 0.7 - F[:, 1] * 0.2 + 1e-3 * F[:, 2]   # near rank 2
    want = np.asarray(jr._nullvec(jnp.asarray(F), iters=24))
    got = tr._nullvec(torch.from_numpy(F), iters=24).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_eight_point_and_sampson_match():
    x0, x1 = _two_view(4)
    # distinct points: a draw that repeats one leaves A rank-deficient, and
    # the pinned back-substitution (ROADMAP Queue 3) then returns a vector
    # that rounding decides, in either package
    rng = np.random.default_rng(4)
    idx = np.stack([rng.permutation(len(x0))[:8] for _ in range(ITERS)])
    Fj = np.asarray(jax.jit(jax.vmap(lambda i: jr._eight_point(
        jnp.asarray(x0)[i], jnp.asarray(x1)[i])))(idx))
    Ft = tr._eight_point(torch.from_numpy(x0)[idx], torch.from_numpy(x1)[idx])
    np.testing.assert_allclose(Ft.numpy(), Fj, rtol=0, atol=1e-4)
    dj = np.asarray(jax.vmap(lambda F: jr._sampson(F, jnp.asarray(x0),
                                                   jnp.asarray(x1)))(jnp.asarray(Fj)))
    dt = tr._sampson(torch.from_numpy(Fj), torch.from_numpy(x0),
                     torch.from_numpy(x1)).numpy()
    np.testing.assert_allclose(dt, dj, rtol=1e-3, atol=1e-12)


@pytest.mark.parametrize("seed,keep", [(5, 1.0), (6, 0.8), (7, 0.5)])
def test_ransac_fundamental_matches(seed, keep):
    x0, x1 = _two_view(seed)
    mask = np.random.default_rng(seed).random(len(x0)) < keep
    key, g = _noise(seed, len(x0))
    inl_j, F_j = _jransac(jnp.asarray(x0), jnp.asarray(x1),
                                       jnp.asarray(mask), key, iters=ITERS,
                                       thresh=THRESH)
    tm = torch.from_numpy(mask)
    inl_t, F_t = tr.ransac_fundamental(torch.from_numpy(x0), torch.from_numpy(x1),
                                       tm, tr.masked_categorical(tm, torch.from_numpy(g)),
                                       thresh=THRESH)
    inl_j, inl_t = np.asarray(inl_j), inl_t.numpy()
    d = np.asarray(jr._sampson(F_j, jnp.asarray(x0), jnp.asarray(x1)))
    near = np.abs(d - THRESH) <= NEAR_REL * THRESH
    for k in np.flatnonzero(inl_j != inl_t):
        print(f"inlier differs at {k}: Sampson {d[k]} against {THRESH}")
        assert near[k], k
    np.testing.assert_allclose(F_t.numpy(), np.asarray(F_j), rtol=0, atol=1e-4)
    # the gate keeps most of the true matches
    assert inl_t.sum() >= 0.5 * mask.sum()


def test_few_valid_points_accept_every_valid_one():
    x0, x1 = _two_view(8, n=40)
    mask = np.zeros(40, bool)
    mask[[1, 5, 9, 13, 17, 21, 25, 29]] = True          # 8 < 9 valid
    key, g = _noise(8, 40)
    inl_j, _ = _jransac(jnp.asarray(x0), jnp.asarray(x1),
                                     jnp.asarray(mask), key, iters=ITERS,
                                     thresh=THRESH)
    tm = torch.from_numpy(mask)
    inl_t, _ = tr.ransac_fundamental(torch.from_numpy(x0), torch.from_numpy(x1), tm,
                                     tr.masked_categorical(tm, torch.from_numpy(g)),
                                     thresh=THRESH)
    np.testing.assert_array_equal(inl_t.numpy(), mask)
    np.testing.assert_array_equal(np.asarray(inl_j), mask)


PNP_ITERS = 48
PNP_THRESH = (10.0 / F_PX) ** 2
_jpnp = jax.jit(jr.ransac_pnp, static_argnames=("iters", "thresh", "min_inliers"))


def _pnp_problem(seed, n=120, outliers=0.3, noise_px=0.5, valid=0.85):
    """World points, normalized observations of a camera-from-world pose,
    with pixel noise, outliers and a validity mask; and that pose."""
    from lmono_tpu.utils.lie import mat_to_quat

    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-10, 10, n), rng.uniform(-4, 4, n),
                  rng.uniform(6, 35, n)], -1) + [30.0, -5.0, 2.0]
    a = rng.normal(size=3) * 0.1
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    R = np.eye(3) + K + K @ K / 2
    U, _, Vt = np.linalg.svd(R)
    R = U @ Vt
    t = -R @ np.array([30.0, -5.0, 2.0]) + rng.normal(size=3) * 0.5
    Pc = X @ R.T + t
    x = Pc[:, :2] / Pc[:, 2:] + rng.normal(0, noise_px / F_PX, (n, 2))
    bad = rng.random(n) < outliers
    x[bad] = rng.uniform(-0.5, 0.5, (int(bad.sum()), 2))
    q = np.asarray(mat_to_quat(jnp.asarray(R, jnp.float32)))
    return (X.astype(np.float32), x.astype(np.float32), rng.random(n) < valid,
            t.astype(np.float32), q)


def test_dlt_pnp_matches():
    X, x, _, _, _ = _pnp_problem(0, n=6, outliers=0.0, noise_px=0.0)
    Rj, tj = jax.jit(jr._dlt_pnp)(jnp.asarray(X), jnp.asarray(x))
    Rt, tt = tr._dlt_pnp(torch.from_numpy(X), torch.from_numpy(x))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-4)


@pytest.mark.parametrize("seed,prior,valid", [(1, True, 0.85), (2, False, 0.85),
                                              (3, True, 0.04)])
def test_ransac_pnp_matches(seed, prior, valid):
    from lmono_tpu.utils.lie import Pose as JPose
    from lmono_tpu_torch.utils.lie import Pose as TPose

    X, x, mask, t, q = _pnp_problem(seed, valid=valid)
    key = jax.random.PRNGKey(seed)
    # a prior off by half a metre, as a revisit's old keyframe pose is
    pj = JPose(jnp.asarray(t + 0.5), jnp.asarray(q)) if prior else None
    pose, inl, ok = _jpnp(jnp.asarray(X), jnp.asarray(x), jnp.asarray(mask), key,
                          iters=PNP_ITERS, thresh=PNP_THRESH, min_inliers=5, prior_pose=pj)
    g = torch.from_numpy(np.asarray(jax.random.gumbel(key, (PNP_ITERS, 6, X.shape[0]))))
    pt = TPose(torch.from_numpy(t + 0.5), torch.from_numpy(q)) if prior else None
    tpose, tinl, tok = tr.ransac_pnp(torch.from_numpy(X), torch.from_numpy(x),
                                     torch.from_numpy(mask), g, thresh=PNP_THRESH,
                                     min_inliers=5, prior_pose=pt)
    assert bool(tok) == bool(ok)
    if valid < 0.5:
        # ~5 valid points: the samples repeat points, the DLT systems are
        # rank-deficient and rounding picks their nullspace (ROADMAP
        # Queue 3, `_qr_nullvec`); only the verdict is held
        assert not bool(ok)
        return
    np.testing.assert_allclose(tpose.t.numpy(), np.asarray(pose.t), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tpose.q.numpy(), np.asarray(pose.q), rtol=0, atol=1e-4)
    Pc = np.asarray(pose.apply(jnp.asarray(X)))
    e2 = np.sum((Pc[:, :2] / np.maximum(Pc[:, 2:], 1e-6) - x) ** 2, -1)
    near = np.abs(e2 - PNP_THRESH) < 1e-5 * PNP_THRESH
    np.testing.assert_array_equal(tinl.numpy()[~near], np.asarray(inl)[~near])
    assert bool(ok) and int(inl.sum()) > 40
    np.testing.assert_allclose(np.asarray(pose.t), t, atol=0.05)


def test_ransac_pnp_batches_over_leading_dims():
    """Two problems stacked equal the two run alone."""
    from lmono_tpu_torch.utils.lie import Pose as TPose

    probs = [_pnp_problem(s) for s in (4, 5)]
    gen = torch.Generator().manual_seed(0)
    g = tr.gumbel_noise((2, PNP_ITERS, 6, 120), gen)
    prior = TPose(torch.from_numpy(np.stack([p[3] + 0.3 for p in probs])),
                  torch.from_numpy(np.stack([p[4] for p in probs])))
    both = tr.ransac_pnp(*(torch.from_numpy(np.stack([p[i] for p in probs]))
                           for i in range(3)), g, thresh=PNP_THRESH, prior_pose=prior)
    for b in range(2):
        one = tr.ransac_pnp(*(torch.from_numpy(probs[b][i]) for i in range(3)), g[b],
                            thresh=PNP_THRESH, prior_pose=TPose(prior.t[b], prior.q[b]))
        np.testing.assert_allclose(both[0].t[b].numpy(), one[0].t.numpy(), atol=1e-5)
        assert torch.equal(both[1][b], one[1]) and bool(both[2][b]) == bool(one[2])
