"""Fundamental-matrix RANSAC of the port (`lmono_tpu_torch.ops.ransac`)
against `lmono_tpu.ops.ransac`, on the same numpy correspondences and the
same random draws: the port takes the Gumbel noise that
`jax.random.categorical` adds to its logits.

Tolerances: the draws equal; the QR nullspace vector within 1e-5 and the
power-iteration one within 1e-4 (f32 sums in another order); F within
1e-4 and Sampson distances within 1e-3 relative (plus 1e-12); the inlier
masks equal except points whose Sampson distance lies within 1e-3
relative of the threshold (printed).
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
