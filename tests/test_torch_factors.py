"""The port's window factors (`lmono_tpu_torch.estimator.factors`) against
`lmono_tpu.estimator.factors`, on window problems made from a seed with
numpy: exact and perturbed, full and partly filled, with and without a
marginalization prior, the extrinsic prior frozen and refining.

Tolerances: residuals within 1e-5·max|r| + 1e-4; the `torch.func.jacfwd`
Jacobian of `all_residuals` within 1e-4·max|J| of `jax.jacfwd`'s, and
`factors.jacobian`'s (the constants lifted to duals) equal to it; active
masks and robust weights' zero pattern equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from lmono_tpu.estimator import factors as jf
from lmono_tpu_torch.estimator import factors as tf
from torch_estimator_cases import (
    CFG,
    jitted,
    one_torch_thread,
    perturb,
    to_port,
    window_problem,
)

R_RTOL, R_ATOL = 1e-5, 1e-4
J_RTOL = 1e-4
CASES = {
    "exact": dict(seed=0),
    "perturbed": dict(seed=1, perturbed=True),
    "partial-with-prior": dict(seed=2, perturbed=True, count=3, prior=True),
    "prior-frozen": dict(seed=3, perturbed=True, prior=True, frozen=True),
}


def _case(name):
    c = CASES[name]
    js, _ = window_problem(seed=c["seed"], count=c.get("count"),
                           prior=c.get("prior", False))
    if c.get("perturbed"):
        js = perturb(js, seed=c["seed"] + 10)
    cfg = dataclasses.replace(CFG, fine_times=0) if c.get("frozen") else CFG
    # a few features off the solvable set
    js = js._replace(feats=js.feats._replace(
        depth_ok=js.feats.depth_ok.at[::7].set(False),
        alive=js.feats.alive.at[3::11].set(False)))
    return js, to_port(js), cfg


def _close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=0,
                               atol=R_RTOL * np.abs(j).max() + R_ATOL)


def _delta(js, seed):
    w1, M = js.t.shape[0], js.feats.inv_depth.shape[0]
    rng = np.random.default_rng(seed)
    d = np.concatenate([0.01 * rng.normal(size=6 * w1 + 6),
                        0.005 * rng.normal(size=M)]).astype(np.float32)
    return jnp.asarray(d), torch.from_numpy(d)


@pytest.mark.parametrize("name", list(CASES))
def test_residuals_match(name):
    js, ts, cfg = _case(name)
    dj, dt = _delta(js, 7)
    rj = jf.retract_window(js, dj)
    rt = tf.retract_window(ts, dt)
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    _close(tf.laser_residuals(rt[0], rt[1], ts, cfg), jf.laser_residuals(rj[0], rj[1], js, cfg))
    r_t, a_t = tf.reprojection_residuals(*rt, ts, cfg)
    r_j, a_j = jf.reprojection_residuals(*rj, js, cfg)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    _close(r_t, r_j)
    _close(tf.extrinsic_prior_residual(rt[2], rt[3], ts, cfg),
           jf.extrinsic_prior_residual(rj[2], rj[3], js, cfg))
    _close(tf.marg_prior_residuals(*rt[:4], ts), jf.marg_prior_residuals(*rj[:4], js))
    _close(tf.gauge_residual(rt[0], rt[1], ts), jf.gauge_residual(rj[0], rj[1], js))
    w_t, w_j = tf.cauchy_weights(ts, cfg), jf.cauchy_weights(js, cfg)
    np.testing.assert_array_equal(w_t.numpy() > 0, np.asarray(w_j) > 0)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-5, atol=1e-6)
    _close(tf.all_residuals(dt, ts, cfg, w_t), jf.all_residuals(dj, js, cfg, w_j))
    if name == "exact":
        assert float(tf.all_residuals(0 * dt, ts, cfg, w_t).abs().max()) < 2e-2


def _jax_jacobian(d0, js, w, cfg):
    return jax.jacfwd(lambda d: jf.all_residuals(d, js, cfg, w))(d0)


@pytest.mark.parametrize("name", list(CASES))
def test_jacobian_matches(name):
    js, ts, cfg = _case(name)
    w_j = jf.cauchy_weights(js, cfg)
    w_t = torch.from_numpy(np.array(w_j))
    D = 6 * js.t.shape[0] + 6 + js.feats.inv_depth.shape[0]
    Jj = np.asarray(jitted(_jax_jacobian, cfg)(jnp.zeros(D), js, w_j))
    Jt = jacfwd(lambda d: tf.all_residuals(d, ts, cfg, w_t))(torch.zeros(D)).numpy()
    assert Jt.shape == Jj.shape
    np.testing.assert_allclose(Jt, Jj, rtol=0, atol=J_RTOL * np.abs(Jj).max())
    # the solver's Jacobian (constants lifted to duals) is the same, bit for bit
    Jl = tf.jacobian(lambda d, s, w: tf.all_residuals(d, s, cfg, w), (ts, w_t),
                     torch.zeros(D))
    assert torch.equal(Jl, torch.from_numpy(Jt))
    # every pose and the extrinsic are reached, and every solvable depth
    P = 6 * js.t.shape[0] + 6
    solvable = np.asarray(js.feats.depth_ok & js.feats.alive)
    np.testing.assert_array_equal(np.abs(Jt).sum(0) > 0,
                                  np.concatenate([np.ones(P, bool), solvable]))
