"""The port's marginalization (`lmono_tpu_torch.estimator.marginalization`)
against `lmono_tpu.estimator.marginalization`, on window problems made from
a seed with numpy, without and with an earlier prior.

The √-form prior (J, r0) comes from `eigh` and is defined only up to
eigenvector signs and rotations inside repeated eigenvalues, so it is
compared by what the solver sees of it: the information Jᵀ J and the
gradient Jᵀ r0, each within 1e-4 of its largest entry, and r0ᵀ r0 within
1e-4 relative.  The linearization point and `valid` are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmono_tpu.estimator import marginalization as jm
from lmono_tpu_torch.estimator import factors as tf
from lmono_tpu_torch.estimator import marginalization as tm
from torch_estimator_cases import (
    CFG,
    jitted,
    one_torch_thread,
    perturb,
    to_port,
    window_problem,
)

RTOL = 1e-4


def _info(J, r0):
    J, r0 = np.asarray(J, np.float64), np.asarray(r0, np.float64)
    return J.T @ J, J.T @ r0, r0 @ r0


@pytest.mark.parametrize("prior", [False, True])
def test_marginalize_oldest_matches(prior):
    jstate = perturb(window_problem(seed=11, prior=prior)[0], seed=12,
                     dp=0.01, dth=0.002, ddepth=0.02)
    # some features anchored at slot 1, some unsolvable
    feats = jstate.feats
    jstate = jstate._replace(feats=feats._replace(
        anchor=feats.anchor.at[:5].set(jnp.maximum(feats.anchor[:5], 1)),
        depth_ok=feats.depth_ok.at[5::9].set(False)))
    j = jitted(jm.marginalize_oldest, CFG)(jstate)
    t = tm.marginalize_oldest(to_port(jstate), CFG)
    HJ, gJ, cJ = _info(j.J, j.r0)
    HT, gT, cT = _info(t.J.numpy(), t.r0.numpy())
    np.testing.assert_allclose(HT, HJ, rtol=0, atol=RTOL * np.abs(HJ).max())
    np.testing.assert_allclose(gT, gJ, rtol=0, atol=RTOL * np.abs(gJ).max())
    np.testing.assert_allclose(cT, cJ, rtol=RTOL)
    for f in ("lin_t", "lin_q", "lin_ex_t", "lin_ex_q", "valid"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f)
    # post-slide indexing: the newest slot and old pose 0 carry no information
    P = t.J.shape[0]
    assert np.abs(HT[P - 12:P - 6]).max() == 0.0
    assert np.abs(HT[:6, :6]).max() > 0.0


def test_prior_cost_matches_at_a_displaced_state():
    """The two √-forms charge a displaced state the same prior cost (it
    depends on Jᵀ J, Jᵀ r0 and r0ᵀ r0 only)."""
    jstate = perturb(window_problem(seed=13)[0], seed=14, dp=0.01, dth=0.002,
                     ddepth=0.02)
    priors = {"jax": jitted(jm.marginalize_oldest, CFG)(jstate),
              "port": tm.marginalize_oldest(to_port(jstate), CFG)}
    moved = to_port(perturb(window_problem(seed=13)[0], seed=15, dp=0.01, dth=0.002))
    cost = {}
    for name, pr in priors.items():
        pr = type(priors["port"])(*(torch.as_tensor(np.array(x)) for x in pr))
        st = moved._replace(prior=pr)
        r = tf.marg_prior_residuals(st.t, st.q, st.ex_t, st.ex_q, st)
        cost[name] = float(torch.sum(r.double() ** 2))
    np.testing.assert_allclose(cost["port"], cost["jax"], rtol=1e-3)
    assert cost["port"] > 0.0


def test_eigh_failure_gives_nans_as_the_reference():
    """Where LAPACK fails to converge (a NaN matrix does it), torch raises
    and JAX returns NaNs; the port's `_eigh` returns NaNs too, so a
    marginalization goes on as the reference's does."""
    S = np.full((6, 6), np.nan, np.float32)
    lam_j, U_j = jnp.linalg.eigh(jnp.asarray(S))
    lam_t, U_t = tm._eigh(torch.from_numpy(S))
    assert lam_t.shape == (6,) and U_t.shape == (6, 6)
    assert np.isnan(np.asarray(lam_j)).all() and torch.isnan(lam_t).all()
    assert np.isnan(np.asarray(U_j)).all() and torch.isnan(U_t).all()
    S = np.diag(np.arange(1.0, 7.0)).astype(np.float32)
    np.testing.assert_array_equal(tm._eigh(torch.from_numpy(S))[0].numpy(),
                                  np.arange(1.0, 7.0, dtype=np.float32))
