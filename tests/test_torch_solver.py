"""The port's window solver (`lmono_tpu_torch.estimator.solver`) against
`lmono_tpu.estimator.solver`, on window problems made from a seed with
numpy (`tests/test_window_solver.py`'s kind: an exact window whose poses and
depths are then perturbed).

Tolerances:
* one `_lm_step`: the step δ (recovered from the candidate as the local
  difference to the start) within 1e-3·‖δ‖, cost0 and cost1 within 1e-4
  relative;
* `solve_window`: poses within 1 mm and 1e-4 in q, LM attempts equal, and
  the same truth recovered as the JAX test asks (5 mm, 5e-3 rad);
* `outlier_rejection`: the masks equal.

On the CPU `solve_window` runs its attempts eagerly (no graph is captured,
`replayed` 0); the host loop both paths share (`_attempt_loop`) is checked
on its own.  The graphed solve is checked on the card
(`tests/test_torch_solver_graph.py`).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmono_tpu.estimator import solver as js_
from lmono_tpu.utils import lie as jl
from lmono_tpu_torch.estimator import solver as ts_
from lmono_tpu_torch.utils import lie as tl
from torch_estimator_cases import (
    CFG,
    jitted,
    one_torch_thread,
    perturb,
    to_port,
    window_problem,
)

STEP_RTOL = 1e-3
COST_RTOL = 1e-4
T_ATOL_M, Q_ATOL = 1e-3, 1e-4


def _local(s0, s1, lib):
    """Flat local difference s1 ⊟ s0 over poses, extrinsic and depths."""
    if lib is jl:
        cat, arr = jnp.concatenate, np.asarray
    else:
        cat, arr = torch.cat, (lambda x: x.numpy())
    poses = cat([s1.t - s0.t, lib.boxminus(s0.q, s1.q)], -1).reshape(-1)
    ex = cat([s1.ex_t - s0.ex_t, lib.boxminus(s0.ex_q, s1.ex_q)])
    return np.concatenate([arr(poses), arr(ex),
                           arr(s1.feats.inv_depth - s0.feats.inv_depth)])


@pytest.mark.parametrize("lam", [1e-5, 1e-1])
@pytest.mark.parametrize("prior", [False, True])
def test_lm_step_matches(lam, prior):
    # a moderate perturbation: cost1 is what is left after the step cancels
    # cost0, so its relative precision falls as cost0 / cost1 grows (a 0.1 m
    # perturbation puts that ratio at 6e2 and the two packages 1.4e-4 apart)
    jstate = perturb(window_problem(seed=1, prior=prior)[0], seed=2, dp=0.02,
                     dth=0.004)
    tstate = to_port(jstate)
    cj, c0j, c1j = jitted(js_._lm_step, CFG)(jstate, jnp.asarray(lam, jnp.float32))
    ct, c0t, c1t = ts_._lm_step(tstate, torch.tensor(lam), CFG)
    dj, dt = _local(jstate, cj, jl), _local(tstate, ct, tl)
    norm = np.linalg.norm(dj)
    assert norm > 1e-2
    assert np.linalg.norm(dt - dj) <= STEP_RTOL * norm
    np.testing.assert_allclose(float(c0t), float(c0j), rtol=COST_RTOL)
    np.testing.assert_allclose(float(c1t), float(c1j), rtol=COST_RTOL)
    assert float(c1t) < float(c0t)


@pytest.mark.parametrize("seed", [5, 8])
def test_solve_window_matches(seed):
    truth, _ = window_problem(seed=0)
    jstate = perturb(truth, seed=seed)
    jsol, jdiag = jitted(js_.solve_window, CFG)(jstate)
    tsol, tdiag = ts_.solve_window(to_port(jstate), CFG)
    np.testing.assert_allclose(tsol.t.numpy(), np.asarray(jsol.t), rtol=0, atol=T_ATOL_M)
    np.testing.assert_allclose(tsol.q.numpy(), np.asarray(jsol.q), rtol=0, atol=Q_ATOL)
    assert tdiag.iters == int(jdiag.iters)
    assert tdiag.readbacks == min(tdiag.iters, CFG.gn_iters - 1)
    assert tdiag.replayed == 0
    np.testing.assert_allclose(float(tdiag.cost1), float(jdiag.cost1), rtol=1e-3,
                               atol=1e-3)
    # the truth comes back, as tests/test_window_solver.py asks of the reference
    t_err = np.linalg.norm(tsol.t.numpy() - np.asarray(truth.t), axis=-1).max()
    q_err = np.linalg.norm(tl.boxminus(torch.from_numpy(np.array(truth.q)), tsol.q).numpy(),
                           axis=-1).max()
    assert t_err < 5e-3 and q_err < 5e-3


def test_attempt_budget_caps_the_readbacks():
    jstate = perturb(window_problem(seed=0)[0], seed=5)
    cfg = dataclasses.replace(CFG, gn_iters=2)
    _, jdiag = jitted(js_.solve_window, cfg)(jstate)
    _, tdiag = ts_.solve_window(to_port(jstate), cfg)
    assert tdiag.iters == int(jdiag.iters) == 2
    assert tdiag.readbacks == 1          # the last attempt's flag is not read


@pytest.mark.parametrize("gn_iters,done_at,iters,reads", [
    (4, 2, 2, 2),          # done read after the second attempt
    (4, None, 4, 3),       # never done: the last attempt's flag is not read
    (3, 3, 3, 2),          # done at the last allowed attempt, not read
    (1, None, 1, 0),
])
def test_lm_loop_reads_done_but_the_last(gn_iters, done_at, iters, reads):
    made = []

    def attempt(i):
        made.append(i)
        return (torch.tensor(i + 1 == done_at), torch.tensor(10.0 - i),
                torch.tensor(5.0 - i))

    cost0, cost, it, readbacks = ts_._attempt_loop(attempt, dataclasses.replace(
        CFG, gn_iters=gn_iters))
    assert made == list(range(iters)) and (it, readbacks) == (iters, reads)
    assert float(cost0) == 10.0 and float(cost) == 5.0 - (iters - 1)


def test_graph_key_follows_shapes_and_config():
    def key(cfg):
        return ts_._graph_key(ts_.WindowState.init(cfg, device="cpu"), cfg)

    wide = dataclasses.replace(CFG, max_tracks=150)
    assert key(CFG) == key(dataclasses.replace(CFG))
    assert len({key(CFG), key(wide), key(dataclasses.replace(CFG, window_size=6)),
                key(dataclasses.replace(CFG, lm_step_max=0.5))}) == 4
    # what only the host loop reads, or nothing, shares the graph
    assert key(CFG) == key(dataclasses.replace(CFG, gn_iters=3, lm_lambda_init=1.0,
                                               outlier_reproj_px=2.0))
    # the CPU keeps no graph
    before = dict(ts_._GRAPHS)
    _, diag = ts_.solve_window(to_port(perturb(window_problem(seed=0)[0], seed=5)),
                               dataclasses.replace(CFG, gn_iters=2))
    assert diag.replayed == 0 and ts_._GRAPHS == before


def test_graph_key_holds_every_field_the_attempt_reads():
    """Each configuration field one attempt reads (on the CPU, through a
    recording stand-in for the configuration) is in the graph's key, so no
    two configurations that the captured kernels tell apart share a graph."""
    read = set()

    class Recording:
        def __getattr__(self, name):
            read.add(name)
            return getattr(CFG, name)

    state = to_port(perturb(window_problem(seed=0)[0], seed=5))
    lam = torch.tensor(CFG.lm_lambda_init)
    ts_._attempt(state, lam, Recording())
    assert {"lm_step_max", "cauchy_c", "lm_cost_tol"} <= read
    assert read <= set(ts_._GRAPH_FIELDS), read - set(ts_._GRAPH_FIELDS)


def test_outlier_rejection_matches():
    jstate = perturb(window_problem(seed=3)[0], seed=4, dp=0.0, dth=0.0, ddepth=0.0)
    rng = np.random.default_rng(9)
    obs = np.array(jstate.feats.obs)
    obs[:6] += 0.05 * rng.normal(size=obs[:6].shape)       # gross outliers
    inv = np.array(jstate.feats.inv_depth)
    inv[40] = -0.1                                          # negative depth
    jstate = jstate._replace(feats=jstate.feats._replace(
        obs=jnp.asarray(obs, jnp.float32), inv_depth=jnp.asarray(inv)))
    j = jitted(js_.outlier_rejection, CFG)(jstate)
    t = ts_.outlier_rejection(to_port(jstate), CFG)
    np.testing.assert_array_equal(t.feats.alive.numpy(), np.asarray(j.feats.alive))
    np.testing.assert_array_equal(t.feats.depth_ok.numpy(), np.asarray(j.feats.depth_ok))
    assert int((~t.feats.alive).sum()) >= 7
