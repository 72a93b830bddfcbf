"""The port's node-sharded pose graph (`parallel/dist_posegraph.py`) on four
gloo ranks (`tests/torch_dist_cases.py:posegraph_suite`), 4-DoF and 6-DoF,
on a 64-node drifted circuit whose three loop edges join nodes of
different ranks' blocks, against the JAX package's sharded optimizer on
four virtual CPU devices and the port's single-rank `optimize_posegraph`:
the solutions within 5% of the input error of each other
(tests/test_dist_posegraph.py's bar: 8 GN / 60 CG steps leave the graph
unconverged), the solve bringing the error below 0.8 of the input's and
within 5% of the reference solve's.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from lmono_tpu.loop.posegraph import PoseGraph as JPoseGraph
from lmono_tpu.loop.posegraph import graph_add_loop as jgraph_add_loop
from lmono_tpu.loop.posegraph import graph_add_node as jgraph_add_node
from lmono_tpu.parallel import make_mesh
from lmono_tpu.parallel.dist_ba import graph_shardings
from lmono_tpu.parallel.dist_posegraph import make_sharded_posegraph_opt as jmake_opt
from lmono_tpu.utils.lie import Pose as JPose
from lmono_tpu.utils.lie import mat_to_quat, so3_exp_quat, ypr_to_mat
from lmono_tpu_torch.convert import posegraph_from_numpy
from lmono_tpu_torch.loop.posegraph import optimize_posegraph
from lmono_tpu_torch.parallel.launch import run_ranks

RANKS, N = 4, 64
ITERS, CG_ITERS = 8, 60


@functools.lru_cache(maxsize=None)
def _circuit():
    """tests/test_dist_posegraph.py's drifted circuit: odometry drift in
    translation and yaw, loop edges k → N−1−2k to the truth."""
    theta = np.linspace(0, 2 * np.pi, N)
    gt_t = np.stack([12 * np.cos(theta), 12 * np.sin(theta),
                     1.5 * np.sin(2 * theta)], -1).astype(np.float32)
    gt_ypr = np.stack([theta + np.pi / 2, 0.12 * np.sin(theta),
                       0.08 * np.cos(theta)], -1).astype(np.float32)
    gt = [JPose(jnp.asarray(gt_t[i]), mat_to_quat(ypr_to_mat(jnp.asarray(gt_ypr[i]))))
          for i in range(N)]
    bias = JPose(jnp.array([0.0, 0.01, 0.004]),
                 so3_exp_quat(jnp.array([0.0003, 0.0003, 0.003])))
    odo = [gt[0]]
    for i in range(1, N):
        odo.append(odo[-1].compose(gt[i - 1].between(gt[i]).compose(bias)))
    g = JPoseGraph.empty(N, 16)
    for p in odo:
        g = jgraph_add_node(g, p)
    for k in range(3):
        g = jgraph_add_loop(g, k, N - 1 - 2 * k, gt[k].between(gt[N - 1 - 2 * k]))
    return jax.tree.map(np.asarray, g), gt_t


@functools.lru_cache(maxsize=None)
def _jax_sharded(four_dof: bool) -> np.ndarray:
    g, _ = _circuit()
    mesh = make_mesh(RANKS, axis="kf")
    opt = jmake_opt(mesh, iters=ITERS, cg_iters=CG_ITERS, four_dof=four_dof, axis="kf")
    return np.asarray(opt(jax.tree.map(jax.device_put, g, graph_shardings(mesh, "kf"))).t)


@pytest.fixture(scope="module")
def ranks():
    g, _ = _circuit()
    # the JAX package's optimizers compile while the ranks run
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(run_ranks, cases.posegraph_suite, RANKS,
                        (cases.plain(g), ITERS, CG_ITERS), timeout_s=240)
        for four_dof in (True, False):
            _jax_sharded(four_dof)
        return fut.result()


@pytest.mark.parametrize("four_dof", [True, False], ids=["4dof", "6dof"])
def test_sharded_posegraph_matches(ranks, four_dof):
    g, gt_t = _circuit()
    loop_i, loop_j = g.loop_i[:3], g.loop_j[:3]
    assert np.all(loop_i // (N // RANKS) != loop_j // (N // RANKS))   # across ranks
    torch.set_num_threads(1)
    single = optimize_posegraph(posegraph_from_numpy(g)[0], iters=ITERS,
                                cg_iters=CG_ITERS, four_dof=four_dof).t.numpy()
    jax_t = _jax_sharded(four_dof)
    err_in = np.linalg.norm(g.t - gt_t, axis=-1).max()
    for r in ranks:
        assert r["nodes"] == N // RANKS
        t = r[four_dof][0].numpy()
        np.testing.assert_array_equal(t, ranks[0][four_dof][0].numpy())
        for other in (jax_t, single):
            gap = np.linalg.norm(t - other, axis=-1).max()
            assert gap < 0.05 * err_in, (gap, err_in)
        err_out = np.linalg.norm(t - gt_t, axis=-1).max()
        err_ref = np.linalg.norm(jax_t - gt_t, axis=-1).max()
        assert err_out < 0.8 * err_in, (err_in, err_out)
        assert err_out < err_ref + 0.05 * err_in
