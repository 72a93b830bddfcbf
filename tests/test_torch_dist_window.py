"""The port's landmark-sharded window LM (`parallel/dist_window.py`) and its
combined distributed step (`parallel/dist_ba.py`) on four gloo ranks
spawned once (`tests/torch_dist_cases.py:window_suite` and `step_suite`),
against the JAX package's on four virtual CPU devices:

* `make_sharded_solve` on the same window (`dist_ba.demo_window`,
  converted by `convert.window_state_from_numpy` and cut to each rank's
  rows): the same number of LM attempts, the costs and the solved window
  within tests/test_dist_window.py's tolerances, the cost brought down by
  1e3.  A `max_tracks` that does not split over the ranks raises;
* `make_distributed_step` on the port's `demo_inputs` (each rank's part
  cut by `inputs_shardings`) against the JAX `make_distributed_step` on
  the same inputs: the feature counts equal, the KNN within
  `sharded_knn`'s tolerances with the same index sets, the window and
  depths within the JAX multichip dry run's tolerances
  (`__graft_entry__.dryrun_multichip`), the pose graph within
  examples/run_multihost.py's 5% of the correction;
* the port's `demo_graph` against the JAX one (within 1e-4), and its
  `demo_window`: the same fields, shapes and truth, and a problem the
  dense solve brings down by 1e3.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import torch_dist_cases as cases
from lmono_tpu.config import EstimatorConfig as JEstimatorConfig
from lmono_tpu.config import LidarConfig as JLidarConfig
from lmono_tpu.parallel import make_mesh
from lmono_tpu.estimator.window import WindowState as JWindowState
from lmono_tpu.loop.posegraph import PoseGraph as JPoseGraph
from lmono_tpu.parallel.dist_ba import demo_graph as jdemo_graph
from lmono_tpu.parallel.dist_ba import demo_window
from lmono_tpu.parallel.dist_ba import graph_shardings as jgraph_shardings
from lmono_tpu.parallel.dist_ba import make_distributed_step as jmake_distributed_step
from lmono_tpu.parallel.dist_window import make_sharded_solve, window_shardings
from lmono_tpu.utils.lie import boxminus
from lmono_tpu_torch.config import EstimatorConfig, LidarConfig
from lmono_tpu_torch.estimator.solver import solve_window
from lmono_tpu_torch.parallel.dist_ba import demo_inputs as port_demo_inputs
from lmono_tpu_torch.parallel.dist_ba import demo_window as port_demo_window

RANKS = 4
EST = dict(window_size=6, max_tracks=48, gn_iters=4)
# the distributed step's configs: the JAX multichip dry run's
BA_LIDAR = dict(num_rings=32, horiz_res=512, max_range=60.0,
                max_edge_features=128, max_planar_features=256)
BA_EST = dict(window_size=6, max_tracks=6 * RANKS, gn_iters=4)


@functools.lru_cache(maxsize=None)
def _window():
    return jax.tree.map(np.asarray, demo_window(JEstimatorConfig(**EST)))


@functools.lru_cache(maxsize=None)
def _jax_sharded():
    cfg = JEstimatorConfig(**EST)
    mesh = make_mesh(RANKS, axis="kf")
    out = make_sharded_solve(mesh, cfg, axis="kf")(
        jax.tree.map(jax.device_put, _window(), window_shardings(mesh, "kf")))
    return jax.tree.map(np.asarray, out)


@functools.lru_cache(maxsize=None)
def _ba_inputs() -> tuple:
    """The port's global demo inputs (CPU)."""
    return port_demo_inputs(RANKS, LidarConfig(**BA_LIDAR), EstimatorConfig(**BA_EST),
                            device="cpu")


def _as_jax(x, like):
    """A port tensor or NamedTuple of them as the JAX package's `like`,
    field by field, in its dtypes."""
    if hasattr(like, "_fields"):
        return type(like)(*(_as_jax(getattr(x, f), getattr(like, f)) for f in like._fields))
    return np.asarray(x.numpy(), dtype=np.asarray(like).dtype)


@functools.lru_cache(maxsize=None)
def _jax_step() -> dict:
    mesh = make_mesh(RANKS, axis="kf")
    lid, est = JLidarConfig(**BA_LIDAR), JEstimatorConfig(**BA_EST)
    step, _ = jmake_distributed_step(mesh, lid, est, axis="kf")
    g, pts, rng, valid, query, bank, bank_mask, window = _ba_inputs()
    g = _as_jax(g, JPoseGraph.empty(g.t.shape[0], g.loop_i.shape[0]))
    window = _as_jax(window, JWindowState.init(est))
    shard, repl = NamedSharding(mesh, P("kf")), NamedSharding(mesh, P())
    out = step(jax.tree.map(jax.device_put, g, jgraph_shardings(mesh, "kf")),
               *(jax.device_put(x.numpy(), shard) for x in (pts, rng, valid)),
               jax.device_put(query.numpy(), repl), jax.device_put(bank.numpy(), shard),
               jax.device_put(bank_mask.numpy(), shard),
               jax.tree.map(jax.device_put, window, window_shardings(mesh, "kf")))
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def runs():
    runs = cases.run_groups({"kf": (cases.several, RANKS, ({
        "window": (cases.window_suite, (cases.plain(_window()), EST)),
        "step": (cases.step_suite, (_ba_inputs(), BA_LIDAR, BA_EST))},))},
        timeout_s=240, meanwhile=lambda: (_jax_sharded(), _jax_step()))["kf"]
    return {k: [r[k] for r in runs] for k in ("window", "step")}


@pytest.fixture
def ranks(runs):
    return runs["window"]


@pytest.fixture
def steps(runs):
    return runs["step"]


def test_sharded_solve_matches_jax(ranks):
    jout, jdiag = _jax_sharded()
    for r in ranks:
        assert r["rows"] == EST["max_tracks"] // RANKS
        for want, wdiag in ((jout, jdiag),):
            assert r["iters"] == int(wdiag.iters)
            np.testing.assert_allclose(r["cost0"], float(wdiag.cost0), rtol=1e-4)
            np.testing.assert_allclose(r["cost1"], float(wdiag.cost1), rtol=1e-3, atol=1e-4)
            np.testing.assert_allclose(r["t"].numpy(), want.t, rtol=1e-4, atol=1e-4)
            q_gap = np.abs(np.asarray(jax.vmap(boxminus)(want.q, r["q"].numpy()))).max()
            assert q_gap < 1e-4, q_gap
            np.testing.assert_allclose(r["ex_t"].numpy(), want.ex_t, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(r["inv_depth"].numpy(), want.feats.inv_depth,
                                       rtol=1e-3, atol=1e-4)
        assert r["cost1"] < 1e-3 * r["cost0"]
        np.testing.assert_array_equal(r["t"].numpy(), ranks[0]["t"].numpy())


def test_sharded_solve_divisibility_error(ranks):
    for r in ranks:
        assert r["error"] is not None and "max_tracks=50" in r["error"]


def _window_close(got: dict, want: dict) -> None:
    """The dry run's window tolerances (`dryrun_multichip`)."""
    np.testing.assert_allclose(np.asarray(got["win_t"]), want["win_t"], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(got["win_ex_t"]), want["win_ex_t"],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(got["win_inv_depth"]), want["win_inv_depth"],
                               rtol=5e-3, atol=1e-3)
    assert int(got["win_iters"]) == int(want["win_iters"])


def test_distributed_step_matches_jax(steps):
    want = _jax_step()
    g = _ba_inputs()[0]
    for r in steps:
        assert int(r["n_edge"]) == int(want["n_edge"]) > 0
        assert int(r["n_planar"]) == int(want["n_planar"]) > 0
        d2, idx = r["knn_d2"].numpy(), r["knn_idx"].numpy()
        np.testing.assert_allclose(np.sort(d2, 1), np.sort(want["knn_d2"], 1),
                                   rtol=1e-4, atol=1e-3)
        for q in range(d2.shape[0]):
            assert set(idx[q].tolist()) == set(want["knn_idx"][q].tolist())
        # examples/run_multihost.py's gate: within 5% of the correction.
        # Four GN steps of 24 float32 CG steps on this circuit move by a few
        # percent of the correction under rounding alone (the JAX package's
        # own sharded and single-device optimizers part by 3.1% on it)
        drift = np.linalg.norm(g.t.numpy() - want["graph_t"], axis=-1).max()
        gap = np.linalg.norm(r["graph_t"].numpy() - want["graph_t"], axis=-1).max()
        assert gap < max(0.05 * drift, 1e-3) and drift > 0.1, (gap, drift)
        # the dry run's window and depth tolerances
        np.testing.assert_allclose(r["win_t"].numpy(), want["win_t"], rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(r["win_ex_t"].numpy(), want["win_ex_t"],
                                   rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(r["win_inv_depth"].numpy(), want["win_inv_depth"],
                                   rtol=5e-3, atol=1e-3)
        assert int(r["win_iters"]) == int(want["win_iters"])
        for k in ("graph_t", "win_t", "knn_idx"):
            assert torch.equal(r[k], steps[0][k])


def test_demo_graph_matches_jax():
    """The port's `demo_graph` is the JAX package's drifted circuit (its
    index fields are the port's int64)."""
    want = jdemo_graph(RANKS)
    got = _ba_inputs()[0]
    for k in got._fields:
        a, b = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, k
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, atol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


def test_demo_window_matches_jax():
    jw = _window()
    pw = port_demo_window(EstimatorConfig(**EST))

    def leaves(w):
        return {**{f"feats.{k}": v for k, v in w.feats._asdict().items()},
                **{f"prior.{k}": v for k, v in w.prior._asdict().items()},
                **{k: v for k, v in w._asdict().items() if k not in ("feats", "prior")}}

    jl, pl = leaves(jw), leaves(pw)
    assert jl.keys() == pl.keys()
    for k in jl:
        assert tuple(pl[k].shape) == jl[k].shape, k
        assert str(pl[k].dtype).removeprefix("torch.") == str(jl[k].dtype), k
    # the truth trajectory, the extrinsic and the bookkeeping are the same
    for k in ("lt", "lq", "ex_t", "ex_q"):
        np.testing.assert_allclose(pl[k].numpy(), jl[k], atol=1e-6, err_msg=k)
    for k in ("count", "initialized", "feats.ids", "feats.depth_ok", "feats.alive"):
        np.testing.assert_array_equal(pl[k].numpy(), jl[k], err_msg=k)
    # the gauge frame stays at the truth, the others are knocked off it
    assert torch.equal(pw.t[0], pw.lt[0])
    assert float(torch.linalg.vector_norm(pw.t[1:] - pw.lt[1:], dim=-1).min()) > 1e-3
    torch.set_num_threads(1)
    _, diag = solve_window(pw, EstimatorConfig(**EST))
    assert float(diag.cost1) < 1e-3 * float(diag.cost0)
