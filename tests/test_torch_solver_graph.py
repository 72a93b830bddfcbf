"""The window solve's CUDA graph (`solver._AttemptGraph`, what
`solve_window` runs on a CUDA tensor) against the same solve with every
attempt's kernels issued one by one (`solver._solve_eager`), on the card.

Window problems are made from a seed with torch alone (an exact window as
`tests/torch_estimator_cases.py:window_problem` makes it, then its poses
and depths perturbed), at the kitti (150 slots) and synthetic (96 slots)
widths with a window of 10.  The graph replays the eager attempt's kernels
on the same inputs, so the attempts and reads are equal, the costs equal
and the state within 1e-6.  This file imports no JAX; on the card:

    python -m pytest tests/test_torch_solver_graph.py -m gpu --noconftest -q
"""

import dataclasses

import pytest
import torch

from lmono_tpu_torch.config import EstimatorConfig
from lmono_tpu_torch.estimator import solver
from lmono_tpu_torch.estimator.window import FeatureTable, WindowState
from lmono_tpu_torch.io.synthetic import synthetic_T_CL
from lmono_tpu_torch.utils import lie

KITTI = EstimatorConfig(window_size=10, max_tracks=150, estimate_laser=1,
                        fine_times=1000)
SYNTHETIC = dataclasses.replace(KITTI, max_tracks=96)
ATOL = 1e-6


def window(cfg: EstimatorConfig, seed: int, device, dp=0.02, dth=0.004,
           ddepth=0.05, noise=1e-3) -> WindowState:
    """A full window of smooth forward motion with a modulated twist and a
    landmark cloud ahead, its poses (not slot 0) and depths perturbed and
    its observations noisy (so that the solve converges to a floor)."""
    g = torch.Generator().manual_seed(seed)
    W1, M = cfg.window_size + 1, cfg.max_tracks
    s = torch.arange(W1, dtype=torch.float32)
    t = torch.stack([s, 0.02 * s ** 2, torch.zeros_like(s)], -1)
    y = 0.02
    q = lie.so3_exp_quat(torch.stack([
        0.2 * y * s + 0.1 * y * torch.sin(1.7 * s),
        0.5 * y * s - 0.2 * y * torch.cos(1.3 * s),
        y * s + 0.3 * y * torch.sin(0.9 * s)], -1))
    T_CL = synthetic_T_CL()

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(M, generator=g)

    lm = torch.stack([uniform(5.0, 25.0), uniform(-8.0, 8.0),
                      uniform(-8.0, 8.0) * 0.3 + 1.0], -1)
    p_c = T_CL.apply(lie.quat_rotate_inv(q[None], lm[:, None] - t[None]))
    obs, z = p_c[..., :2] / p_c[..., 2:3], p_c[..., 2]
    obs = obs + noise * torch.randn(obs.shape, generator=g)
    obs_mask = z > 1.0
    anchor = torch.argmax(obs_mask.to(torch.int32), dim=1)
    inv_depth = 1.0 / z[torch.arange(M), anchor]
    d_t = dp * torch.randn(W1, 3, generator=g)
    d_th = dth * torch.randn(W1, 3, generator=g)
    d_t[0] = d_th[0] = 0.0
    scale = 1.0 + ddepth * torch.randn(M, generator=g)
    state = WindowState.init(cfg, T_CL)._replace(
        t=t + d_t, q=lie.boxplus(q, d_th), lt=t, lq=q,
        feats=FeatureTable(
            ids=torch.arange(M, dtype=torch.int32), anchor=anchor.to(torch.int32),
            obs=obs, obs_mask=obs_mask, inv_depth=inv_depth * scale,
            depth_ok=torch.ones(M, dtype=torch.bool),
            alive=torch.ones(M, dtype=torch.bool)),
        count=torch.tensor(W1, dtype=torch.int32),
        initialized=torch.ones((), dtype=torch.bool))
    return solver._tree_map(lambda x: x.to(device), state)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def graphs_of(cfg: EstimatorConfig, dev) -> list:
    key = solver._graph_key(window(cfg, 0, dev), cfg)
    return [g for k, g in solver._GRAPHS.items() if k == key]


def graphed_against_eager(state: WindowState, cfg: EstimatorConfig):
    """Both solves of `state` (`chip_smoke.graph_against_eager`); asserts
    equal attempts, reads and costs and the state within ATOL, returns
    (graphed diag, eager diag, bitwise)."""
    import chip_smoke

    both = chip_smoke.graph_against_eager(state, cfg)
    (g_st, g), (_, e) = both["graphed"], both["eager"]
    assert (g.iters, g.readbacks) == (e.iters, e.readbacks)
    assert g.replayed == g.iters and e.replayed == 0
    assert both["costs_equal"] and both["max_diff"] <= ATOL
    # what the attempt leaves alone comes back as it went in
    moved = (g_st.t, g_st.q, g_st.ex_t, g_st.ex_q, g_st.feats.inv_depth)
    for a, b in zip(solver._leaves(g_st), solver._leaves(state)):
        if not any(a is x for x in moved):
            assert torch.equal(a, b)
    return g, e, both["bitwise"]


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [KITTI, SYNTHETIC], ids=["150", "96"])
def test_graphed_solve_matches_eager(dev, cfg):
    g, e, bitwise = graphed_against_eager(window(cfg, 5, dev), cfg)
    print(f"{cfg.max_tracks} slots: {g.iters} attempts, bitwise {bitwise}")
    assert 1 < g.iters < cfg.gn_iters
    (graph,) = graphs_of(cfg, dev)
    # a second solve of another window replays the same graph only
    g2, _, _ = graphed_against_eager(window(cfg, 8, dev), cfg)
    assert graphs_of(cfg, dev) == [graph] and g2.replayed == g2.iters


@pytest.mark.gpu
def test_each_slot_count_captures_once(dev):
    for _ in range(2):
        for cfg in (KITTI, SYNTHETIC):
            _, diag = solver.solve_window(window(cfg, 3, dev), cfg)
            assert diag.replayed == diag.iters > 0
    assert len(graphs_of(KITTI, dev)) == len(graphs_of(SYNTHETIC, dev)) == 1
    assert graphs_of(KITTI, dev)[0] is not graphs_of(SYNTHETIC, dev)[0]


@pytest.mark.gpu
def test_solve_at_the_attempt_budget(dev):
    """A budget of 3 attempts: the graph of the default budget's
    configuration (the budget is the host loop's, not the graph's)."""
    cfg = dataclasses.replace(KITTI, gn_iters=3)
    g, _, _ = graphed_against_eager(window(cfg, 5, dev, dp=0.3, dth=0.05), cfg)
    assert (g.iters, g.readbacks, g.replayed) == (3, 2, 3)
    assert graphs_of(cfg, dev) == graphs_of(KITTI, dev)
    assert len(graphs_of(cfg, dev)) == 1


@pytest.mark.gpu
def test_another_config_captures_its_own_graph(dev):
    cfg = dataclasses.replace(KITTI, lm_step_max=0.05)
    state = window(cfg, 5, dev)
    graphed_against_eager(state, cfg)
    (graph,) = graphs_of(cfg, dev)
    assert graph not in graphs_of(KITTI, dev)
    # its clamp is in the graph: the default configuration's solve differs
    clamped, _ = solver.solve_window(state, cfg)
    free, _ = solver.solve_window(state, KITTI)
    assert not torch.equal(clamped.t, free.t)


@pytest.mark.gpu
def test_the_cache_keeps_the_newest_graphs(dev):
    """Six configurations that the captured kernels tell apart: the cache
    holds the most recently used `_MAX_GRAPHS`, and a solve that finds its
    graph gone captures it again, with the same result."""
    cfgs = [dataclasses.replace(SYNTHETIC, lm_step_max=1.0 + k) for k in range(6)]
    state = window(SYNTHETIC, 4, dev)
    first, _ = solver.solve_window(state, cfgs[0])
    for cfg in cfgs[1:]:
        solver.solve_window(state, cfg)
        assert len(solver._GRAPHS) <= solver._MAX_GRAPHS
    assert graphs_of(cfgs[0], dev) == [] and len(graphs_of(cfgs[-1], dev)) == 1
    again, diag = solver.solve_window(state, cfgs[0])
    assert diag.replayed == diag.iters and (again.t - first.t).abs().max() <= ATOL
