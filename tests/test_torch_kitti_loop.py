"""system-kitti's loop lane and graph lane against the JAX package, on what
a run of the cell on the card consumed (`tests/data/kitti_loop_lane.npz`,
made by `chip_perf.py --capture-loop` and replayed by
`tests/kitti_loop_lane.py`): KITTI-scale closures, 132 keyframes and 30
loop edges, which the CPU system test's 25-frame drive cannot reach.

Tolerances:
* The LiDAR refinement of three closures (K1 at 512×512 and 1024×1024 on
  the card, its plain version here): the port's `register` equals the JAX
  package's within the registration's bound, 1 cm and 1e-3 in q, and the
  card's result likewise.  Started from the simulator's truth instead of
  the PnP guess, the port's `register` ends where it ended from the guess
  (within 1 cm) on the closure whose result lies 0.31 m off the truth: that
  offset is the minimum of the registration's objective on these banks,
  not a failure to converge.  On the closure whose PnP guess was 7 m off,
  it ends within 0.2 m of the truth from the truth: the guess started it
  in another basin.
* The graph lane over the same detections with the port's solver at the
  JAX package's budget (`cg_iters=50`, the matrix-free CG that the sharded
  optimizer mirrors): 30 closures, 2 switched off; each pose-graph solve
  within 1e-4 m plus twice the reference's own spread (its result moved by
  a one-ulp change of its input, up to 0.1 m on these graphs) of the JAX
  package's solve of the same graph.
* The graph lane with the port's default solve (each GN step's normal
  equations solved exactly), which the system runs: every solve leaves at
  most 1e-3 of the cost reduction unmade against the benchmark's f64
  dense Gauss-Newton of the same graph (`slambench.steps.graph_excess`);
  the budgeted CG leaves up to 2.9 on graphs the benchmark's revisit
  reaches (PERF.md §6).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kitti_loop_lane as lane
from lmono_tpu.config import kitti_scale_config as jkitti_scale_config
from lmono_tpu.lidar.registration import register as jregister
from lmono_tpu.utils.lie import Pose as JPose
from lmono_tpu_torch.lidar.registration import register
from lmono_tpu_torch.utils.lie import Pose
from slambench.steps import graph_excess
from torch_estimator_cases import one_torch_thread  # noqa: F401

_BANKS = ("edge", "edge_mask", "planar", "planar_mask", "bank_edge", "bank_edge_mask",
          "bank_planar", "bank_planar_mask")
BIASED, GROSS, GOOD = lane.REG_KEEP


@functools.lru_cache(maxsize=None)
def _data():
    return lane.load()


def _truth_rel(d, k) -> Pose:
    """T_Lold_Lcur from the simulator's trajectory: keyframe k against the
    keyframe its closure names."""
    gt = lane.truth(d)
    fo = int(d["node_frame"][int(d["res_old_seq"][k])])
    fc = int(d["node_frame"][k])
    return Pose(gt.t[fo], gt.q[fo]).inverse().compose(Pose(gt.t[fc], gt.q[fc]))


@pytest.mark.parametrize("k", lane.REG_KEEP)
def test_register_matches_the_reference(k):
    d = _data()
    cfg = lane.system_config()
    r = f"reg{k}_"
    banks = [d[r + b] for b in _BANKS]
    out, _ = register(Pose(torch.from_numpy(d[r + "init_t"]), torch.from_numpy(d[r + "init_q"])),
                      *map(torch.from_numpy, banks), cfg.lidar, cfg.loop.refine_iters)
    jcfg = jkitti_scale_config()
    ref, _ = jax.jit(lambda *a: jregister(JPose(a[0], a[1]), *a[2:], jcfg.lidar,
                                          jcfg.loop.refine_iters))(
        *[jnp.asarray(d[r + f]) for f in ("init_t", "init_q")], *map(jnp.asarray, banks))
    for got, want in ((out, jax.device_get(ref)),
                      (out, Pose(d[r + "out_t"], d[r + "out_q"]))):
        np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=0, atol=1e-2)
        np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q), rtol=0, atol=1e-3)
    truth = _truth_rel(d, k)
    err = float(torch.linalg.vector_norm(out.t - truth.t))
    if k == BIASED:
        assert err > 0.25
        from_truth, _ = register(truth, *map(torch.from_numpy, banks), cfg.lidar,
                                 cfg.loop.refine_iters)
        assert float(torch.linalg.vector_norm(from_truth.t - out.t)) < 1e-2
    elif k == GROSS:
        assert err > 5.0
        from_truth, _ = register(truth, *map(torch.from_numpy, banks), cfg.lidar,
                                 cfg.loop.refine_iters)
        assert float(torch.linalg.vector_norm(from_truth.t - truth.t)) < 0.2
    else:
        assert err < 0.05


def test_graph_lane_solves_within_the_references_spread():
    d = _data()
    loop_cfg = lane.system_config().loop
    ref = lane.reference_solve()
    rows = []

    def against_reference(g_in, g_out):
        n = int(g_in.n_nodes)
        r = ref(g_in, loop_cfg.posegraph_iters, loop_cfg.posegraph_4dof)
        spread = 0.0
        for s in (1 + 2 ** -23, 1 - 2 ** -23):
            rs = ref(g_in._replace(t=g_in.t * s), loop_cfg.posegraph_iters,
                     loop_cfg.posegraph_4dof)
            spread = max(spread, float((rs.t[:n] - r.t[:n]).abs().max()))
        rows.append((float((r.t[:n] - g_out.t[:n]).abs().max()), spread))

    def budgeted(g, iters, four_dof):
        return lane.port_solve(g, iters, four_dof, cg_iters=50)

    s = lane.replay(d, budgeted, against_reference)
    summary = lane.summary(s, d)
    print(summary, rows)
    assert summary["closures"] == 30 and summary["switched_off"] == 2
    assert s._n_nodes == len(d["node_frame"]) == 132 and len(rows) == s.graph_solves >= 4
    for gap, spread in rows:
        assert gap <= 1e-4 + 2 * spread, (gap, spread)
    assert summary["ate_m"] < 0.6

    excess = []

    def left_unmade(g_in, g_out):
        excess.append(graph_excess({"g": g_in._asdict(), "t": g_out.t, "ypr": g_out.ypr}))

    s = lane.replay(d, lane.port_solve, left_unmade)
    summary = lane.summary(s, d)
    print(summary, excess)
    assert summary["closures"] == 30 and len(excess) == s.graph_solves >= 4
    assert max(excess) <= 1e-3, excess
    assert summary["ate_m"] < 0.6
