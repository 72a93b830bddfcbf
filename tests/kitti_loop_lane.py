"""system-kitti's graph lane, replayed on the CPU from what a run on the card
consumed.

`chip_perf.py --capture-loop FILE` runs `chip_smoke.py`'s system-kitti cell
(`SlamSystem.process_chunk`, KITTI-scale config, 340 frames, seed 800) and
saves every processed keyframe's uncorrected camera pose and detection
(found, candidate, relative pose, refined), every frame's uncorrected laser
pose, the corrected trajectory and the inputs and output of each loop-lane
`register` call.  `tests/data/kitti_loop_lane.npz` keeps that file, its
registrations cut to the few closures `REG_KEEP` names.

`replay` drives the port's own graph lane (`SlamSystem._add_node`,
`_reap_loops`, `final_trajectory`) over those detections, chunk by chunk as
the run did: each node enters at its corrected pose under the correction of
its chunk, each reap adds the loop edges under the skip gates, solves the
pose graph, switches off the edges its optimum contradicts by more than
0.5 m and re-anchors the correction.  The solve is a parameter, so the same
detections go through the port's solver, the JAX package's, and the port's
in f64 (to the budget, or run to convergence).

    python tests/kitti_loop_lane.py [FILE]

prints, for each solver, the replay's ATE against the simulator's truth,
the raw ATE, the closures and the edges switched off; then, for each solve
of the port's replay, the largest distance between the port's and the
reference's solve of the same graph, beside the reference's own spread
(its result moved by a one-ulp change of its input).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from lmono_tpu_torch.config import kitti_scale_config  # noqa: E402
from lmono_tpu_torch.eval.ate import ate_rmse  # noqa: E402
from lmono_tpu_torch.io import synthetic as syn  # noqa: E402
from lmono_tpu_torch.loop import posegraph as tp  # noqa: E402
from lmono_tpu_torch.pipeline import SlamSystem  # noqa: E402
from lmono_tpu_torch.utils.lie import Pose, pose_stack  # noqa: E402

FIXTURE = ROOT / "tests" / "data" / "kitti_loop_lane.npz"
# the registrations the fixture keeps (by call, one call per processed
# keyframe): see `tests/test_torch_kitti_loop.py`
REG_KEEP = (106, 119, 122)
_REG_FIELDS = ("init_t", "init_q", "out_t", "out_q", "inliers", "edge", "edge_mask",
               "planar", "planar_mask", "bank_edge", "bank_edge_mask", "bank_planar",
               "bank_planar_mask")


def load(path=FIXTURE) -> dict:
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def cut(src: str, dst: str, keep=REG_KEEP) -> None:
    """The fixture from a capture: every field but the registrations, of
    which only the calls `keep` stay (under their call numbers)."""
    d = load(src)
    out = {k: v for k, v in d.items() if not k.startswith("reg")}
    for k in keep:
        for f in _REG_FIELDS:
            out[f"reg{k}_{f}"] = d[f"reg{k}_{f}"]
    np.savez_compressed(dst, reg_keep=np.array(keep, np.int64), **out)


def system_config():
    """The cell's configuration, the rig's extrinsic set as `chip_smoke.py`
    sets it."""
    T_CL = syn.synthetic_T_CL()
    return kitti_scale_config().replace(
        laser_to_camera=tuple(T_CL.to_mat4().reshape(-1).tolist()))


def truth(d: dict) -> Pose:
    return syn.circuit_trajectory(int(d["frames"]))


class _Gates:
    """The loop detector's SKIP_LOOP_* state, which the reaps read."""

    def __init__(self):
        self._last_loop_time, self._last_loop_pos = -1e9, None

    def note_loop(self, time, pos) -> None:
        self._last_loop_time, self._last_loop_pos = time, pos


class _Result:
    def __init__(self, d: dict, k: int):
        for f in ("found", "old_seq", "rel_t", "rel_q", "refined"):
            setattr(self, f, torch.from_numpy(np.array(d[f"res_{f}"][k])))


def replay(d: dict, solve, on_solve=None) -> SlamSystem:
    """The port's graph lane over the captured detections, each pose-graph
    solve by `solve(graph, iters, four_dof)`; `on_solve(graph_in, graph_out)`
    sees each one.  Returns the system (its `final_trajectory` reaped)."""
    cfg = system_config()
    s = SlamSystem.__new__(SlamSystem)
    s.cfg, s.device, s.loop = cfg, torch.device("cpu"), _Gates()
    s._graph_cap = min(512, cfg.loop.db_capacity)
    s.graph = tp.PoseGraph.empty(s._graph_cap)
    s.correction = Pose.identity()
    s.n_loops = s.readbacks = s.reaps = s.graph_solves = s.keyframes_processed = 0
    s._raw_poses = [Pose(torch.from_numpy(t), torch.from_numpy(q))
                    for t, q in zip(d["raw_pose_t"], d["raw_pose_q"])]
    s._node_frames, s._node_raw_cam, s._n_nodes, s._pending = [], [], 0, []

    def optimize(g):
        s.graph_solves += 1
        out = solve(g, cfg.loop.posegraph_iters, cfg.loop.posegraph_4dof)
        if on_solve is not None:
            on_solve(g, out)
        return out

    s._optimize = optimize
    chunk, frames = int(d["chunk"]), int(d["frames"])
    node = 0
    for c0 in range(0, frames, chunk):
        s._reap_loops()
        while node < len(d["node_frame"]) and d["node_frame"][node] < c0 + chunk:
            raw_cam = Pose(torch.from_numpy(d["node_cam_t"][node]),
                           torch.from_numpy(d["node_cam_q"][node]))
            corr = s.correction.compose(raw_cam)
            s._add_node(corr, raw_cam, _Result(d, node), float(d["node_time"][node]),
                        corr.t.numpy().copy(), int(d["node_frame"][node]))
            node += 1
    s.final_trajectory()
    return s


def port_solve(g, iters, four_dof, cg_iters=None):
    return tp.optimize_posegraph(g, iters=iters, cg_iters=cg_iters, four_dof=four_dof)


def f64_solve(iters_cg=None):
    """The port's solver in f64; `iters_cg` = (GN, CG) steps in place of the
    system's budget."""
    def solve(g, iters, four_dof):
        g64 = g._replace(**{f: getattr(g, f).double() for f in g._fields
                            if getattr(g, f).is_floating_point()})
        it, cg = iters_cg or (iters, 50)
        out = tp.optimize_posegraph(g64, iters=it, cg_iters=cg, four_dof=four_dof)
        return g._replace(t=out.t.float(), ypr=out.ypr.float())
    return solve


def reference_solve(cg_iters: int = 50):
    """The JAX package's `optimize_posegraph` (jitted, on the CPU) on the
    port's graph, each GN step's CG given `cg_iters` steps (the JAX
    package's default 50)."""
    import jax
    import jax.numpy as jnp

    from lmono_tpu.loop import posegraph as jp

    opt = jax.jit(jp.optimize_posegraph, static_argnames=("iters", "cg_iters", "four_dof"))

    def solve(g, iters, four_dof):
        jg = jp.PoseGraph(**{f: jnp.asarray(getattr(g, f).numpy().astype(
            np.int32 if getattr(g, f).dtype in (torch.int64, torch.int32)
            else getattr(g, f).numpy().dtype)) for f in g._fields})
        out = jax.device_get(opt(jg, iters=iters, cg_iters=cg_iters, four_dof=four_dof))
        return g._replace(t=torch.from_numpy(np.array(out.t)),
                          ypr=torch.from_numpy(np.array(out.ypr)))
    return solve


def summary(s: SlamSystem, d: dict) -> dict:
    gt = truth(d)
    L = min(s.n_loops, s.graph.loop_mask.shape[0])
    return {"ate_m": ate_rmse(s.final_trajectory(), gt),
            "raw_ate_m": ate_rmse(pose_stack(s._raw_poses), gt),
            "closures": s.n_loops, "switched_off": int((~s.graph.loop_mask[:L]).sum()),
            "off": tuple(int(k) for k in torch.nonzero(~s.graph.loop_mask[:L])[:, 0]),
            "solves": s.graph_solves}


def main(path=FIXTURE) -> None:
    torch.set_num_threads(4)
    d = load(path)
    print(f"card run: ATE {float(d['ate_m']):.6f} m over {int(d['frames'])} frames, "
          f"{len(d['node_frame'])} keyframes processed", flush=True)
    ref = reference_solve()
    loop_cfg = system_config().loop
    gaps = []

    def compare(g_in, g_out):
        n = int(g_in.n_nodes)
        r = ref(g_in, loop_cfg.posegraph_iters, loop_cfg.posegraph_4dof)
        spread = max(float((ref(g_in._replace(t=g_in.t * f), loop_cfg.posegraph_iters,
                                loop_cfg.posegraph_4dof).t[:n] - r.t[:n]).abs().max())
                     for f in (1 + 2 ** -23, 1 - 2 ** -23))
        gaps.append((n, float((r.t[:n] - g_out.t[:n]).abs().max()), spread))

    for name, solve, hook in (("port (f32)", port_solve, compare),
                              ("reference (JAX, f32)", ref, None),
                              ("port (f64)", f64_solve(), None),
                              ("port (f64, 60 GN x 2000 CG)", f64_solve((60, 2000)), None)):
        s = replay(d, solve, hook)
        print(name, summary(s, d), flush=True)
    for n, gap, spread in gaps:
        print(f"solve of the graph at {n} nodes: port against reference {gap:.6f} m, "
              f"the reference moved by a one-ulp change of its input {spread:.6f} m",
              flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:])
