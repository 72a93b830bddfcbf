"""A rig that calibrates itself in its history: the small cell on a figure-8
from the identity extrinsic, through `run_cell` on the CPU.

At the small cell's widths the hand-eye does not adopt within a CPU-sized
history (its tracks are too coarse for its stability gate), so the run that
must reach the window calibrated has the hand-eye's adoption planted: once
five pairs are in, its update reports the rig's own rotation as converged.
Everything after it is the program's: the window's refinements, the
checkpoint, the window on the extrinsic, the judgement.  The same history
without the plant is refused at set-up."""

from __future__ import annotations

import contextlib
import json

import pytest
import torch

from slambench import harness
from slambench.tests.tiny import BENCH, make_copy
from slambench.traffic import sim

CELL = "tiny.shortlap"
HISTORY = 40
# the port's figure-8 (26 m at 8 m/s, pitch and roll swinging), one lap 204 frames
FIGURE8 = {"generator": "figure8", "lap_frames": 204, "radius_m": 26.0, "height_m": 1.7,
           "swing_m": 0.8, "tilt": 0.18}


def _calibrating_copy(dest):
    """The small cell as a self-calibrating rig on the figure-8: its history
    is the drive's first 40 frames, its window what follows."""
    make_copy(dest, limits={"laser_rpe_m": 0.3, "pose_rpe_m": 0.3, "track_px": 2.0})
    conf_path = dest / "slambench/configs/tiny.json"
    conf = json.loads(conf_path.read_text())
    conf["system"]["estimator"].update(estimate_laser=2, fine_times=3)
    conf["system"]["laser_to_camera"] = None
    conf_path.write_text(json.dumps(conf))
    traffic = dict(json.loads((BENCH / "traffic" / "lap1.json").read_text()), **FIGURE8)
    traffic.update(history={"frames": HISTORY, "seed": 20261018}, first_frame=HISTORY,
                   staged_frames=24, warmup_frames=4, map_check_frames=1, map_check_span=2,
                   marg_check_calls=1, marg_check_span=2, trace_skip=0, trace_frames=2)
    (dest / "slambench/traffic/shortlap.json").write_text(json.dumps(traffic))
    return dest


@contextlib.contextmanager
def _planted_adoption():
    """The hand-eye's update, reporting the rig's rotation as adopted once
    it holds five pairs."""
    import lmono_tpu_torch.estimator.estimator as est

    orig = est.handeye_update
    q_true = sim.rig_T_CL()[1]

    def update(st, q_cam, q_las, pair_ok):
        out = orig(st, q_cam, q_las, pair_ok)
        ready = out.n >= 5
        return out._replace(converged=out.converged | ready,
                            q_ex=torch.where(ready, q_true.to(out.q_ex.dtype), out.q_ex))

    est.handeye_update = update
    try:
        yield
    finally:
        est.handeye_update = orig


def _run(root):
    torch.set_num_threads(4)
    return harness.run_cell(root, CELL, 5151, 4.0, False, device="cpu",
                            bench_dir=root / "slambench", log=lambda s: None)


def test_calibrated_history_reaches_the_window(tmp_path):
    root = _calibrating_copy(tmp_path)
    with _planted_adoption():
        run = _run(root)
    assert run["result"]["correct"], run["checks"]
    ans, rd = run["answers"], run["readings"]
    assert not ans.loops_expected and ans.graph is None
    # every window frame runs on the adopted extrinsic, which the window's
    # refinements at these coarse widths moved some degrees from the rig's
    # (the identity it started from reads 120°)
    assert rd["handeye_adopted_frames"] == run["result"]["attempted"]
    assert rd["extrinsic_deg"] < 15.0
    assert "closure_deg" not in rd and "graph_excess" not in rd
    assert ans.idx[0] == HISTORY + 3 and ans.idx[1] == HISTORY + 4


def test_uncalibrated_history_is_refused(tmp_path):
    root = _calibrating_copy(tmp_path)
    with pytest.raises(RuntimeError, match="uncalibrated"):
        _run(root)
