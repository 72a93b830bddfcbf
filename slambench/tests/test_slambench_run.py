"""Whole runs of the small cell on the CPU: the result line's shape, the
control and the faults that `correct` must catch, the import guards, the
frozen simulator against the port's, and (on a card) every cell."""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys

import pytest
import torch

from slambench import control, harness, reference
from slambench.manifest import Cell, load_manifest
from slambench.tests.tiny import ROOT, make_copy

CELL = "tiny.shortlap"


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return make_copy(tmp_path_factory.mktemp("checkout"))


def _run(root, seed=4242, hook=None, trace=False, seconds=4.0):
    torch.set_num_threads(4)
    return harness.run_cell(root, CELL, seed, seconds, trace, device="cpu",
                            process_hook=hook, bench_dir=root / "slambench",
                            log=lambda s: None)


@pytest.fixture(scope="module")
def clean(copy):
    return _run(copy, trace=True)


def test_result_line_shape(copy, clean):
    res = clean["result"]
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "limits"
    assert res["attempted"] >= 2 and res["failed"] == 0
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for name, m in res["metrics"].items():
        assert set(m) == {"value", "unit"}, name
    assert set(res["limits"]) == set(Cell(copy, CELL, copy / "slambench").limits)
    json.loads(json.dumps(res))


def test_clean_run_is_correct(clean):
    assert clean["result"]["correct"], clean["checks"]
    assert clean["readings"]["map_slots"] == 0.0
    assert clean["readings"]["map_points_m"] < 1e-3


def test_traced_run_reads_host_metrics(clean):
    m = clean["result"]["metrics"]
    for name in ("odometry.host_ms_per_frame", "tracker.host_ms_per_frame",
                 "window_solve.host_ms_per_frame", "driver.readbacks_per_frame"):
        assert m[name]["value"] > 0, name
    # no card: the device metrics find nothing to read and are left out
    assert "k1_roofline" not in m and "device.idle_pct" not in m


def test_control_is_not_correct(copy, clean):
    drive, ans = clean["drive"], clean["answers"]
    lim = Cell(copy, CELL, copy / "slambench").limits
    cfg_map = Cell(copy, CELL, copy / "slambench").config["system"]["mapping"]
    ctrl = reference.judge(drive, control.control_answers(drive, ans), cfg_map, control_dtype=control.LOW)
    ok, rows = reference.compare(ctrl, lim)
    assert not ok
    assert ctrl["track_px"] > lim["track_px"] and ctrl["map_slots"] > 0
    assert ctrl["map_points_m"] > lim["map_points_m"]


def _stale(process):
    """A step that returns its state unchanged: every window frame answers
    with the first window frame's output."""
    first = {}

    def hooked(*args, **kwargs):
        out = process(*args, **kwargs)
        return first.setdefault("out", out)
    return hooked


def _altered_pose(process):
    """An answer altered where it is produced: the window's third frame's
    estimator pose moved by half a metre (after 14 warm-up frames)."""
    n = [0]

    def hooked(*args, **kwargs):
        out = process(*args, **kwargs)
        n[0] += 1
        if n[0] == 14 + 3:
            raw = out["pose_raw"]
            out["pose_raw"] = type(raw)(raw.t + torch.tensor([0.5, 0.0, 0.0]), raw.q)
        return out
    return hooked


@contextlib.contextmanager
def _altered_tracks():
    """The tracker's answer altered where it is produced: every track of the
    window's third frame moved by 3 px, inside `tracker_step` (so beneath
    the run's own wrappers)."""
    import lmono_tpu_torch.fused as fused

    orig, n = fused.tracker_step, [0]

    def step(*args, **kwargs):
        state, out = orig(*args, **kwargs)
        n[0] += 1
        if n[0] == 14 + 3:   # warm-up 14 frames, then the window's third
            out = out._replace(uv=out.uv + 3.0)
        return state, out

    fused.tracker_step = step
    try:
        yield
    finally:
        fused.tracker_step = orig


@pytest.mark.parametrize("fault", ["state_unchanged", "pose_altered", "tracks_altered"])
def test_faults_are_not_correct(copy, fault):
    if fault == "tracks_altered":
        with _altered_tracks():
            run = _run(copy, seconds=6.0)
    else:
        run = _run(copy, hook=_stale if fault == "state_unchanged" else _altered_pose,
                   seconds=6.0)
    assert not run["result"]["correct"], (fault, run["checks"])


def test_no_card_no_result(copy):
    """Without CUDA (this machine) the command exits non-zero and prints no
    result line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    p = subprocess.run([sys.executable, "-m", "slambench.run", "--workload",
                        "kitti00.lap1", "--seed", "3", "--seconds", "1", "--trace", "0"],
                       cwd=copy, env=env, capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_reference_loads_nothing_of_the_port():
    assert harness.reference_imports() == []
    code = ("import sys; import slambench.reference, slambench.traffic.drive; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('lmono_tpu_torch', 'lmono_tpu', 'jax', 'jaxlib')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def test_import_guard_compares_whole_names():
    """lmono_tpu_torch and names that only begin like a forbidden one pass;
    jax itself does not (this test process never imports JAX)."""
    probes = ("lmono_tpu_torch", "lmono_tpu_probe", "jaxlib_probe.sub")
    for name in probes:
        sys.modules.setdefault(name, json)
    try:
        assert harness.import_guard() == []
        sys.modules["jax.numpy"] = json
        assert harness.import_guard() == ["jax"]
    finally:
        for name in ("lmono_tpu_probe", "jaxlib_probe.sub", "jax.numpy"):
            sys.modules.pop(name, None)


def test_frozen_simulator_matches_the_port():
    """The frozen copy makes the port's scene, sweep and render (the lap's
    speed aside: the same pose is handed to both)."""
    from lmono_tpu_torch.config import CameraConfig, LidarConfig
    from lmono_tpu_torch.io import synthetic as port
    from lmono_tpu_torch.utils.lie import Pose

    from slambench.traffic import sim

    lid = LidarConfig(num_rings=16, horiz_res=256)
    cam = CameraConfig(width=96, height=48, fx=48.0, fy=48.0, cx=48.0, cy=24.0)
    sc_p, sc_s = port.make_city_scene(), sim.make_city_scene()
    assert torch.equal(sc_p.box_min, sc_s["box_min"]) and torch.equal(sc_p.cyl_center,
                                                                      sc_s["cyl_center"])
    t, q = sim.circuit_pose(torch.tensor([7]), 250, 32.0, 1.7, 0.15)
    noise = torch.randn(16, 256, generator=torch.Generator().manual_seed(1))
    a = port.simulate_lidar(sc_p, Pose(t[0], q[0]), lid, 0.01, noise=noise)
    b = sim.simulate_lidar(sc_s, (t[0], q[0]), sim.lidar_ray_dirs(16, 256, lid.vertical_fov_deg),
                           lid.min_range, lid.max_range, noise, 0.01)
    assert torch.equal(a["valid"], b["valid"])
    assert torch.allclose(a["ranges"], b["ranges"], atol=1e-5)
    T_LC = port.synthetic_T_CL().inverse()
    img_p = port.render_camera(sc_p, Pose(t[0], q[0]).compose(T_LC), cam)
    img_s, _ = sim.render_camera(sc_s, sim.compose((t[0], q[0]), sim.inverse(sim.rig_T_CL())),
                                 sim.camera_ray_dirs({"width": 96, "height": 48, "fx": 48.0,
                                                      "fy": 48.0, "cx": 48.0, "cy": 24.0}))
    assert (img_p - img_s).abs().max() < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in load_manifest(ROOT)["workloads"]])
def test_cell_runs_on_the_card(cell):
    """Every cell for a few seconds on the card: exit 0, one result line,
    `correct` true."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "-m", "slambench.run", "--workload", cell,
                        "--seed", "77", "--seconds", "5", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu", p.stderr[-2000:]


def test_handeye_steps_follow_the_reference(tmp_path):
    """The small cell calibrating from the identity (estimate_laser 2): the
    hand-eye's update of its state equals the reference's on every window
    frame, and the bfloat16 control does not."""
    dest = make_copy(tmp_path)
    conf = json.loads((dest / "slambench/configs/tiny.json").read_text())
    conf["system"]["estimator"].update(estimate_laser=2, fine_times=3)
    conf["system"]["laser_to_camera"] = None
    (dest / "slambench/configs/tiny.json").write_text(json.dumps(conf))
    traffic = json.loads((dest / "slambench/traffic/shortlap.json").read_text())
    traffic["map_check_frames"] = 0
    (dest / "slambench/traffic/shortlap.json").write_text(json.dumps(traffic))
    (dest / "slambench/limits/tiny.shortlap.json").write_text(
        json.dumps({"laser_rpe_m": 0.3, "handeye_steps": 0}))
    run = _run(dest, seed=99, seconds=5.0)
    assert len(run["answers"].handeye_steps) >= 3
    assert run["readings"]["handeye_steps"] == 0.0 and run["result"]["correct"]
    ctrl = reference.judge(run["drive"], control.control_answers(run["drive"], run["answers"]),
                           conf["system"]["mapping"],
                           control_dtype=control.LOW)
    assert ctrl["handeye_steps"] > 0
