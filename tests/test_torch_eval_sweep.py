"""The online-calibration slice on the CPU: the port's figure-8 trajectory
and hand-eye solver against the JAX package's, and the port's evaluation
sweep (`python -m lmono_tpu_torch.eval_sweep`) end to end at a small size.

Tolerances:
* `figure8_trajectory`: positions and quaternions within 1e-5 (f32, the
  same formulas);
* the hand-eye solver (`handeye_update`) fed the figure-8's true camera and
  laser relative rotations, with seeded rotation noise (σ 1 mrad): the same
  pair index of convergence, and `q_ex` within 1e-4 rad of the reference's
  at convergence and at the end;
* `run_preset` / `main` on the CPU with `kitti_config` cut to small widths
  and chunks of 3-5 frames (a shape check, not an accuracy one: the
  hand-eye needs ~150 frames): every key of the row, and nothing written
  outside `tmp_path`.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmono_tpu.estimator import initializer as ji
from lmono_tpu.io import synthetic as jsyn
from lmono_tpu.utils import lie as jl
from lmono_tpu_torch import eval_sweep
from lmono_tpu_torch import config as tconfig
from lmono_tpu_torch.estimator import initializer as ti
from lmono_tpu_torch.io import synthetic as tsyn
from torch_estimator_cases import one_torch_thread  # noqa: F401

N_PAIRS = 100          # the reference converges at pair 74


def test_figure8_matches():
    jt = jsyn.figure8_trajectory(320)
    tt = tsyn.figure8_trajectory(320)
    np.testing.assert_allclose(tt.t.numpy(), np.asarray(jt.t), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tt.q.numpy(), np.asarray(jt.q), rtol=0, atol=1e-5)
    # the same arguments as the reference's
    small = tsyn.figure8_trajectory(10, radius=10.0, dt=0.2, speed=4.0, z=1.0, tilt=0.3)
    ref = jsyn.figure8_trajectory(10, radius=10.0, dt=0.2, speed=4.0, z=1.0, tilt=0.3)
    np.testing.assert_allclose(small.q.numpy(), np.asarray(ref.q), rtol=0, atol=1e-5)


def _figure8_pairs():
    """(q_cam, q_las) per frame pair of the figure-8: the laser's relative
    rotation and the camera's, q_cam = X q_las X⁻¹ with X = R_CL, each with
    seeded noise of 1 mrad per axis."""
    traj = jsyn.figure8_trajectory(N_PAIRS + 1)
    X = jsyn.synthetic_T_CL().q
    rng = np.random.default_rng(12)
    q = traj.q
    q_las = jl.quat_mul(jl.quat_conj(q[:-1]), q[1:])
    q_cam = jl.quat_mul(jl.quat_mul(X, q_las), jl.quat_conj(X))
    noise = rng.normal(scale=1e-3, size=(2, N_PAIRS, 3)).astype(np.float32)
    q_las = jl.boxplus(q_las, jnp.asarray(noise[0]))
    q_cam = jl.boxplus(q_cam, jnp.asarray(noise[1]))
    return np.asarray(q_cam), np.asarray(q_las), np.asarray(X)


def _angle(a, b):
    d = abs(float(np.dot(a, b)))
    return 2 * np.arccos(min(1.0, d))


def test_handeye_on_the_figure8_matches():
    q_cam, q_las, X = _figure8_pairs()
    js, ts = ji.HandEyeState.init(), ti.HandEyeState.init()
    step = jax.jit(ji.handeye_update)
    conv_j = conv_t = None
    for i in range(N_PAIRS):
        ok = i > 0
        js = step(js, jnp.asarray(q_cam[i]), jnp.asarray(q_las[i]), jnp.asarray(ok))
        ts = ti.handeye_update(ts, torch.from_numpy(q_cam[i]), torch.from_numpy(q_las[i]),
                               torch.tensor(ok))
        if conv_j is None and bool(js.converged):
            conv_j = i
        if conv_t is None and bool(ts.converged):
            conv_t = i
            assert _angle(ts.q_ex.numpy(), np.asarray(js.q_ex)) <= 1e-4
    assert conv_j is not None and conv_t == conv_j
    assert _angle(ts.q_ex.numpy(), np.asarray(js.q_ex)) <= 1e-4
    assert int(ts.n) == int(js.n)
    assert np.rad2deg(_angle(ts.q_ex.numpy(), X)) < 15.0


SYN = tconfig.synthetic_config()
_FULL = tconfig.kitti_config


def _small_kitti_config(seq: int = 0):
    """kitti_config(seq)'s estimator and tracker deltas at small widths."""
    cfg = _FULL(seq)
    return cfg.replace(
        lidar=dataclasses.replace(SYN.lidar, max_edge_features=256, max_planar_features=512,
                                  map_edge_capacity=2048, map_planar_capacity=4096),
        camera=dataclasses.replace(SYN.camera, width=256, height=128, fx=128.0, fy=128.0,
                                   cx=128.0, cy=64.0),
        tracker=dataclasses.replace(cfg.tracker, max_features=40, min_dist=16,
                                    pyramid_levels=3, lk_patch=15),
        estimator=dataclasses.replace(cfg.estimator, window_size=4, max_tracks=48))


ROW_KEYS = {"seq", "frames", "features", "factor_weight", "estimate_laser",
            "fine_times", "fps",
            "ate_m", "laser_ate_m", "drift_pct", "rot_deg_per_m", "keyframes",
            "non_keyframes", "lm_attempts_per_solve", "readbacks_per_frame",
            "initialized"}
CALIB_KEYS = {"handeye_rot_err_deg", "handeye_converged", "ex_trans_err_m",
              "adoption_frame", "handeye_rot_err_at_adoption_deg",
              "ate_before_adoption_m", "laser_ate_before_adoption_m",
              "fps_before_adoption", "ate_after_adoption_m",
              "laser_ate_after_adoption_m", "fps_after_adoption"}


@pytest.fixture
def small_sweep(monkeypatch):
    monkeypatch.setattr(eval_sweep, "kitti_config", _small_kitti_config)
    monkeypatch.setattr(eval_sweep, "CHUNK", 5)
    monkeypatch.setattr(eval_sweep, "MODE2_MIN_FRAMES", 10)


def test_main_runs_the_calibration_preset(small_sweep, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ref_file = os.path.join(repo, "EVAL_r05.json")
    stamp = os.stat(ref_file).st_mtime_ns
    out = eval_sweep.main(["--frames", "6", "--seqs", "2", "--device", "cpu",
                           "--out", str(tmp_path / "sweep.json")])
    assert sorted(os.listdir(tmp_path)) == ["sweep.json"]
    assert os.stat(ref_file).st_mtime_ns == stamp
    with open(tmp_path / "sweep.json") as f:
        assert json.load(f)["rows"] == json.loads(json.dumps(out["rows"]))
    row, = out["rows"]
    assert set(row) == ROW_KEYS | CALIB_KEYS
    assert row["seq"] == 2 and row["estimate_laser"] == 2 and row["frames"] == 10
    assert row["fine_times"] == 3
    assert row["keyframes"] + row["non_keyframes"] == 10 - 4
    for k in ("fps", "ate_m", "laser_ate_m", "fps_before_adoption",
              "ate_before_adoption_m", "laser_ate_before_adoption_m"):
        assert np.isfinite(row[k]), k
    # 10 frames are too few for the hand-eye to converge
    assert row["adoption_frame"] is None and not row["handeye_converged"]
    assert row["ate_after_adoption_m"] is None and row["fps_after_adoption"] is None


def test_run_preset_seeds_other_presets_with_the_rig(small_sweep, monkeypatch):
    monkeypatch.setattr(eval_sweep, "CHUNK", 3)
    scene = tsyn.make_city_scene()
    traj = tsyn.circuit_trajectory(6)
    row = eval_sweep.run_preset(0, 6, scene, traj, device="cpu", fine_times=2)
    assert set(row) == ROW_KEYS and row["estimate_laser"] == 1 and row["fine_times"] == 2
    assert row["initialized"] and row["ate_m"] < 0.5


def test_main_takes_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        eval_sweep.main(["--frames", "10", "--seqs", "2"])
