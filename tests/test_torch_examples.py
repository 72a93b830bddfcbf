"""The port's example entry points on the CPU, at the small widths of
`test_torch_system.py` (32×512 sweeps with 256 / 512 features and 2048 /
4096-point banks, a 256×128 camera, window 4; at the synthetic config's
own banks one CPU frame takes ~3 s, the plain KNN's sort):

* `python -m lmono_tpu_torch.run_lidar_odometry` over 6 simulated frames,
  and with `--kitti-root` over a 6-frame KITTI tree that the port's
  simulator writes (`io/synthetic.py:write_kitti_tree`): the TUM file has 6
  rows of 8 columns and the ATE is under 0.5 m;
* `python -m lmono_tpu_torch.run_full_pipeline` over one short drive with
  the loop off and the map on: the streamed trajectory, its TUM file and
  the PLY have the drive's shape;
* `python -m lmono_tpu_torch.bench_loop_pr --kf 12`: the result JSON has
  the reference's keys and is written where `--out` says; the JAX
  package's record `LOOP_PR.json` at the repository root is untouched.
Without `--device`, each raises where there is no card.
"""

import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from lmono_tpu_torch import bench_loop_pr, run_full_pipeline, run_lidar_odometry
from test_torch_system import TCFG
from torch_estimator_cases import one_torch_thread  # noqa: F401

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = TCFG.replace(laser_to_camera=None)


@pytest.fixture(autouse=True)
def small_config(monkeypatch):
    for mod in (run_lidar_odometry, run_full_pipeline, bench_loop_pr):
        monkeypatch.setattr(mod, "synthetic_config", lambda: SMALL)


def _tum(path):
    rows = np.loadtxt(path, ndmin=2)
    assert np.isfinite(rows).all()
    return rows


def test_run_lidar_odometry(tmp_path):
    out = run_lidar_odometry.main(["--frames", "6", "--device", "cpu",
                                   "--out", str(tmp_path)])
    assert out["tum"] == os.path.join(tmp_path, "lidar_odometry.txt")
    assert _tum(out["tum"]).shape == (6, 8)
    assert out["trajectory"].t.shape == (6, 3)
    assert out["ate"] < 0.5 and out["fps"] > 0


def test_run_lidar_odometry_on_a_kitti_tree(tmp_path, monkeypatch):
    from lmono_tpu_torch.io.synthetic import write_kitti_tree

    # the tree's 32-ring sweeps regrid by the uniform ring model
    lidar = dataclasses.replace(SMALL.lidar, ring_mode="uniform")
    monkeypatch.setattr(run_lidar_odometry, "kitti_config",
                        lambda seq=0: SMALL.replace(lidar=lidar))
    root = str(tmp_path / "kitti")
    write_kitti_tree(root, lidar, SMALL.camera, 6, generator=torch.Generator().manual_seed(4))
    out = run_lidar_odometry.main(["--kitti-root", root, "--seq", "0", "--frames", "6",
                                   "--device", "cpu", "--out", str(tmp_path)])
    assert out["tum"] == os.path.join(tmp_path, "kitti00_lidar.txt")
    assert _tum(out["tum"]).shape == (6, 8)
    assert out["ate"] < 0.5


def test_run_full_pipeline(tmp_path):
    ply = os.path.join(tmp_path, "map.ply")
    out = run_full_pipeline.main(["--frames", "6", "--no-loop", "--device", "cpu",
                                  "--out", str(tmp_path), "--ply", ply])
    assert out["trajectory"].t.shape == (6, 3)
    assert _tum(out["tum"]).shape == (6, 8)
    assert out["final_ate"] is None and out["system"].loop is None
    assert np.isfinite(out["ate"])
    with open(ply, "rb") as f:
        data = f.read()
    head = data[:data.index(b"end_header\n") + len(b"end_header\n")]
    n = int(head.split(b"element vertex ")[1].split(b"\n")[0])
    assert n == out["map_points"] > 0
    assert len(data) == len(head) + 15 * n


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_bench_loop_pr(tmp_path):
    record = os.path.join(_ROOT, "LOOP_PR.json")
    before = _digest(record)
    path = os.path.join(tmp_path, "pr.json")
    out = bench_loop_pr.main(["--kf", "12", "--device", "cpu", "--out", path])
    with open(path) as f:
        written = json.load(f)
    with open(record) as f:
        reference_keys = set(json.load(f))
    assert reference_keys <= set(written) and written["keyframes"] == 12
    assert written["underlying_frames"] == 8 * 12 + 4
    assert written["false_positives"] == out["false_positives"] == 0
    assert written["device"] == "cpu"
    assert _digest(record) == before


@pytest.mark.parametrize("entry", [run_lidar_odometry, run_full_pipeline,
                                   bench_loop_pr])
def test_entry_points_take_the_card_by_default(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.main(["--out", str(tmp_path / "x")])
