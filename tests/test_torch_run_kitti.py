"""The port's recorded-drive entry point, `python -m lmono_tpu_torch.run_kitti`,
on the CPU over a KITTI tree that the port's simulator and PNG encoder write
(`io/synthetic.py:write_kitti_tree`; 8 frames of `synthetic_config`'s
32×512 scans and a 256×128 camera along the circuit).

`run_kitti` builds `kitti_config(0)` with the tree's calibration; its
KITTI-scale features and banks take minutes a frame on the CPU, so here
`kitti_config` is cut to the widths of `test_torch_system.py` (features,
banks, window 4, a 64-keyframe DB, a 2^15-point map).

* `main([..., "--device", "cpu"])` writes the TUM (n × 8) and KITTI
  (n × 12) trajectories and a PLY over 1000 bytes, prints ATE, RPE and the
  tracer's span medians, runs the native loader, and its TUM trajectory is within
  0.3 m ATE of the tree's poses (as `tests/test_run_kitti.py` holds the
  reference's `examples/run_kitti.py`).
* The same loader frames fed to `SlamSystem.process` directly give the same
  trajectory bit for bit, and the same TUM bytes.
* Without `--device`, `main` raises where there is no card.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import lmono_tpu_torch.config as tconfig
from lmono_tpu_torch import native, run_kitti
from lmono_tpu_torch.eval.ate import ate_rmse, save_tum
from lmono_tpu_torch.io.synthetic import write_kitti_tree
from lmono_tpu_torch.native import NativeScanLoader
from lmono_tpu_torch.pipeline import SlamSystem
from lmono_tpu_torch.utils.lie import Pose, pose_stack, quat_normalize
from test_torch_system import CFG as SMALL
from torch_estimator_cases import one_torch_thread  # noqa: F401

N = 8
LIDAR = tconfig.synthetic_config().lidar
CAMERA = SMALL.camera
ARGS = ["--seq", "0", "--frames", str(N), "--rings", str(LIDAR.num_rings),
        "--horiz-res", str(LIDAR.horiz_res)]


def _cut(cfg):
    """kitti_config's tree at the small widths."""
    return cfg.replace(
        lidar=dataclasses.replace(
            cfg.lidar, **{k: getattr(SMALL.lidar, k) for k in (
                "max_edge_features", "max_planar_features", "map_edge_capacity",
                "map_planar_capacity")}),
        tracker=SMALL.tracker, estimator=dataclasses.replace(
            cfg.estimator, window_size=SMALL.estimator.window_size,
            max_tracks=SMALL.estimator.max_tracks),
        loop=SMALL.loop, mapping=SMALL.mapping)


_FULL = tconfig.kitti_config


def _small_kitti_config(seq: int = 0):
    return _cut(_FULL(seq))


def _patch(mp) -> None:
    mp.setattr(tconfig, "kitti_config", _small_kitti_config)
    mp.setattr(run_kitti, "kitti_config", _small_kitti_config)


@pytest.fixture(autouse=True)
def small_kitti_config(monkeypatch):
    _patch(monkeypatch)


def _runs(root: str, out: str):
    """run_kitti.main over the tree, then the same frames through
    `SlamSystem.process` directly: (main's result, the direct trajectory,
    native frames loaded by main)."""
    write_kitti_tree(root, LIDAR, CAMERA, N, generator=torch.Generator().manual_seed(5))
    before = native.native_frames_loaded
    res = run_kitti.main(["--root", root, *ARGS, "--out", out,
                          "--ply", os.path.join(out, "map.ply"), "--device", "cpu"])
    loaded = native.native_frames_loaded - before
    ds, cfg = run_kitti.sequence_config(root, 0, LIDAR.num_rings, LIDAR.horiz_res)
    loader = NativeScanLoader(ds.velo_dir, N, cfg.lidar)
    system = SlamSystem(cfg, device="cpu")
    poses = []
    for i in range(N):
        scan = loader.next()
        poses.append(system.process({k: scan[k] for k in ("points", "ranges", "valid")},
                                    ds.image(i), time=ds.time(i))["pose"])
    loader.close()
    return res, pose_stack(poses), loaded


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    out = tmp_path_factory.mktemp("out")
    n = torch.get_num_threads()
    torch.set_num_threads(1)      # set up before the autouse one_torch_thread
    try:
        with pytest.MonkeyPatch.context() as mp:
            _patch(mp)
            res, direct, loaded = _runs(str(root), str(out))
    finally:
        torch.set_num_threads(n)
    return dict(root=str(root), out=str(out), res=res, direct=direct, loaded=loaded)


def test_run_kitti_writes_the_outputs(runs):
    out, root = runs["out"], runs["root"]
    tum = np.loadtxt(os.path.join(out, "kitti00_fused.txt"))
    assert tum.shape == (N, 8)
    assert np.loadtxt(os.path.join(out, "kitti00_fused_kitti.txt")).shape == (N, 12)
    ply = os.path.join(out, "map.ply")
    assert os.path.getsize(ply) > 1000
    assert runs["loaded"] == N
    system = runs["res"]["system"]
    assert system.frame_idx == N and system.mapper.n_points > 0
    gt = np.loadtxt(os.path.join(root, "poses", "00.txt")).reshape(-1, 3, 4)
    est = Pose(torch.tensor(tum[:, 1:4], dtype=torch.float32),
               quat_normalize(torch.tensor(np.roll(tum[:, 4:8], 1, axis=1),
                                           dtype=torch.float32)))
    gt_p = Pose(torch.tensor(gt[:, :, 3], dtype=torch.float32),
                torch.tensor([1.0, 0, 0, 0]).repeat(N, 1))
    assert ate_rmse(est, gt_p) < 0.3


def test_run_kitti_prints_its_report(tmp_path, capsys):
    root = str(tmp_path / "kitti")
    write_kitti_tree(root, LIDAR, CAMERA, 3, generator=torch.Generator().manual_seed(6))
    run_kitti.main(["--root", root, "--seq", "0", "--rings", str(LIDAR.num_rings),
                    "--horiz-res", str(LIDAR.horiz_res), "--out", str(tmp_path),
                    "--no-loop", "--no-map", "--device", "cpu"])
    text = capsys.readouterr().out
    for line in ("KITTI seq 00: 3 frames", "throughput:", "ATE RMSE:", "RPE(10):",
                 "span frame ", "span odometry ", "span tracker "):
        assert line in text, line
    assert "saved" not in text and "span loop_lane" not in text


def test_run_kitti_equals_process_on_the_loader_frames(runs, tmp_path):
    est, direct = runs["res"]["trajectory"], runs["direct"]
    assert torch.equal(est.t, direct.t) and torch.equal(est.q, direct.q)
    path = str(tmp_path / "direct.txt")
    save_tum(path, direct)
    assert (open(path, "rb").read()
            == open(os.path.join(runs["out"], "kitti00_fused.txt"), "rb").read())


def test_run_kitti_takes_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_kitti.main(["--root", str(tmp_path), *ARGS])
