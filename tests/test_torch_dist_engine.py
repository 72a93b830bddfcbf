"""The port's composed engine on a mesh against its single-rank engine
(which the other `test_torch_*` files hold to the JAX package), at
`test_torch_system.py`'s small widths, with tests/test_dist_engine.py's
gates.  Five gloo process groups run side by side, each spawned once
(`tests/torch_dist_cases.py`): the three meshes below and the two
single-rank references, one rank each.  The frames are made here, once.

* `dist_fused_step` on a `DistributedFusedPipeline`'s state on a (kf=4,
  map=2) mesh (the landmark-sharded LM, K1's plain version on each rank's
  bank shard):
  every rank's poses within 5 mm of the single-rank `FusedPipeline`, the
  same keyframe and initialized flags, the odometry banks (gathered)
  bitwise equal;
* `SlamSystem.process` (`DistributedFusedPipeline.process` inside) on a
  (2, 2) mesh, loop and map on, against the
  single-rank system: poses within 5 mm, the same keyframes, DB count and
  loops, the banks bitwise equal, the colored map's slots occupied alike
  on over 99% of them and over 95% of the same-slot points within 2 cm,
  over 500 points, and the PLY written from the sharded map;
* a (2, 1) mesh, below the window solve's crossover (the gathered dense
  solve, the rest of the step sharded), driven lane by lane through
  `make_dist_odometry_step` and `make_dist_fusion_step`: poses within
  1e-4 m of the single rank's.
"""

import pytest
import torch

import torch_dist_cases as cases
from lmono_tpu_torch.estimator.estimator import DIST_WINDOW_CROSSOVER
from lmono_tpu_torch.pipeline import DIST_POSEGRAPH_CROSSOVER

N_PIPE, N_SYS = 8, 10
CIRCUIT = max(N_PIPE, N_SYS)      # the drives' circuit, in frames
POSE_GAP_M = 5e-3


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    ply_dir = str(tmp_path_factory.mktemp("ply"))
    frames = cases.circuit_frames(cases.ENGINE_CFG, CIRCUIT)
    pipe, system = cases.pipeline_suite, cases.system_suite
    return cases.run_groups({
        "pipe42": (pipe, 8, (4, 2, frames[:N_PIPE], "dist_fused_step")),
        "sys22": (system, 4, (2, 2, frames[:N_SYS], f"{ply_dir}/mesh.ply")),
        "pipe21": (pipe, 2, (2, 1, frames[:N_PIPE], "lanes")),
        "pipe1": (pipe, 1, (1, 1, frames[:N_PIPE])),
        "sys1": (system, 1, (1, 1, frames[:N_SYS], f"{ply_dir}/single.ply")),
    }, timeout_s=420), ply_dir


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _gap(a, b) -> float:
    return float(torch.linalg.vector_norm(a["pose_t"] - b["pose_t"], dim=-1).max())


def _banks_equal(a, b) -> None:
    for bank in ("edge_map", "plane_map"):
        for x, y in zip(a[bank], b[bank]):
            assert torch.equal(_bits(x), _bits(y)), bank


def test_crossovers():
    assert DIST_WINDOW_CROSSOVER == 4
    assert DIST_POSEGRAPH_CROSSOVER == 16384


def test_dist_fused_pipeline_matches_single(ranks):
    ranks, _ = ranks
    ref = ranks["pipe1"][0]
    assert ref["initialized"][-1]
    for out in ranks["pipe42"]:
        assert _gap(out, ref) < POSE_GAP_M
        assert out["is_keyframe"] == ref["is_keyframe"]
        assert out["initialized"] == ref["initialized"]
        _banks_equal(out, ref)
    # the map axis gathered KNN candidates, the kf axis psum'd
    stats = ranks["pipe42"][0]["stats"]
    assert stats["map"]["all_gather"][0] > 0 and stats["kf"]["psum"][0] > 0


def test_dist_slam_system_matches_single(ranks):
    ranks, ply_dir = ranks
    ref = ranks["sys1"][0]
    assert ref["initialized"][-1]
    for out in ranks["sys22"]:
        assert _gap(out, ref) < POSE_GAP_M
        assert out["is_keyframe"] == ref["is_keyframe"]
        assert out["db_count"] == ref["db_count"] > 0
        assert out["n_loops"] == ref["n_loops"]
        _banks_equal(out, ref)
        m1, m2 = ref["cmap"][2], out["cmap"][2]
        assert float((m1 == m2).float().mean()) > 0.99
        both = m1 & m2
        close = torch.linalg.vector_norm(ref["cmap"][0][both] - out["cmap"][0][both], dim=-1)
        assert float((close < 2e-2).float().mean()) > 0.95
        assert int(m2.sum()) > 500
        assert out["n_points"] == ref["n_points"]
        assert out["ply_points"] == ref["ply_points"] == out["n_points"]
    with open(f"{ply_dir}/mesh.ply", "rb") as f:
        head = f.read(200).decode("latin-1")
    assert f"element vertex {ranks['sys22'][0]['ply_points']}" in head


def test_small_mesh_takes_the_gathered_step(ranks):
    ranks, _ = ranks
    ref = ranks["pipe1"][0]
    for out in ranks["pipe21"]:
        assert _gap(out, ref) < 1e-4
        assert out["is_keyframe"] == ref["is_keyframe"]
        _banks_equal(out, ref)
    # the dense solve's rows gathered over kf; the rest of the step psum'd
    stats = ranks["pipe21"][0]["stats"]
    assert stats["kf"]["all_gather"][0] > 0 and stats["kf"]["psum"][0] > 0
