"""The port's config tree equals the JAX package's, and the port imports no
JAX.  Exact equality: the configs are plain Python values."""

import dataclasses
import os
import subprocess
import sys

import pytest

import lmono_tpu.config as jcfg
import lmono_tpu_torch.config as tcfg
from lmono_tpu_torch.convert import config_from_json

_CLASSES = ["LidarConfig", "CameraConfig", "TrackerConfig", "EstimatorConfig",
            "LoopConfig", "MappingConfig", "ParallelConfig", "SystemConfig"]

_PRESETS = ([("synthetic_config", ()), ("kitti_scale_config", ()),
             ("hk_config", ())]
            + [("kitti_config", (s,)) for s in range(9)])

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", _CLASSES)
def test_dataclass_fields_and_defaults_match(name):
    fj = dataclasses.fields(getattr(jcfg, name))
    ft = dataclasses.fields(getattr(tcfg, name))
    assert [f.name for f in fj] == [f.name for f in ft]
    # default-constructed trees compare field by field
    assert (dataclasses.asdict(getattr(jcfg, name)())
            == dataclasses.asdict(getattr(tcfg, name)()))


@pytest.mark.parametrize("fn,args", _PRESETS)
def test_presets_match(fn, args):
    a = dataclasses.asdict(getattr(jcfg, fn)(*args))
    b = dataclasses.asdict(getattr(tcfg, fn)(*args))
    assert a == b


def test_from_json_round_trips_across_packages():
    cfg = jcfg.kitti_scale_config()
    port = config_from_json(cfg.to_json())
    assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
    assert tcfg.SystemConfig.from_json(port.to_json()) == port
    assert jcfg.SystemConfig.from_json(port.to_json()) == cfg


def test_port_imports_no_jax():
    modules = [
        "lmono_tpu_torch", "lmono_tpu_torch.config", "lmono_tpu_torch.convert",
        "lmono_tpu_torch.utils.lie", "lmono_tpu_torch.io.synthetic",
        "lmono_tpu_torch.eval.ate", "lmono_tpu_torch.eval.kitti_metrics",
        "lmono_tpu_torch.lidar.features", "lmono_tpu_torch.lidar.registration",
        "lmono_tpu_torch.lidar.odometry", "lmono_tpu_torch.ops.knn",
        "lmono_tpu_torch.ops.voxelmap", "lmono_tpu_torch.ops.cuda.knn",
        "lmono_tpu_torch.ops.image", "lmono_tpu_torch.ops.corners",
        "lmono_tpu_torch.ops.ransac", "lmono_tpu_torch.ops.lk",
        "lmono_tpu_torch.ops.cuda.lk", "lmono_tpu_torch.ops.cuda._build",
        "lmono_tpu_torch.camera", "lmono_tpu_torch.estimator",
        "lmono_tpu_torch.estimator.tracker", "lmono_tpu_torch.estimator.window",
        "lmono_tpu_torch.estimator.feature_manager",
        "lmono_tpu_torch.estimator.factors", "lmono_tpu_torch.estimator.solver",
        "lmono_tpu_torch.estimator.marginalization",
        "lmono_tpu_torch.estimator.initializer",
        "lmono_tpu_torch.estimator.estimator", "lmono_tpu_torch.fused",
        "lmono_tpu_torch.mapping", "lmono_tpu_torch.mapping.depth",
        "lmono_tpu_torch.mapping.builder", "lmono_tpu_torch.loop",
        "lmono_tpu_torch.loop.landmarks", "lmono_tpu_torch.loop.keyframe_db",
        "lmono_tpu_torch.loop.detector", "lmono_tpu_torch.loop.posegraph",
        "lmono_tpu_torch.ops.brief", "lmono_tpu_torch.pipeline",
        "lmono_tpu_torch.io.sync", "lmono_tpu_torch.utils.timing",
        "lmono_tpu_torch.io", "lmono_tpu_torch.io.png", "lmono_tpu_torch.io.kitti",
        "lmono_tpu_torch.io.replay", "lmono_tpu_torch.native", "lmono_tpu_torch.eval",
        "lmono_tpu_torch.utils",
        "lmono_tpu_torch.utils.checkpoint", "lmono_tpu_torch.run_kitti",
        "lmono_tpu_torch.camera.models", "lmono_tpu_torch.camera.factory",
        "lmono_tpu_torch.camera.calibration", "lmono_tpu_torch.eval_sweep",
        "lmono_tpu_torch.intrinsic_calib", "lmono_tpu_torch.utils.groups",
        "lmono_tpu_torch.utils.spline", "lmono_tpu_torch.estimator.stereo",
        "lmono_tpu_torch.estimator.sfm", "lmono_tpu_torch.viz",
        "lmono_tpu_torch.run_lidar_odometry", "lmono_tpu_torch.run_full_pipeline",
        "lmono_tpu_torch.bench_loop_pr", "lmono_tpu_torch.parallel",
        "lmono_tpu_torch.parallel.mesh", "lmono_tpu_torch.parallel.launch",
        "lmono_tpu_torch.parallel.dist_knn", "lmono_tpu_torch.parallel.dist_window",
        "lmono_tpu_torch.parallel.dist_engine", "lmono_tpu_torch.parallel.dist_loop",
        "lmono_tpu_torch.parallel.dist_posegraph", "lmono_tpu_torch.parallel.dist_ba",
        "lmono_tpu_torch.run_multihost",
    ]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'lmono_tpu'))\n"
            "assert not bad, bad\n"
            "import torch\n"
            "assert not torch.backends.cuda.matmul.allow_tf32\n"
            "assert not torch.backends.cudnn.allow_tf32\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_chip_scripts_import_no_jax():
    # the scripts the card runs: neither they nor what they import reach JAX
    code = ("import sys\n"
            "import chip_smoke, chip_perf\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'lmono_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_rank_programs_import_no_jax():
    # spawned ranks import the mesh tests' rank programs afresh: they must
    # not reach JAX either
    code = ("import sys\n"
            "sys.path.insert(0, 'tests')\n"
            "import torch_dist_cases\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'lmono_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_vocabularies_load_from_the_port_without_the_reference():
    # the shipped vocabularies come from lmono_tpu_torch/assets/, with
    # lmono_tpu never imported
    code = ("import os, sys\n"
            "from lmono_tpu_torch.ops import brief\n"
            "for bits, dim in brief.SHIPPED_VOCABS:\n"
            "    path = brief.vocab_asset_path(bits, dim)\n"
            "    assert os.path.dirname(path) == os.path.join(\n"
            "        os.path.dirname(brief.__file__).rsplit(os.sep, 1)[0], 'assets'), path\n"
            "    assert brief.make_codebook(bits, dim).shape == (bits, dim)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'lmono_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
