"""A checkout-like copy of the benchmark with one more cell, as data: the
CPU tests' small configuration (`tiny`) under a short drive (`shortlap`),
its limits, and the manifest entries that name them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

# 32 rings of 512 (the synthetic preset's sweep), 160×96 gray, 48 features
TINY = {
    "lidar": {"num_rings": 32, "horiz_res": 512, "max_range": 60.0,
              "max_edge_features": 256, "max_planar_features": 512,
              "map_edge_capacity": 2048, "map_planar_capacity": 4096,
              "scan_to_map_iters": 4, "num_sectors": 8},
    "camera": {"width": 160, "height": 96, "fx": 80.0, "fy": 80.0, "cx": 80.0, "cy": 48.0},
    "tracker": {"max_features": 48, "min_dist": 8, "pyramid_levels": 2, "lk_patch": 9},
    "estimator": {"max_tracks": 64},
    "loop": {"db_capacity": 64, "max_keypoints": 64, "window_points": 48,
             "kf_edge_points": 128, "kf_planar_points": 256, "refine_iters": 2},
    "mapping": {"map_capacity": 1 << 14, "filter_size": 5},
}

SHORTLAP = {"warmup_frames": 14, "staged_frames": 48, "map_check_frames": 2,
            "map_check_span": 3, "marg_check_calls": 1, "marg_check_span": 2,
            "trace_skip": 0, "trace_frames": 2}


def make_copy(dest: Path, limits: dict | None = None) -> Path:
    """dest/BENCHMARK.json and dest/slambench/: the repository's benchmark
    plus the cell `tiny.shortlap` added as files and entries."""
    shutil.copytree(BENCH, dest / "slambench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = json.loads((BENCH / "configs" / "kitti00.json").read_text())
    system = base["system"]
    for group, keys in TINY.items():
        system[group].update(keys)
    cfg = dict(base, name="tiny", system=system, changed={}, assumed={})
    (dest / "slambench/configs/tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((BENCH / "traffic" / "lap1.json").read_text())
    traffic.update(SHORTLAP)
    (dest / "slambench/traffic/shortlap.json").write_text(json.dumps(traffic))
    lim = limits or {"laser_rpe_m": 0.3, "pose_rpe_m": 0.3, "track_px": 2.0,
                     "map_depth_rel": 0.5, "map_points_m": 1e-3, "map_slots": 0}
    (dest / "slambench/limits/tiny.shortlap.json").write_text(json.dumps(lim))
    man["configs"].append({"name": "tiny", "source": "the CPU tests' widths",
                           "file": "slambench/configs/tiny.json", "reduced": [],
                           "why": "small enough for the CPU"})
    man["workloads"].append({"name": "tiny.shortlap", "config": "tiny",
                             "traffic": "shortlap", "chips": 1, "why": "CPU tests"})
    for p in man["per_layer"]:
        if "kitti00.lap1" in p.get("workloads", []):
            p["workloads"].append("tiny.shortlap")
    (dest / "BENCHMARK.json").write_text(json.dumps(man))
    return dest
