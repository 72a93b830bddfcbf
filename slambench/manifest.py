"""`BENCHMARK.json` and the files it names, found by name.

A cell `<config>.<traffic>` is an entry of `workloads`; its configuration is
`configs/<config>.json` (the entry of `configs` says which file), its
traffic `traffic/<traffic>.json`, the limits of its `correct`
`limits/<cell>.json`, and each per-layer metric `metrics/<metric>.py`.
Adding a cell or a metric is adding files and entries: nothing here names
one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
METRIC_KEYS = ("LAYER", "UNIT", "SOURCE", "MOVES", "WORKLOADS")


def load_manifest(root: Path) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json in {root}")
    return json.loads(path.read_text())


def _load_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def load_metric(bench_dir: Path, name: str):
    """The reader module of per-layer metric `name` (`metrics/<name>.py`)."""
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"metric {name}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"slambench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [k for k in METRIC_KEYS + ("read",) if not hasattr(mod, k)]
    if missing:
        raise AttributeError(f"metric {name} lacks {missing}")
    return mod


class Cell:
    """Everything one workload entry names, read from its files."""

    def __init__(self, root: Path, name: str, bench_dir: Path = HERE):
        m = load_manifest(root)
        cells = {w["name"]: w for w in m["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
        self.entry = w = cells[name]
        self.name = name
        self.chips = int(w["chips"])
        configs = {c["name"]: c for c in m["configs"]}
        self.config = _load_json(root / configs[w["config"]]["file"])
        self.traffic = _load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
        self.limits = _load_json(bench_dir / "limits" / f"{name}.json")
        self.end_to_end = [e for e in m["end_to_end"]
                           if name in e.get("workloads", [name])]
        reported = {e["name"] for e in self.end_to_end}
        self.per_layer = [p for p in m["per_layer"]
                          if (name in p["workloads"] if "workloads" in p
                              else p["moves"] in reported)]
        self.metrics = {p["name"]: load_metric(bench_dir, p["name"])
                        for p in self.per_layer}
