"""The manifest against the benchmark's contract, discovery by name, and a
cell and a metric added as data alone."""

from __future__ import annotations

import hashlib
import json
import math
import re
from pathlib import Path

import pytest

from slambench.manifest import Cell, load_manifest, load_metric
from slambench.tests.tiny import BENCH, ROOT, make_copy
from slambench.traffic.drive import GENERATORS

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return load_manifest(ROOT)


def test_manifest_keys_and_names(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["paths"] == ["slambench"]
    assert manifest["command"][:3] == ["python3", "-m", "slambench.run"]
    names = [e["name"] for e in manifest["configs"] + manifest["workloads"]
             + manifest["end_to_end"] + manifest["per_layer"]]
    assert all(NAME.match(n) for n in names), names
    assert len({e["name"] for e in manifest["end_to_end"] + manifest["per_layer"]}) == \
        len(manifest["end_to_end"]) + len(manifest["per_layer"])
    for e in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert e["source"] in SOURCES
    for e in manifest["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    assert "setup_s" in {e["name"] for e in manifest["end_to_end"]}
    assert len(json.dumps(manifest)) < 64 * 1024


def test_run_seconds_fit_the_check(manifest):
    rs = manifest["run_seconds"]
    cells = 24
    total = (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200
    assert 1 <= rs <= 51 and total <= 43200


def test_every_cell_found_by_name(manifest):
    used = set()
    for w in manifest["workloads"]:
        cell = Cell(ROOT, w["name"])
        used.add(w["config"])
        assert cell.chips == w["chips"] == 1
        assert cell.config["name"] == w["config"]
        assert cell.limits, w["name"]
        assert cell.traffic["generator"] in GENERATORS
        reported = {e["name"] for e in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer, w["name"]
        assert len(w["why"]) <= 200
    assert used == {c["name"] for c in manifest["configs"]}


def test_metric_files_match_their_entries(manifest):
    for p in manifest["per_layer"]:
        m = load_metric(BENCH, p["name"])
        assert (m.LAYER, m.UNIT, m.SOURCE, m.MOVES) == \
            (p["layer"], p["unit"], p["source"], p["moves"]), p["name"]
        assert list(m.WORKLOADS) == p["workloads"]
        assert p["moves"] in {e["name"] for e in manifest["end_to_end"]}


def test_configs_state_their_changes(manifest):
    for c in manifest["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("slambench/configs/")
        assert sorted(c["reduced"]) == sorted(conf["changed"])
        assert conf["source"] == c["source"] and len(c["source"]) <= 200
        assert conf["system"]["lidar"]["horiz_res"] == 2048


def _digest(d: Path) -> str:
    h = hashlib.sha256()
    for f in sorted(d.rglob("*.py")):
        if "tests" not in f.parts and "metrics" not in f.parts:
            h.update(f.read_bytes())
    return h.hexdigest()


def test_a_cell_and_a_metric_added_as_data(tmp_path):
    """A new traffic mix, limits, metric reader and manifest entries make a
    cell the harness finds, with no harness file edited."""
    dest = make_copy(tmp_path)
    before = _digest(dest / "slambench")
    (dest / "slambench/metrics/driver.frames_seen.py").write_text(
        '"""Window frames."""\nLAYER = "System driver (pipeline.SlamSystem.process)"\n'
        'UNIT = "frames"\nSOURCE = "program_counter"\nMOVES = "frames_per_s"\n'
        'WORKLOADS = ["tiny.shortlap"]\n\n\ndef read(view):\n    return view["frames"]\n')
    man = json.loads((dest / "BENCHMARK.json").read_text())
    man["per_layer"].append({"name": "driver.frames_seen", "unit": "frames",
                             "better": "higher", "source": "program_counter",
                             "layer": "System driver (pipeline.SlamSystem.process)",
                             "moves": "frames_per_s", "workloads": ["tiny.shortlap"]})
    (dest / "BENCHMARK.json").write_text(json.dumps(man))
    cell = Cell(dest, "tiny.shortlap", dest / "slambench")
    assert "driver.frames_seen" in cell.metrics
    assert cell.metrics["driver.frames_seen"].read({"frames": 7}) == 7
    assert cell.traffic["staged_frames"] == 48 and cell.config["name"] == "tiny"
    assert _digest(dest / "slambench") == before
    other = Cell(dest, "kitti00.lap1", dest / "slambench")
    assert "driver.frames_seen" not in other.metrics


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        Cell(ROOT, "no.such-cell")


def test_limits_are_finite():
    for f in (BENCH / "limits").glob("*.json"):
        lim = json.loads(f.read_text())
        assert lim and all(math.isfinite(v) and v >= 0 for v in lim.values()), f
