"""The window solve's graph replay share: its arithmetic on a synthetic
view, its manifest entry, and the small cell at `--trace 1`, where the CPU
solves eagerly and no attempt replays a graph."""

from __future__ import annotations

import json

import pytest
import torch

from slambench import harness
from slambench.manifest import load_metric
from slambench.tests.tiny import BENCH, ROOT, make_copy

NAME = "window_solve.graph_replay_share"


def test_graph_replay_share_reads_the_counter():
    m = load_metric(BENCH, NAME)
    front = [{"lm_attempts": 0, "lm_replayed": 0}, {"lm_attempts": 4, "lm_replayed": 4},
             {"lm_attempts": 6, "lm_replayed": 3}]
    assert m.read({"front": front}) == 0.7
    assert m.read({"front": front[:2]}) == 1.0
    assert m.read({"front": front[:1]}) is None
    # a program without the counter gives nothing, and does not raise
    assert m.read({"front": [{"lm_attempts": 4}]}) is None


def test_graph_replay_share_entry_matches_its_reader():
    m = load_metric(BENCH, NAME)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(p for p in manifest["per_layer"] if p["name"] == NAME)
    assert (entry["unit"], entry["source"], entry["moves"], entry["layer"]) == (
        m.UNIT, m.SOURCE, m.MOVES, m.LAYER)
    assert entry["workloads"] == m.WORKLOADS


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return make_copy(tmp_path_factory.mktemp("checkout"))


def test_traced_cpu_cell_replays_no_graph(copy):
    torch.set_num_threads(4)
    out = harness.run_cell(copy, "tiny.shortlap", 4343, 4.0, True, device="cpu",
                           bench_dir=copy / "slambench", log=lambda s: None)
    assert out["result"]["correct"], out["checks"]
    assert out["result"]["metrics"][NAME]["value"] == 0.0
