"""The port's own spans in the benchmark: the small cell at `--trace 1`
prints the span metrics named for its workloads beside every older metric
under its old name, and the span arithmetic closes each frame's account."""

from __future__ import annotations

import json

import pytest
import torch

from slambench import harness, spans
from slambench.tests.tiny import ROOT, make_copy

CELL = "tiny.shortlap"
# the span metrics that list kitti00.lap1, which the small cell copies
NEW = ("driver.read_wait_ms_per_frame", "driver.unspanned_ms_per_frame")
# the older metrics that have something to read on the CPU
OLD = ("driver.readbacks_per_frame", "odometry.host_ms_per_frame",
       "tracker.host_ms_per_frame", "window_solve.host_ms_per_frame",
       "window_solve.lm_attempts_per_solve", "marginalization.host_ms_per_frame")


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return make_copy(tmp_path_factory.mktemp("checkout"))


def _run(root, trace: bool):
    torch.set_num_threads(4)
    return harness.run_cell(root, CELL, 4343, 4.0, trace, device="cpu",
                            bench_dir=root / "slambench", log=lambda s: None)


def test_traced_cell_prints_the_span_metrics(copy):
    out = _run(copy, trace=True)
    m = out["result"]["metrics"]
    assert out["result"]["correct"], out["checks"]
    for name in NEW + OLD:
        assert name in m, name
    assert m["driver.read_wait_ms_per_frame"]["value"] > 0
    assert m["driver.unspanned_ms_per_frame"]["value"] >= 0
    assert "pose_graph.solve_ms_per_frame" not in m     # revisit's alone
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for p in manifest["per_layer"]:
        if p["name"] in NEW + ("pose_graph.solve_ms_per_frame",):
            assert p["source"] == "program_span" and p["unit"] == "ms"


def test_untraced_cell_prints_no_layer(copy):
    m = _run(copy, trace=False)["result"]["metrics"]
    assert not set(m) & set(NEW + OLD)


def _rec(name, id_, parent, t0, t1):
    return (name, 7, id_, parent, t0 * 1_000_000, t1 * 1_000_000)


def test_frame_account_closes():
    recs = [_rec("read", 3, 2, 2, 3), _rec("odometry", 2, 1, 1, 4),
            _rec("read", 4, 1, 5, 6), _rec("window_solve", 5, 1, 6, 9),
            _rec("read", 6, 5, 8, 9), _rec("frame", 1, -1, 0, 10)]
    top = sum(r[spans.T1] - r[spans.T0] for r in recs if r[spans.PARENT] == 1) * 1e-6
    assert spans.unspanned_ms(recs) == pytest.approx(3.0)
    assert spans.ms(recs, "frame") == pytest.approx(top + spans.unspanned_ms(recs))
    assert spans.ms(recs, "read") == pytest.approx(3.0)
    assert spans.frames([None, [], recs[:-1], recs]) == [recs]
    assert spans.per_frame([recs, recs], lambda r: spans.ms(r, "read")) == pytest.approx(3.0)
    assert spans.per_frame([None], spans.unspanned_ms) is None
