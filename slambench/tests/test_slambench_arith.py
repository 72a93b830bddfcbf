"""The rate, tail, idle and roofline arithmetic on synthetic records."""

from __future__ import annotations

import statistics
from types import SimpleNamespace

import pytest
import torch

from slambench import harness, reference, roofline
from slambench.manifest import load_metric
from slambench.tests.tiny import BENCH


def test_percentile_matches_linear_interpolation():
    xs = [float(v) for v in range(1, 101)]
    assert reference.percentile(xs, 90.0) == pytest.approx(90.1)
    assert reference.percentile([5.0], 90.0) == 5.0
    ys = [3.0, 1.0, 2.0, 10.0]
    assert reference.percentile(ys, 50.0) == statistics.median(ys)


def _event(name, a, b):
    return SimpleNamespace(name=name, device_type=torch.autograd.DeviceType.CUDA,
                           time_range=SimpleNamespace(start=a, end=b))


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_device_stats_busy_union_and_gaps():
    ev = [_event("k_a", 0, 100), _event("k_b", 50, 150), _event("knn_kernel<5, 4, Exact>", 400, 500),
          _event("lk_kernel<2>", 480, 520), _event("k_a", 1000, 1010)]
    d = harness._device_stats(_Prof(ev), t_wall=0.002)
    assert d["busy_s"] == pytest.approx((150 + 120 + 10) * 1e-6)
    assert d["launches"] == 5
    assert sorted(d["gaps_us"]) == [(150, 400), (520, 1000)]
    assert d["kernels"]["k_a"] == [2, pytest.approx(110e-6)]
    idle = load_metric(BENCH, "device.idle_pct").read({"device": d})
    assert idle == pytest.approx(100 * (1 - 280e-6 / 0.002))
    launches = load_metric(BENCH, "device.launches_per_frame").read(
        {"device": d, "traced_frames": 2})
    assert launches == 2.5
    rows = harness._gap_labels(d, [("odometry", 10.0 + 200e-6, 10.0 + 390e-6)], 10.0)
    assert rows[0] == ["driver (SlamSystem.process outside the spans)", pytest.approx(480e-6)]
    assert rows[1] == ["odometry", pytest.approx(250e-6)]


def test_span_metrics_per_frame():
    m = load_metric(BENCH, "odometry.host_ms_per_frame")
    assert m.read({"spans": {"odometry.host_ms_per_frame": 0.5}, "frames": 10}) == 50.0
    assert m.read({"spans": {}, "frames": 10}) is None
    rb = load_metric(BENCH, "driver.readbacks_per_frame")
    assert rb.read({"frames": 4, "system_readbacks": 4, "front_readbacks": [2, 2, 3, 1]}) == 3.0
    lm = load_metric(BENCH, "window_solve.lm_attempts_per_solve")
    assert lm.read({"front": [{"lm_attempts": 0}, {"lm_attempts": 4}, {"lm_attempts": 6}]}) == 5.0
    assert lm.read({"front": [{"lm_attempts": 0}]}) is None


def test_knn_roofline_arithmetic():
    # 4096 queries against 65536 rows, 90% valid, k = 5: bound by operations
    b = roofline.knn_bound_s(4096, 58982, 65536, 5)
    assert b == pytest.approx(8 * 4096 * 58982 / 67e12)
    m = load_metric(BENCH, "k1_roofline")
    d = {"kernels": {"knn_kernel<5, 4, Exact>": [1, 2 * b], "other": [1, 1.0]}}
    view = {"device": d, "calls": {"k1": [(4096, 65536, 5, torch.tensor(58982))]}}
    assert m.read(view) == pytest.approx(50.0)
    assert m.read({"device": d, "calls": {}}) is None
    assert m.read({"device": {"kernels": {}}, "calls": view["calls"]}) is None


def test_fb_bound_counts_slabs_once():
    shapes = [(376, 1241), (188, 620), (94, 310), (47, 155)]
    pts = torch.tensor([[600.0, 180.0], [601.0, 180.0]])
    mask = torch.tensor([True, True])
    ok1 = torch.tensor([True, False])
    b = roofline.fb_bound_s(shapes, pts, mask, pts, ok1, pts, 21, 10)
    flops = 4 * 3 * 21 ** 2 * (roofline.LK_TEMPLATE_FLOPS + 10 * roofline.LK_STEP_FLOPS)
    assert b >= flops / 67e12
    # two slots a pixel apart read barely more than one
    one = roofline.fb_bound_s(shapes, pts[:1], mask[:1], pts[:1], ok1[:1], pts[:1], 21, 10)
    assert one < b < 2 * one
