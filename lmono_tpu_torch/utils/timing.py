"""Per-stage wall-clock timing (reference `TicToc` + times_recorder.txt
parity: `include/utils/TicToc.h:38-61`, `Estimator.cc:374-377,647-648`).

The port's own copy of `lmono_tpu/utils/timing.py` (plain Python)."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class StageTimer:
    """Accumulates per-stage wall times."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.rows = []

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.rows.append((name, dt))

    def summary(self) -> dict:
        """Per-stage stats; median separates steady-state cost from the
        first-call jit compiles that dominate the mean."""
        by_stage: dict = {}
        for name, dt in self.rows:
            by_stage.setdefault(name, []).append(dt)
        out = {}
        for k, times in by_stage.items():
            s = sorted(times)
            out[k] = {
                "total_s": self.totals[k],
                "count": self.counts[k],
                "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1),
                "median_ms": 1e3 * s[len(s) // 2],
            }
        return out
