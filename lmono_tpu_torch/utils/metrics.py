"""Structured run metrics: JSONL/TSV emitters.

The port's own copy of `lmono_tpu/utils/metrics.py` (plain Python).

Replaces the reference's printf + ad-hoc text files
(`times_recorder.txt` / `loop_recorder.txt` / `mapping_recorder.txt`,
SURVEY §5) with schema'd per-frame records and a run summary.
"""

from __future__ import annotations

import json
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._f = open(path, "w") if path else None
        self.records = []
        self._t0 = time.time()

    def log(self, **fields) -> None:
        rec = {"t": round(time.time() - self._t0, 4), **fields}
        self.records.append(rec)
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def summary(self) -> dict:
        out: dict = {"n_records": len(self.records)}
        keys = set()
        for r in self.records:
            keys.update(k for k, v in r.items()
                        if isinstance(v, (int, float)) and k != "t")
        for k in keys:
            vals = [r[k] for r in self.records if k in r]
            if vals:
                out[k] = {"mean": sum(vals) / len(vals),
                          "min": min(vals), "max": max(vals)}
        return out

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
