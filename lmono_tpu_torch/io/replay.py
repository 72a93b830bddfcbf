"""Raw-input logging for deterministic replay.

The port's own copy of `lmono_tpu/io/replay.py` (numpy; the npz layout is
the same, so a log written by either package loads in the other).  Tensors
are logged as numpy arrays, moved to the host on append.

SURVEY §5: the reference silently discards misaligned messages and has no
way to reproduce a live run (`MeasurementManager.cc:79-89` drops, nothing is
recorded but final trajectories). Here every raw input frame (scan arrays,
image, odometry, timestamp) can be logged to one ``.npz`` and replayed
through the pipeline later; because the pipeline is functional (state in,
state out, no hidden host mutability), a replay reproduces the run
bit-for-bit — which turns any field failure into a unit test.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List

import numpy as np


class InputLog:
    """Append-only log of per-frame input dicts; npz round-trip, bitwise."""

    def __init__(self) -> None:
        self._frames: List[Dict[str, Any]] = []

    def append(self, frame: Dict[str, Any]) -> None:
        flat = {}
        for k, v in frame.items():
            if v is None:
                continue
            flat[k] = (v.detach().cpu().numpy() if hasattr(v, "detach")
                       else np.asarray(v))
        self._frames.append(flat)

    def __len__(self) -> int:
        return len(self._frames)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return iter(self._frames)

    def save(self, path: str) -> None:
        blob = {"__n__": np.asarray(len(self._frames))}
        for i, fr in enumerate(self._frames):
            for k, v in fr.items():
                blob[f"{i}/{k}"] = v
        np.savez_compressed(path, **blob)

    @staticmethod
    def load(path: str) -> "InputLog":
        with np.load(path) as z:
            n = int(z["__n__"])
            log = InputLog()
            for i in range(n):
                prefix = f"{i}/"
                log._frames.append(
                    {k[len(prefix):]: z[k] for k in z.files
                     if k.startswith(prefix)})
        return log
