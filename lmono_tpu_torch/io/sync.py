"""Asynchronous measurement pairing (MeasurementManager parity).

The port's own copy of `lmono_tpu/io/sync.py` (plain Python).

The reference's estimator consumes two live streams — camera images and
laser-odometry poses — that arrive on separate ROS topics with independent
latencies, and pairs them by timestamp inside `GetMeasurements`
(`mono_lidar_mapping/src/image_process/MeasurementManager.cc:69-110`): an
image is matched with the odometry message whose stamp is within
``DELAY_TIME`` of it; images that race ahead of odometry wait, stale
odometry is dropped, and loop-closure messages ride a third queue
(`LoopMeasurements`, `MeasurementManager.cc:112-141`).

Here the same contract is a deterministic, thread-free queue pairer: the
pipeline is a synchronous per-frame dataflow, so "waiting on the condvar"
becomes returning no pairs until the lagging stream catches up. Determinism
makes the sync logic unit-testable — the reference's mutex/condvar protocol
has zero tests and known-shaky locking (SURVEY §5).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Deque, List, Optional, Tuple


class MeasurementSync:
    """Pairs (image, odometry) by timestamp within ``delay_time`` seconds.

    Matches the reference's drop/wait policy:
    * odometry older than ``image_t - delay_time`` is discarded (stale);
    * an image with no odometry at ``>= image_t - delay_time`` yet is held
      (the stream is lagging — the caller retries after pushing more);
    * an image is paired with the first odometry inside the tolerance
      window; the consumed odometry and everything before it leave the queue.
    """

    def __init__(self, delay_time: float = 0.1, max_queue: int = 2000):
        self.delay_time = float(delay_time)
        self.max_queue = int(max_queue)
        self._images: Deque[Tuple[float, Any]] = deque()
        self._odoms: Deque[Tuple[float, Any]] = deque()
        self._loops: Deque[Any] = deque()
        self.n_dropped_images = 0
        self.n_dropped_odoms = 0

    # -- producers ---------------------------------------------------------

    def push_image(self, t: float, payload: Any) -> None:
        self._images.append((float(t), payload))
        while len(self._images) > self.max_queue:
            self._images.popleft()
            self.n_dropped_images += 1

    def push_odometry(self, t: float, payload: Any) -> None:
        self._odoms.append((float(t), payload))
        while len(self._odoms) > self.max_queue:
            self._odoms.popleft()
            self.n_dropped_odoms += 1

    def push_loop(self, payload: Any) -> None:
        self._loops.append(payload)

    # -- consumers ----------------------------------------------------------

    def get_measurements(self) -> List[Tuple[float, Any, Any]]:
        """Drain all currently pairable (t_image, image, odometry) triples."""
        out: List[Tuple[float, Any, Any]] = []
        while self._images:
            t_img, img = self._images[0]
            # Drop stale odometry (strictly older than the tolerance window).
            while self._odoms and self._odoms[0][0] < t_img - self.delay_time:
                self._odoms.popleft()
                self.n_dropped_odoms += 1
            if not self._odoms:
                break  # odometry stream lagging: hold the image
            t_odo, odo = self._odoms[0]
            if t_odo <= t_img + self.delay_time:
                out.append((t_img, img, odo))
                self._images.popleft()
                self._odoms.popleft()
            else:
                # Odometry jumped past this image: the image can never be
                # matched — drop it (reference discards via the sync loop).
                self._images.popleft()
                self.n_dropped_images += 1
        return out

    def get_loop(self) -> Optional[Any]:
        """Pop the oldest pending loop-closure message, if any."""
        return self._loops.popleft() if self._loops else None

    def __len__(self) -> int:
        return len(self._images) + len(self._odoms)
