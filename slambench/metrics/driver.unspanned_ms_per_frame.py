"""Host ms of a traced window frame that no layer owns: the port's `frame`
span less the union of its direct children (reap, odometry, tracker,
hand-eye, window solve, marginalization, loop lane, map, the frame's own
reads).  What is left is the driver's and the estimator's glue."""

from slambench import spans

LAYER = "System driver (pipeline.SlamSystem.process)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"
WORKLOADS = ["kitti00.lap1", "kitti02-calib.yaw-only", "kitti00.revisit"]
CALLS = {"spans.unspanned": (spans.TARGET, spans.record)}


def read(view):
    return spans.per_frame(view["calls"].get("spans.unspanned"), spans.unspanned_ms)
