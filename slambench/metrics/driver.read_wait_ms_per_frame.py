"""Host ms a traced window frame spends inside the port's `read` spans:
every device-to-host read on `SlamSystem.process`'s path (the system's
reap and loop-position reads, the estimator's keyframe flag, the LM's done
flag, the map's occupancy wait, and the host status checks of `eigh` and
`svd`), each a wait for the device's queued work."""

from slambench import spans

LAYER = "System driver (pipeline.SlamSystem.process)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"
WORKLOADS = ["kitti00.lap1", "kitti02-calib.yaw-only", "kitti00.revisit"]
CALLS = {"spans.read_wait": (spans.TARGET, spans.record)}


def read(view):
    return spans.per_frame(view["calls"].get("spans.read_wait"),
                           lambda r: spans.ms(r, "read"))
