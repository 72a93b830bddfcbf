"""The card's idle share of the profiled frames: 100% less the union of
every kernel's and copy's interval over the stretch's host wall time."""

LAYER = "Device (H100)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frames_per_s"
WORKLOADS = ["kitti00.lap1", "kitti02-calib.yaw-only", "kitti00.revisit"]


def read(view):
    d = view["device"]
    if d is None or not d["launches"]:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
