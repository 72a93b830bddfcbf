"""Device operations (kernels, copies, memsets) per profiled frame."""

LAYER = "Device (H100)"
UNIT = "kernels/frame"
SOURCE = "device_trace"
MOVES = "frames_per_s"
WORKLOADS = ["kitti00.lap1", "kitti02-calib.yaw-only", "kitti00.revisit"]


def read(view):
    d = view["device"]
    if d is None or not d["launches"] or not view["traced_frames"]:
        return None
    return d["launches"] / view["traced_frames"]
