"""The KLT tracker's host time: pyramid, K2's forward-backward track, the RANSAC gate and new corners, from the span around `tracker_step`."""

LAYER = "Tracker (estimator/tracker.tracker_step)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"
WORKLOADS = ["kitti00.lap1", "kitti02-calib.yaw-only", "kitti00.revisit"]
SPANS = {"tracker.host_ms_per_frame": ["lmono_tpu_torch.fused:tracker_step"]}


def read(view):
    """Host ms per window frame inside the span (None: never entered)."""
    s = view["spans"].get("tracker.host_ms_per_frame")
    return None if s is None else 1e3 * s / view["frames"]
