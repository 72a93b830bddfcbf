"""Marginalizing the oldest keyframe into the window's prior, from the span around `marginalize_oldest`."""

LAYER = "Marginalization (estimator/marginalization.marginalize_oldest)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"
WORKLOADS = ["kitti00.lap1", "kitti02-calib.yaw-only", "kitti00.revisit"]
SPANS = {"marginalization.host_ms_per_frame": ["lmono_tpu_torch.estimator.estimator:marginalize_oldest"]}


def read(view):
    """Host ms per window frame inside the span (None: never entered)."""
    s = view["spans"].get("marginalization.host_ms_per_frame")
    return None if s is None else 1e3 * s / view["frames"]
