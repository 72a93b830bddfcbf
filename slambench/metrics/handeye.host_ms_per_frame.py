"""The hand-eye calibration's host time: the 96-hypothesis relative pose from the tracks and the AX = XB update, from spans around both."""

LAYER = "Hand-eye (estimator/initializer.relative_pose_from_tracks + handeye_update)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"
WORKLOADS = ["kitti02-calib.yaw-only"]
SPANS = {"handeye.host_ms_per_frame": ["lmono_tpu_torch.estimator.estimator:relative_pose_from_tracks", "lmono_tpu_torch.estimator.estimator:handeye_update"]}


def read(view):
    """Host ms per window frame inside the span (None: never entered)."""
    s = view["spans"].get("handeye.host_ms_per_frame")
    return None if s is None else 1e3 * s / view["frames"]
