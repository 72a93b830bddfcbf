"""The LiDAR odometry's host time: features, K1's neighbour lists and the Gauss-Newton registration of each sweep, from the span the benchmark puts around `odometry_step` (its device waits included)."""

LAYER = "Odometry (lidar/odometry.odometry_step)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"
WORKLOADS = ["kitti00.lap1", "kitti02-calib.yaw-only", "kitti00.revisit"]
SPANS = {"odometry.host_ms_per_frame": ["lmono_tpu_torch.fused:odometry_step"]}


def read(view):
    """Host ms per window frame inside the span (None: never entered)."""
    s = view["spans"].get("odometry.host_ms_per_frame")
    return None if s is None else 1e3 * s / view["frames"]
