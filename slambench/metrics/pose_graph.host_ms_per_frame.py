"""The reaps: one read of the pending detections, the loop edges, the pose-graph solves and the new drift correction, from the span around `_reap_loops`; it lands on the frames that reap, so it moves the tail."""

LAYER = "Pose graph (SlamSystem._reap_loops -> loop/posegraph.optimize_posegraph)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_ms_p90"
WORKLOADS = ["kitti00.revisit"]
SPANS = {"pose_graph.host_ms_per_frame": ["lmono_tpu_torch.pipeline:SlamSystem._reap_loops"]}


def read(view):
    """Host ms per window frame inside the span (None: never entered)."""
    s = view["spans"].get("pose_graph.host_ms_per_frame")
    return None if s is None else 1e3 * s / view["frames"]
