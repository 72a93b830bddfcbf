"""The loop lane's keyframe step (BRIEF, DB query, PnP, LiDAR refinement through K1), from the span around `process_keyframe`."""

LAYER = "Loop lane (loop/detector.LoopDetector.process_keyframe)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"
WORKLOADS = ["kitti00.lap1", "kitti00.revisit"]
SPANS = {"loop_lane.host_ms_per_frame": ["lmono_tpu_torch.loop.detector:LoopDetector.process_keyframe"]}


def read(view):
    """Host ms per window frame inside the span (None: never entered)."""
    s = view["spans"].get("loop_lane.host_ms_per_frame")
    return None if s is None else 1e3 * s / view["frames"]
