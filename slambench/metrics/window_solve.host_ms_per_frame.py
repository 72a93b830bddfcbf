"""The sliding window's LM solve (jacfwd Jacobians, Schur on the depths, one read of its done flag per attempt), from the span around `solve_window`."""

LAYER = "Window solve (estimator/solver.solve_window)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"
WORKLOADS = ["kitti00.lap1", "kitti00.revisit"]
SPANS = {"window_solve.host_ms_per_frame": ["lmono_tpu_torch.estimator.estimator:solve_window"]}


def read(view):
    """Host ms per window frame inside the span (None: never entered)."""
    s = view["spans"].get("window_solve.host_ms_per_frame")
    return None if s is None else 1e3 * s / view["frames"]
