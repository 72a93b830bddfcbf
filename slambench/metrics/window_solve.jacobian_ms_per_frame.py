"""Host ms a traced window frame spends in the window solve's Jacobians:
the port's `window_solve.jacobian` spans, one per LM attempt around
`factors.jacobian` (jacfwd's eager kernels)."""

from slambench import spans

LAYER = "Window solve (estimator/solver.solve_window)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"
WORKLOADS = ["kitti00.lap1", "kitti00.revisit"]
CALLS = {"spans.jacobian": (spans.TARGET, spans.record)}


def read(view):
    return spans.per_frame(view["calls"].get("spans.jacobian"),
                           lambda r: spans.ms(r, "window_solve.jacobian"))
