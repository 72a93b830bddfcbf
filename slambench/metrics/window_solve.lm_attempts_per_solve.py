"""LM attempts per window solve (`fused_step`'s `lm_attempts`, over the
window frames that solved): each attempt is a Jacobian, a Schur solve and a
read of the done flag."""

LAYER = "Window solve (estimator/solver.solve_window)"
UNIT = "attempts"
SOURCE = "program_counter"
MOVES = "frames_per_s"
WORKLOADS = ["kitti00.lap1", "kitti00.revisit"]


def read(view):
    tries = [int(f["lm_attempts"]) for f in view["front"]]
    solves = [t for t in tries if t > 0]
    return sum(solves) / len(solves) if solves else None
