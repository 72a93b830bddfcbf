"""Share of the window solve's LM attempts that replayed its captured CUDA
graph (`fused_step`'s `lm_replayed` over its `lm_attempts`, over the window
frames that solved): 1 where every attempt is one graph launch, 0 where
each attempt issues its kernels one by one.  A program without the counter
gives nothing."""

LAYER = "Window solve (estimator/solver.solve_window)"
UNIT = "share"
SOURCE = "program_counter"
MOVES = "frames_per_s"
WORKLOADS = ["kitti00.lap1", "kitti00.revisit"]


def read(view):
    solved = [f for f in view["front"] if int(f["lm_attempts"]) > 0]
    if not solved or any("lm_replayed" not in f for f in solved):
        return None
    return (sum(int(f["lm_replayed"]) for f in solved)
            / sum(int(f["lm_attempts"]) for f in solved))
