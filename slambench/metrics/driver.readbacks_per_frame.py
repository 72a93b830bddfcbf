"""Device-to-host reads per window frame that the system makes itself:
`SlamSystem.readbacks` (the per-frame flags, reaps, loop positions) and the
estimator's (`fused_step`'s `readbacks`: the keyframe flag and one per LM
attempt).  Each read waits for the device, so fewer reads let the host run
ahead."""

LAYER = "System driver (pipeline.SlamSystem.process)"
UNIT = "reads/frame"
SOURCE = "program_counter"
MOVES = "frames_per_s"
WORKLOADS = ["kitti00.lap1", "kitti02-calib.yaw-only", "kitti00.revisit"]


def read(view):
    if not view["frames"]:
        return None
    return (view["system_readbacks"] + sum(view["front_readbacks"])) / view["frames"]
