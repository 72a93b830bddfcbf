"""K2's share of its roofline (`ops/cuda/lk.track_fb_cuda` -> `csrc/lk.cu`):
the summed least time of the profiled frames' forward-backward tracks, each
from the slots it ran and the slabs they read (`roofline.fb_bound_s`), over
the device time of the `lk_kernel` launches in the same frames."""

import re

from slambench import roofline

LAYER = "K2 pyramidal LK (ops/cuda/lk.track_fb_cuda -> csrc/lk.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frames_per_s"
WORKLOADS = ["kitti00.lap1", "kitti02-calib.yaw-only", "kitti00.revisit"]
KERNEL = re.compile(r"\blk_kernel\b")


def _record(args, kwargs, out):
    pyr0, _, _, _, pts0, mask, patch, iters = args[:8]
    pts1, ok1, back, _ = out
    return ([tuple(p.shape) for p in pyr0], pts0, mask, pts1, ok1, back, patch, iters)


CALLS = {"k2": ("lmono_tpu_torch.ops.cuda.lk:track_fb_cuda", _record)}


def read(view):
    calls, d = view["calls"].get("k2"), view["device"]
    if not calls or d is None:
        return None
    t = roofline.kernel_seconds(d, KERNEL)
    if t <= 0:
        return None
    return 100.0 * sum(roofline.fb_bound_s(*c) for c in calls) / t
