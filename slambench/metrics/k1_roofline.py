"""K1's share of its roofline (`ops/cuda/knn.knn_cuda` -> `csrc/knn.cu`):
the summed least time of the profiled frames' calls, each from its own
query count, bank size, valid rows and k (`roofline.knn_bound_s`), over
the device time of the `knn_kernel` launches in the same frames."""

import re

from slambench import roofline

LAYER = "K1 exact KNN (ops/cuda/knn.knn_cuda -> csrc/knn.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frames_per_s"
WORKLOADS = ["kitti00.lap1", "kitti02-calib.yaw-only", "kitti00.revisit"]
KERNEL = re.compile(r"\bknn_kernel\b")


def _record(args, kwargs, out):
    query, target, mask, k = args[:4]
    return (query.shape[0], target.shape[0], k, mask.sum())


CALLS = {"k1": ("lmono_tpu_torch.ops.cuda.knn:knn_cuda", _record)}


def read(view):
    calls, d = view["calls"].get("k1"), view["device"]
    if not calls or d is None:
        return None
    t = roofline.kernel_seconds(d, KERNEL)
    if t <= 0:
        return None
    bound = sum(roofline.knn_bound_s(Q, int(v), M, k) for Q, M, k, v in calls)
    return 100.0 * bound / t
