"""Wrapper of the hand-written CUDA exact-KNN kernel (`csrc/knn.cu`).

Replaces the TPU kernel `lmono_tpu/ops/pallas/knn.py:knn_pallas`.  The
source is built at first use by `ops/cuda/_build.py` (nvcc, sm_90a, a plain
C entry point loaded with `ctypes`).  Nothing is compiled or loaded when
this module is imported.

One call is one launch: the bank is split over the CTAs of a thread-block
cluster and the warps of each CTA, and the partial lists are merged in
shared and distributed shared memory.  `knn_plan` is the launch plan, a
pure function of the shapes and the card's SM count.

`select` picks the selection key (`ops/knn.py:SELECT_MODES`): "exact"
selects on the difference-form d²; "bf16x3" and "bf16" on the expansion
key (q² − 2·q·t) + t², whose cross term "bf16" forms over bf16-rounded
coordinates, and then the kernel recomputes the picks' exact d².  The key
modes are a second instantiation of the kernel, so the exact scan is
unchanged; each instantiation set is a library of its own, built from
the same source by its own nvcc run, both at once.

`knn_kernel_launches` counts the calls that launched the kernel; the plain
PyTorch versions are `lmono_tpu_torch.ops.knn.knn_plain` (exact) and
`knn_select_plain` (the reduced keys).
"""

from __future__ import annotations

import ctypes
import functools
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import torch

from lmono_tpu_torch.ops.cuda._build import build_library
from lmono_tpu_torch.ops.knn import SELECT_MODES

MAX_K = 8
# lmono_knn's `select`: 0 exact, 1 bf16x3, 2 bf16
SELECT_CODES = {mode: code for code, mode in enumerate(SELECT_MODES)}
WARPS = 8              # warps per CTA: kMaxWarps in csrc/knn.cu
MAX_CLUSTER = 8        # the portable cluster size
MIN_SLICE_ROWS = 256   # fewest bank rows worth a warp slice of their own
QUERIES_PER_THREAD = (2, 1)      # R, most preferred first

knn_kernel_launches = 0
_libs: dict[bool, ctypes.CDLL] = {}   # Key instantiations? → library
_build_report = ""


class KnnPlan(NamedTuple):
    R: int           # queries per thread
    warps: int       # warps per CTA, each scanning its own bank slice
    cluster: int     # CTAs per cluster, each covering C consecutive slices
    span: int        # bank rows per warp slice
    q_tiles: int     # query tiles of 32·R queries
    grid: int        # CTAs: q_tiles · cluster

    def slices(self, M: int) -> list[tuple[int, int, int, int]]:
        """(rank, warp, lo, hi) of every warp slice of one query tile, in
        merge order; rows past M are empty slices."""
        out = []
        for rank in range(self.cluster):
            for warp in range(self.warps):
                s = rank * self.warps + warp
                lo = min(M, s * self.span)
                out.append((rank, warp, lo, min(M, lo + self.span)))
        return out


@functools.lru_cache(maxsize=None)
def knn_plan(Q: int, M: int, sms: int) -> KnnPlan:
    """Launch plan for Q queries against M bank rows on a card of `sms` SMs.

    The cluster is as wide as the bank allows (slices of at least
    MIN_SLICE_ROWS rows, at most MAX_CLUSTER CTAs).  R is chosen so that
    the most queries any SM runs, ceil(CTAs / sms) · 32R, is least; among
    equals the larger R, whose shared-memory reads feed more pairs (R = 4
    loses on the card: 128 queries a warp meet too many candidate rows).
    """
    if Q <= 0 or M <= 0 or sms <= 0:
        raise ValueError(f"knn_plan needs Q, M, sms > 0, got {Q}, {M}, {sms}")
    C = max(1, min(MAX_CLUSTER, -(-M // (WARPS * MIN_SLICE_ROWS))))
    best = None
    for R in QUERIES_PER_THREAD:
        tiles = -(-Q // (32 * R))
        load = -(-tiles * C // sms) * 32 * R
        if best is None or load < best[0]:
            best = (load, R, tiles)
    _, R, tiles = best
    span = -(-M // (C * WARPS))
    return KnnPlan(R=R, warps=WARPS, cluster=C, span=span, q_tiles=tiles,
                   grid=tiles * C)


def build() -> str:
    """Compile (once per source version) and load the kernel's two
    libraries, `csrc/knn.cu` with LMONO_KNN_KEY 0 (exact) and 1 (the
    reduced keys), two nvcc runs side by side.

    Returns the compiler's reports (`-Xptxas -v`: registers, shared memory
    and spills per kernel), empty when the libraries were already built.
    """
    global _build_report
    if _libs:
        return _build_report
    with ThreadPoolExecutor(2) as pool:
        built = list(pool.map(
            lambda key: build_library("knn.cu", (f"LMONO_KNN_KEY={int(key)}",)),
            (False, True)))
    for key, (lib, _) in zip((False, True), built):
        lib.lmono_knn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                                  + [ctypes.c_void_p])
        lib.lmono_knn.restype = ctypes.c_int
        _libs[key] = lib
    _build_report = "".join(report for _, report in built)
    return _build_report


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def knn_cuda(query: torch.Tensor, target: torch.Tensor,
             target_mask: torch.Tensor, k: int,
             center: torch.Tensor | None = None, select: str = "exact"
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """KNN on the card: query (Q,3) f32, target (M,3) f32, mask (M,)
    bool, and an optional centre (3,) f32 subtracted from both point sets
    in the kernel, all contiguous on one CUDA device; 1 <= k <= 8; `select`
    a key of SELECT_CODES.

    Returns (d² (Q,k) f32, idx (Q,k) int32): ascending d² for "exact",
    selection order for the reduced keys; enqueued on the current stream
    without synchronising.  Raises on any other input.
    """
    global knn_kernel_launches
    tensors = (query, target, target_mask) + (() if center is None else (center,))
    if not all(t.is_cuda for t in tensors):
        raise ValueError("knn_cuda needs CUDA tensors")
    if any(t.device != query.device for t in tensors):
        raise ValueError("knn_cuda inputs must share one device")
    if query.dtype != torch.float32 or target.dtype != torch.float32:
        raise TypeError("knn_cuda needs float32 points")
    if target_mask.dtype != torch.bool:
        raise TypeError("knn_cuda needs a bool mask")
    if query.ndim != 2 or query.shape[1] != 3:
        raise ValueError(f"query must be (Q, 3), got {tuple(query.shape)}")
    if target.ndim != 2 or target.shape[1] != 3:
        raise ValueError(f"target must be (M, 3), got {tuple(target.shape)}")
    Q, M = query.shape[0], target.shape[0]
    if tuple(target_mask.shape) != (M,):
        raise ValueError(f"mask must be ({M},), got {tuple(target_mask.shape)}")
    if center is not None and (center.dtype != torch.float32
                               or tuple(center.shape) != (3,)):
        raise ValueError("center must be a (3,) float32 tensor")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("knn_cuda needs contiguous tensors")
    if select not in SELECT_CODES:
        raise ValueError(f"select must be one of {SELECT_MODES}, got {select!r}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_cuda supports 1 <= k <= {MAX_K}, got {k}")
    if Q == 0 or M == 0:
        raise ValueError("knn_cuda needs at least one query and one bank row")
    if Q * 3 >= 2 ** 31 or M * 3 >= 2 ** 31:
        raise ValueError("knn_cuda takes fewer than 2^31 / 3 points")
    build()
    dev = query.device
    plan = knn_plan(Q, M, _sms(dev))
    out_d = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _libs[select != "exact"].lmono_knn(
            query.data_ptr(), target.data_ptr(), target_mask.data_ptr(),
            None if center is None else center.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), Q, M, k, plan.R, plan.warps,
            plan.cluster, plan.span, SELECT_CODES[select], stream)
    if err != 0:
        raise RuntimeError(f"knn kernel launch failed: CUDA error {err}")
    knn_kernel_launches += 1
    return out_d, out_i
