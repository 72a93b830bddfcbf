"""Wrapper of the hand-written CUDA exact-KNN kernel (`csrc/knn.cu`).

Replaces the TPU kernel `lmono_tpu/ops/pallas/knn.py:knn_pallas`.  The
source is built at first use by `ops/cuda/_build.py` (nvcc, sm_90a, a plain
C entry point loaded with `ctypes`).  Nothing is compiled or loaded when
this module is imported.

`knn_kernel_launches` counts the calls that launched the kernel; the plain
PyTorch version is `lmono_tpu_torch.ops.knn.knn_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from lmono_tpu_torch.ops.cuda._build import build_library

_BLOCK = 128          # queries per block: kBlock in csrc/knn.cu
_MIN_SPAN = 256       # fewest bank rows worth a split of their own
_BLOCKS_PER_SM = 4    # query-block x split blocks to aim for on each SM
MAX_K = 8

knn_kernel_launches = 0
_lib = None
_build_report = ""


def build() -> str:
    """Compile (once per source version) and load the kernel library.

    Returns the compiler's report (`-Xptxas -v`: registers, shared memory
    and spills per kernel), empty when the library was already built.
    """
    global _lib, _build_report
    if _lib is not None:
        return _build_report
    lib, _build_report = build_library("knn.cu")
    lib.lmono_knn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                              + [ctypes.c_void_p])
    lib.lmono_knn.restype = ctypes.c_int
    _lib = lib
    return _build_report


def _splits(Q: int, M: int, device: torch.device) -> int:
    """Bank splits (gridDim.y) so that the grid fills the card."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q_blocks = -(-Q // _BLOCK)
    want = -(-_BLOCKS_PER_SM * sms // q_blocks)
    return max(1, min(want, -(-M // _MIN_SPAN)))


def knn_cuda(query: torch.Tensor, target: torch.Tensor,
             target_mask: torch.Tensor, k: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact KNN on the card: query (Q,3) f32, target (M,3) f32, mask (M,)
    bool, all contiguous on one CUDA device; 1 <= k <= 8.

    Returns (d² (Q,k) f32 ascending, idx (Q,k) int32), enqueued on the
    current stream without synchronising.  Raises on any other input.
    """
    global knn_kernel_launches
    tensors = (query, target, target_mask)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("knn_cuda needs CUDA tensors")
    if not (query.device == target.device == target_mask.device):
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
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("knn_cuda needs contiguous tensors")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_cuda supports 1 <= k <= {MAX_K}, got {k}")
    if Q == 0 or M == 0:
        raise ValueError("knn_cuda needs at least one query and one bank row")
    if Q * 3 >= 2 ** 31 or M * 3 >= 2 ** 31:
        raise ValueError("knn_cuda takes fewer than 2^31 / 3 points")
    build()
    dev = query.device
    S = _splits(Q, M, dev)
    span = -(-M // S)
    part_d = torch.empty((S, k, Q), dtype=torch.float32, device=dev)
    part_i = torch.empty((S, k, Q), dtype=torch.int32, device=dev)
    out_d = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib.lmono_knn(
            query.data_ptr(), target.data_ptr(), target_mask.data_ptr(),
            part_d.data_ptr(), part_i.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(),
            Q, M, k, S, span, stream)
    if err != 0:
        raise RuntimeError(f"knn kernel launch failed: CUDA error {err}")
    knn_kernel_launches += 1
    return out_d, out_i
