"""Wrapper of the hand-written CUDA Lucas–Kanade kernel (`csrc/lk.cu`).

Replaces the TPU kernel `lmono_tpu/ops/pallas/lk.py:lk_level_pallas`.  The
source is built at first use by `ops/cuda/_build.py` (nvcc, sm_90a, a plain
C entry point loaded with `ctypes`).  Nothing is compiled or loaded when
this module is imported.

`lk_kernel_launches` counts the calls that launched the kernel; the plain
PyTorch version is `lmono_tpu_torch.ops.lk.lk_level_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from lmono_tpu_torch.ops.cuda._build import build_library

MAX_PATCH = 32        # ceil(P²/32) <= 32 pixels per lane in csrc/lk.cu

lk_kernel_launches = 0
_lib = None
_build_report = ""


def build() -> str:
    """Compile (once per source version) and load the kernel library.

    Returns the compiler's report (`-Xptxas -v`), empty when the library
    was already built.
    """
    global _lib, _build_report
    if _lib is not None:
        return _build_report
    lib, _build_report = build_library("lk.cu")
    lib.lmono_lk_level.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int]
        + [ctypes.c_void_p] * 3)
    lib.lmono_lk_level.restype = ctypes.c_int
    _lib = lib
    return _build_report


def lk_level_cuda(img0: torch.Tensor, ix0: torch.Tensor, iy0: torch.Tensor,
                  img1: torch.Tensor, pts0: torch.Tensor, guess: torch.Tensor,
                  patch: int, iters: int, pallas: bool, step_thresh: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One LK level on the card for all slots: images (H,W) f32, pts0/guess
    (N,2) f32, all contiguous on one CUDA device.  `pallas` picks the TPU
    kernel's semantics (needs H, W >= patch + 1), else the vmapped
    reference's; a slot converges where its last step is under
    `step_thresh`.

    Returns (pt1 (N,2) f32, ok (N,) bool), enqueued on the current stream
    without synchronising.  Raises on any other input.
    """
    global lk_kernel_launches
    images = (img0, ix0, iy0, img1)
    tensors = images + (pts0, guess)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("lk_level_cuda needs CUDA tensors")
    if any(t.device != img0.device for t in tensors):
        raise ValueError("lk_level_cuda inputs must share one device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("lk_level_cuda needs float32 tensors")
    if img0.ndim != 2 or any(t.shape != img0.shape for t in images):
        raise ValueError("lk_level_cuda needs four (H, W) images of one shape")
    H, W = img0.shape
    N = pts0.shape[0]
    if pts0.ndim != 2 or pts0.shape[1] != 2 or guess.shape != pts0.shape:
        raise ValueError(f"pts0 and guess must be (N, 2), got "
                         f"{tuple(pts0.shape)} and {tuple(guess.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("lk_level_cuda needs contiguous tensors")
    if not 1 <= patch <= MAX_PATCH or iters < 0:
        raise ValueError(f"patch must be in [1, {MAX_PATCH}] and iters >= 0")
    if H < 2 or W < 2 or (pallas and (H < patch + 1 or W < patch + 1)):
        raise ValueError(f"image {H}x{W} too small for patch {patch}")
    if H * W >= 2 ** 31:
        raise ValueError("lk_level_cuda takes images of fewer than 2^31 pixels")
    pt1 = torch.empty((N, 2), dtype=torch.float32, device=img0.device)
    ok = torch.empty((N,), dtype=torch.bool, device=img0.device)
    if N == 0:
        return pt1, ok
    build()
    with torch.cuda.device(img0.device):
        stream = torch.cuda.current_stream(img0.device).cuda_stream
        err = _lib.lmono_lk_level(
            img0.data_ptr(), ix0.data_ptr(), iy0.data_ptr(), img1.data_ptr(),
            H, W, pts0.data_ptr(), guess.data_ptr(), N, patch, iters,
            step_thresh, int(pallas), pt1.data_ptr(), ok.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"lk kernel launch failed: CUDA error {err}")
    lk_kernel_launches += 1
    return pt1, ok
