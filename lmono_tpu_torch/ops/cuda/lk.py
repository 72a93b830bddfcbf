"""Wrapper of the hand-written CUDA Lucas–Kanade kernel (`csrc/lk.cu`).

Replaces the TPU kernel `lmono_tpu/ops/pallas/lk.py:lk_level_pallas`.  The
source is built at first use by `ops/cuda/_build.py` (nvcc, sm_90a, a plain
C entry point loaded with `ctypes`).  Nothing is compiled or loaded when
this module is imported.

`track_fb_cuda` is one launch for a whole forward-backward track: every
pyramid level, both directions, a block per slot.  `track_pyramid_cuda` is
the same kernel's one-way case over every level (the stereo match), and
`lk_level_cuda` its one-level, one-direction case.  The level pointers and
shapes go to the kernel by value, so a call allocates only its outputs.

`lk_kernel_launches` counts the calls that launched the kernel; the plain
PyTorch versions are `lmono_tpu_torch.ops.lk.track_fb_plain` and
`lk_level_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from lmono_tpu_torch.ops.cuda._build import build_library
from lmono_tpu_torch.ops.lk import _PALLAS_STEP_THRESH, level_table

MAX_PATCH = 32        # kMaxPatch in csrc/lk.cu
MAX_LEVELS = 8        # kMaxLevels in csrc/lk.cu

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
    lib.lmono_lk.argtypes = (
        [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
         ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5)
    lib.lmono_lk.restype = ctypes.c_int
    _lib = lib
    return _build_report


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check_points(pts0: torch.Tensor, dev: torch.device, name: str) -> int:
    if not (pts0.is_cuda and pts0.device == dev):
        raise ValueError(f"{name} needs CUDA tensors on one device")
    if pts0.dtype != torch.float32 or pts0.ndim != 2 or pts0.shape[1] != 2:
        raise ValueError(f"{name}: points must be (N, 2) float32, got "
                         f"{pts0.dtype} {tuple(pts0.shape)}")
    if not pts0.is_contiguous():
        raise ValueError(f"{name} needs contiguous tensors")
    return pts0.shape[0]


def _check_level(images, H: int, W: int, dev: torch.device, name: str):
    for t in images:
        if t is None:
            continue
        if not (t.is_cuda and t.device == dev):
            raise ValueError(f"{name} needs CUDA tensors on one device")
        if t.dtype != torch.float32 or tuple(t.shape) != (H, W):
            raise ValueError(f"{name}: a level's images must be ({H}, {W}) "
                             f"float32, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")
    if H < 2 or W < 2 or H * W >= 2 ** 31:
        raise ValueError(f"{name}: image {H}x{W} out of range")


def _launch(images: list, shapes: list, pts0, guess, mask, patch: int,
            iters: int, pallas_thresh: float, xla_thresh: float,
            backward: bool, inb: bool):
    """One launch of the kernel; returns (pt1, ok1, back, ok2), the last two
    None unless `backward`."""
    global lk_kernel_launches
    dev, N = pts0.device, pts0.shape[0]
    pt1 = torch.empty((N, 2), dtype=torch.float32, device=dev)
    ok1 = torch.empty((N,), dtype=torch.bool, device=dev)
    back = torch.empty_like(pt1) if backward else None
    ok2 = torch.empty_like(ok1) if backward else None
    if N == 0:
        return pt1, ok1, back, ok2
    build()
    L = len(shapes) // 3
    ptrs = (ctypes.c_void_p * len(images))(*[_ptr(t) for t in images])
    dims = (ctypes.c_int * len(shapes))(*shapes)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib.lmono_lk(ptrs, dims, L, pts0.data_ptr(), _ptr(guess),
                            _ptr(mask), N, patch, iters, pallas_thresh,
                            xla_thresh, int(backward), int(inb),
                            pt1.data_ptr(), ok1.data_ptr(), _ptr(back),
                            _ptr(ok2), stream)
    if err != 0:
        raise RuntimeError(f"lk kernel launch failed: CUDA error {err}")
    lk_kernel_launches += 1
    return pt1, ok1, back, ok2


def _pyramid_levels(name: str, pyr0, grads0, pyr1, grads1, pts0, mask,
                    patch: int, iters: int):
    """Checks of a multi-level launch; returns (images, shapes) as
    `lmono_lk` takes them (frame 1's gradients None where `grads1` is)."""
    L = len(pyr0)
    if not (len(grads0) == len(pyr1) == L
            and (grads1 is None or len(grads1) == L)):
        raise ValueError(f"{name}: pyramids and gradients differ in levels")
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"{name} takes 1 to {MAX_LEVELS} levels, got {L}")
    if not 1 <= patch <= MAX_PATCH or iters < 0:
        raise ValueError(f"patch must be in [1, {MAX_PATCH}] and iters >= 0")
    dev = pts0.device
    N = _check_points(pts0, dev, name)
    if not (mask.is_cuda and mask.device == dev and mask.dtype == torch.bool
            and tuple(mask.shape) == (N,) and mask.is_contiguous()):
        raise ValueError(f"{name}: mask must be a contiguous ({N},) bool "
                         f"CUDA tensor")
    levels = level_table([tuple(p.shape) for p in pyr0], patch)
    images, shapes = [], []
    for lvl, lv in enumerate(levels):
        g1 = (None, None) if grads1 is None else tuple(grads1[lvl])
        imgs = (pyr0[lvl], *grads0[lvl], pyr1[lvl], *g1)
        if len(imgs) != 6:
            raise ValueError(f"{name}: each gradient entry must be (ix, iy)")
        _check_level(imgs, lv.H, lv.W, dev, name)
        images += imgs
        shapes += [lv.H, lv.W, int(lv.pallas)]
    return images, shapes


def track_fb_cuda(pyr0, grads0, pyr1, grads1, pts0: torch.Tensor,
                  mask: torch.Tensor, patch: int, iters: int, eps: float):
    """Forward-backward pyramidal LK in one launch: pyr0/pyr1 are lists of
    L (H,W) f32 levels (finest first), grads0/grads1 lists of (ix, iy) of
    the same shapes, pts0 (N,2) f32 in level-0 pixels, mask (N,) bool, all
    contiguous on one CUDA device.  Each level takes the semantics
    `ops.lk.level_table` gives it, with the last-step gate of each: 0.1 px
    (TPU kernel) or 10·eps (vmapped reference).

    Returns (pts1 (N,2), ok1 (N,), back (N,2), ok2 (N,)): ok1 carries the
    mask, every forward level's ok and the in-bounds test; ok2 does the
    same for the backward pass from pts1 with ok1 as its mask.  Enqueued on
    the current stream without synchronising.  Raises on any other input.
    """
    images, shapes = _pyramid_levels("track_fb_cuda", pyr0, grads0, pyr1,
                                     grads1, pts0, mask, patch, iters)
    return _launch(images, shapes, pts0, None, mask, patch, iters,
                   _PALLAS_STEP_THRESH, eps * 10.0, backward=True, inb=True)


def track_pyramid_cuda(pyr0, grads0, pyr1, pts0: torch.Tensor,
                       mask: torch.Tensor, patch: int, iters: int, eps: float
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """One-way pyramidal LK in one launch (`ops.lk.track_pyramid_plain`'s
    semantics): the inputs of `track_fb_cuda` without frame 1's gradients,
    which a one-way track never reads.

    Returns (pts1 (N,2), ok (N,)): ok carries the mask, every level's ok and
    the in-bounds test on level 0.  Enqueued on the current stream without
    synchronising.  Raises on any other input.
    """
    images, shapes = _pyramid_levels("track_pyramid_cuda", pyr0, grads0, pyr1,
                                     None, pts0, mask, patch, iters)
    pt1, ok, _, _ = _launch(images, shapes, pts0, None, mask, patch, iters,
                            _PALLAS_STEP_THRESH, eps * 10.0, backward=False,
                            inb=True)
    return pt1, ok


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
    name = "lk_level_cuda"
    if not img0.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")
    dev = img0.device
    if img0.ndim != 2:
        raise ValueError(f"{name} needs four (H, W) images of one shape")
    H, W = img0.shape
    _check_level((img0, ix0, iy0, img1), H, W, dev, name)
    N = _check_points(pts0, dev, name)
    if _check_points(guess, dev, name) != N:
        raise ValueError(f"pts0 and guess must be (N, 2), got "
                         f"{tuple(pts0.shape)} and {tuple(guess.shape)}")
    if not 1 <= patch <= MAX_PATCH or iters < 0:
        raise ValueError(f"patch must be in [1, {MAX_PATCH}] and iters >= 0")
    if pallas and (H < patch + 1 or W < patch + 1):
        raise ValueError(f"image {H}x{W} too small for patch {patch}")
    pt1, ok, _, _ = _launch([img0, ix0, iy0, img1, None, None],
                            [H, W, int(pallas)], pts0, guess, None, patch,
                            iters, step_thresh, step_thresh, backward=False,
                            inb=False)
    return pt1, ok
