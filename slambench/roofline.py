"""Peaks of the card and the least time of each hand-written kernel's call.

A frozen copy of `chip_smoke.py`'s bound arithmetic (`_knn_bound_ms`,
`_slab_union_px`, `_lk_bound_ms`, `_fb_bound_ms`) and of the level rule of
`lmono_tpu_torch/ops/lk.py:level_table`, in seconds.  A bound is the larger
of the operations at the f32 peak and the bytes at the HBM rate; a kernel's
roofline share is its bound over its device time.
"""

from __future__ import annotations

import torch

# one H100 SXM at 700 W, NVIDIA's data sheet: dense f32 outside the tensor
# cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

KNN_FLOPS_PER_PAIR = 8              # 3 subtracts, 3 multiplies, 2 adds
# LK flops per patch pixel: a bilinear sample is 4 products and 3 adds; the
# template samples 3 arrays and adds 3 products to the normal matrix; a
# Gauss-Newton step samples once, subtracts and adds 2 products
LK_TEMPLATE_FLOPS = 3 * 7 + 3 * 2
LK_STEP_FLOPS = 7 + 1 + 2 * 2
PALLAS_MIN_WIDTH = 128              # narrower pyramid levels: the vmapped rule


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S)


def knn_bound_s(Q: int, valid: int, M: int, k: int) -> float:
    """One KNN call: every query against every valid bank row; points,
    mask and results read or written once."""
    return bound_s(KNN_FLOPS_PER_PAIR * Q * valid, 12 * Q + 13 * M + 8 * Q * k)


def _slab_union_px(H: int, W: int, pallas: bool, centres: torch.Tensor, patch: int) -> int:
    """Pixels of an H×W level inside the union of the (patch+1)² slabs read
    around `centres` (n, 2)."""
    S, r = patch + 1, (patch - 1) * 0.5
    c = torch.nan_to_num(centres, nan=0.0, posinf=1e9, neginf=-1e9)
    lo = torch.floor(c - r).long()
    size = torch.tensor([W, H], device=c.device)
    if pallas:
        lo = torch.minimum(lo.clamp(min=0), size - S)
        hi = lo + S
    else:
        hi = torch.minimum((lo + S).clamp(min=0), size)
        lo = torch.minimum(lo.clamp(min=0), size)
    cover = torch.zeros(H + 1, W + 1, dtype=torch.int32, device=c.device)
    one = torch.ones(c.shape[0], dtype=torch.int32, device=c.device)
    for ys, xs, sign in ((lo, lo, 1), (lo, hi, -1), (hi, lo, -1), (hi, hi, 1)):
        cover.index_put_((ys[:, 1], xs[:, 0]), sign * one, accumulate=True)
    return int((cover.cumsum(0).cumsum(1) > 0).sum())


def fb_bound_s(shapes, pts, mask, pt1, ok1, back, patch: int, iters: int) -> float:
    """One forward-backward track: forward runs for the masked-in slots,
    backward runs for those ok after the forward pass; on each level one
    slab per array at each slot's final position."""
    f, b = pts[mask], pt1[ok1]
    reads = []
    for lvl, (H, W) in enumerate(shapes):
        s, pallas = 2.0 ** -lvl, W >= PALLAS_MIN_WIDTH
        reads += [(H, W, pallas, torch.cat([f, back[ok1]]) * s),
                  (H, W, pallas, f * s), (H, W, pallas, f * s),
                  (H, W, pallas, pt1[mask] * s),
                  (H, W, pallas, b * s), (H, W, pallas, b * s)]
    N = pts.shape[0]
    nbytes = 4 * sum(_slab_union_px(*r, patch) for r in reads) + N * (8 + 1 + 2 * (8 + 1))
    runs = len(shapes) * (int(mask.sum()) + int(ok1.sum()))
    flops = runs * patch ** 2 * (LK_TEMPLATE_FLOPS + iters * LK_STEP_FLOPS)
    return bound_s(flops, nbytes)


def kernel_seconds(device: dict, pattern) -> float:
    """Device seconds of the traced kernels whose name matches `pattern`."""
    return sum(v[1] for k, v in device["kernels"].items() if pattern.search(k))
