"""Shi–Tomasi corner detection with grid-cell NMS (fixed shapes).

Port of `lmono_tpu/ops/corners.py`.  Corner response is the
structure-tensor min-eigenvalue computed with convs; spacing is enforced by
a `cell×cell` grid — one winner per cell, cells holding existing features
are suppressed.

Two of the reference's orders are written out here, so that the result
does not depend on the device:
  * occupancy: the reference scatters every slot's mask into its cell, and
    on the JAX CPU the last (highest) slot wins a cell that several slots
    map to — dead slots with stale positions included.  `index_put_` has no
    defined order among duplicates on CUDA, so each cell takes the highest
    slot index that maps to it (`scatter_reduce` amax), then that slot's
    mask;
  * ranking: `lax.top_k` puts the lower index first among equal values
    (occupied and border cells tie at −inf in bulk); a stable descending
    sort does the same.
"""

from __future__ import annotations

import torch

from lmono_tpu_torch.ops.image import (gauss_blur3, max_pool_same,
                                       scharr_gradients, to_int32_xla)


def shi_tomasi_response(img: torch.Tensor, window: int = 3) -> torch.Tensor:
    """Min-eigenvalue of the structure tensor per pixel."""
    ix, iy = scharr_gradients(gauss_blur3(img))
    ixx = gauss_blur3(ix * ix)
    iyy = gauss_blur3(iy * iy)
    ixy = gauss_blur3(ix * iy)
    tr_half = 0.5 * (ixx + iyy)
    # the root is taken in f64 and rounded, which gives the correctly
    # rounded f32 root: torch's f32 sqrt on the CPU is at times an
    # approximation (~1e-4 relative) over one thread's share of an image,
    # and the min-eigenvalue's cancellation magnifies that
    det_part = torch.sqrt(torch.clamp(
        0.25 * (ixx - iyy) ** 2 + ixy * ixy, min=0.0).double()).float()
    return tr_half - det_part


def detect_grid(img: torch.Tensor, cell: int, max_new: int,
                occupied_uv: torch.Tensor, occupied_mask: torch.Tensor,
                min_quality_rel: float = 0.01,
                border: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Detect up to `max_new` corners, one per cell, skipping occupied cells.

    img: (H, W); occupied_uv: (N, 2) existing feature pixels.
    Returns (uv (max_new, 2) float32, valid (max_new,) bool), best-first.
    """
    H, W = img.shape
    dev = img.device
    resp = shi_tomasi_response(img)
    # border suppression
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    inb = ((xx >= border) & (xx < W - border)
           & (yy >= border) & (yy < H - border))
    neg_inf = torch.full_like(resp, -torch.inf)
    resp = torch.where(inb, resp, neg_inf)
    # local 3x3 NMS
    is_max = resp >= max_pool_same(resp, 3)
    resp = torch.where(is_max, resp, neg_inf)

    # grid reduction: best per cell
    Hc, Wc = H // cell, W // cell
    flat_in_cell = (resp[:Hc * cell, :Wc * cell]
                    .reshape(Hc, cell, Wc, cell).permute(0, 2, 1, 3)
                    .reshape(Hc, Wc, cell * cell))
    cell_best = flat_in_cell.amax(dim=-1)
    argbest = torch.argmax(flat_in_cell, dim=-1)     # first among ties
    cy = torch.arange(Hc, device=dev)[:, None] * cell + argbest // cell
    cx = torch.arange(Wc, device=dev)[None, :] * cell + argbest % cell

    # occupied cells (existing features); see the module note on duplicates
    ou = torch.clamp(to_int32_xla(torch.div(occupied_uv[:, 0], cell,
                                            rounding_mode="floor")), 0, Wc - 1)
    ov = torch.clamp(to_int32_xla(torch.div(occupied_uv[:, 1], cell,
                                            rounding_mode="floor")), 0, Hc - 1)
    slot = torch.arange(occupied_uv.shape[0], device=dev)
    owner = torch.full((Hc * Wc,), -1, dtype=torch.int64, device=dev)
    owner = owner.scatter_reduce(0, (ov * Wc + ou).long(), slot, "amax")
    occ = (owner >= 0) & occupied_mask[owner.clamp(min=0)]
    cell_best = torch.where(occ.reshape(Hc, Wc), -torch.inf, cell_best)

    # quality gate relative to the strongest response
    qmin = min_quality_rel * torch.clamp(cell_best.max(), min=1e-12)
    ok_cell = cell_best > torch.clamp(qmin, min=0.0)

    # top max_new cells, lower index first among ties
    flat = cell_best.reshape(-1)
    vals, idx = torch.sort(flat, descending=True, stable=True)
    vals, idx = vals[:max_new], idx[:max_new]
    uv = torch.stack([cx.reshape(-1)[idx], cy.reshape(-1)[idx]],
                     dim=-1).to(torch.float32)
    valid = (vals > -torch.inf) & ok_cell.reshape(-1)[idx]
    return uv, valid
