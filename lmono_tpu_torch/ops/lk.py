"""Pyramidal Lucas–Kanade feature tracking over all feature slots at once.

Port of `lmono_tpu/ops/lk.py`: a translational KLT — per level, the 2×2
normal matrix comes from template gradients, and iterations update the
match position with bilinear sampling — with the forward-backward check of
the reference front-end (`FeatureTracker.cc:218-235`).

The port is held to the JAX package's TPU route.  There, `track_pyramid`
runs the Pallas kernel (`ops/pallas/lk.py:_lk_kernel`) on every level at
least 128 px wide and the vmapped `lk_level` on narrower ones, and the two
differ at borders, in the inverse and in the ok gate (see `csrc/lk.cu`).
`level_table` holds that rule.  `track_fb` runs CUDA tensors through one
launch of the hand-written kernel (`ops/cuda/lk.py`: every level, both
directions) and CPU tensors through `track_fb_plain`, the same chain of
`lk_level_plain` calls (`track_pyramid_plain` each way); `track_pyramid`,
the one-way track (the stereo match's), takes one launch of the same
kernel over every level on CUDA tensors and `track_pyramid_plain` on CPU
tensors.  There is no fallback: the kernel raises instead.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from lmono_tpu_torch.ops.image import bilinear_sample, to_int32_xla

PALLAS_MIN_WIDTH = 128      # narrower levels take the vmapped semantics
_PALLAS_STEP_THRESH = 0.1   # the TPU kernel's convergence gate (px)

# calls of `lk_level_plain`; read with the kernel's launch count to show
# which path a run took
lk_plain_calls = 0


def _slab_patches(img: torch.Tensor, xf: torch.Tensor, yf: torch.Tensor,
                  patch: int) -> torch.Tensor:
    """`_lk_kernel`'s bilinear P×P patches at (xf, yf) (N,): read from a
    (P+1)² slab whose base is clamped into the image, so the weights
    extrapolate at borders.  Returns (N, P, P)."""
    H, W = img.shape
    P, S = patch, patch + 1
    r = (P - 1) * 0.5
    xr, yr = xf - r, yf - r
    bxi = torch.clamp(to_int32_xla(torch.floor(xr)), 0, W - S)
    byi = torch.clamp(to_int32_xla(torch.floor(yr)), 0, H - S)
    fx, fy = (xr - bxi)[:, None, None], (yr - byi)[:, None, None]
    ar = torch.arange(S, device=img.device)
    rows = byi.long()[:, None] + ar
    cols = bxi.long()[:, None] + ar
    slab = img[rows[:, :, None], cols[:, None, :]]            # (N, S, S)
    tl, tr = slab[:, :P, :P], slab[:, :P, 1:]
    bl, br = slab[:, 1:, :P], slab[:, 1:, 1:]
    top = tl + fx * (tr - tl)
    bot = bl + fx * (br - bl)
    return top + fy * (bot - top)


def _lk_pallas_plain(img0, ix0, iy0, img1, pts0, guess, patch, iters):
    """`_lk_kernel` for all slots (see `_slab_patches`)."""
    H, W = img0.shape
    if H < patch + 1 or W < patch + 1:
        raise ValueError(f"image {H}x{W} too small for patch {patch}")
    x0, y0 = pts0[:, 0], pts0[:, 1]
    t = _slab_patches(img0, x0, y0, patch)
    gx = _slab_patches(ix0, x0, y0, patch)
    gy = _slab_patches(iy0, x0, y0, patch)
    gxx = (gx * gx).sum((1, 2))
    gxy = (gx * gy).sum((1, 2))
    gyy = (gy * gy).sum((1, 2))
    det = gxx * gyy - gxy * gxy
    ok_g = det > 1e-6
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    i00 = gyy * inv_det
    i01 = -gxy * inv_det
    i11 = gxx * inv_det

    xf, yf = guess[:, 0], guess[:, 1]
    step = torch.zeros_like(xf)
    for _ in range(iters):
        it = _slab_patches(img1, xf, yf, patch) - t
        bx = (it * gx).sum((1, 2))
        by = (it * gy).sum((1, 2))
        dx = i00 * bx + i01 * by
        dy = i01 * bx + i11 * by
        xf, yf = xf - dx, yf - dy
        step = torch.sqrt(dx * dx + dy * dy)
    ok = (ok_g & (step < _PALLAS_STEP_THRESH)
          & (xf > 1.0) & (xf < W - 2.0) & (yf > 1.0) & (yf < H - 2.0))
    return torch.stack([xf, yf], dim=-1), ok


def _patch_offsets(patch: int, device) -> torch.Tensor:
    """(patch², 2) offsets of the sampling grid around a centre, x fastest."""
    offs = torch.arange(patch, dtype=torch.float32, device=device) - patch // 2
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=-1)


def _lk_xla_plain(img0, ix0, iy0, img1, pts0, guess, patch, iters, eps):
    """The vmapped `lk_level`: each sample coordinate is clipped on its own;
    ok = det > 1e-6 and the last step under 10·eps."""
    o = _patch_offsets(patch, img0.device)
    c0 = pts0[:, None, :] + o
    t = bilinear_sample(img0, c0)
    gx = bilinear_sample(ix0, c0)
    gy = bilinear_sample(iy0, c0)
    gxx = (gx * gx).sum(1)
    gxy = (gx * gy).sum(1)
    gyy = (gy * gy).sum(1)
    det = gxx * gyy - gxy * gxy
    ok_g = det > 1e-6
    den = torch.clamp(det, min=1e-12)
    inv00 = torch.where(ok_g, gyy / den, 0.0)
    inv01 = torch.where(ok_g, -gxy / den, 0.0)
    inv11 = torch.where(ok_g, gxx / den, 0.0)

    pt = guess
    step = torch.zeros_like(pt[:, 0])
    for _ in range(iters):
        it = bilinear_sample(img1, pt[:, None, :] + o) - t
        bx = (it * gx).sum(1)
        by = (it * gy).sum(1)
        d = torch.stack([inv00 * bx + inv01 * by, inv01 * bx + inv11 * by], -1)
        pt = pt - d
        step = torch.linalg.norm(d, dim=-1)
    return pt, (step < eps * 10.0) & ok_g


def lk_level_plain(img0, ix0, iy0, img1, pts0, guess, patch: int, iters: int,
                   pallas: bool = True, eps: float = 0.01
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of one LK level for all slots: images (H,W),
    pts0/guess (N,2) in this level's pixels → (pt1 (N,2), ok (N,) bool).
    `pallas` picks the TPU kernel's semantics, else the vmapped
    reference's (gate 10·eps)."""
    global lk_plain_calls
    lk_plain_calls += 1
    if pallas:
        return _lk_pallas_plain(img0, ix0, iy0, img1, pts0, guess, patch, iters)
    return _lk_xla_plain(img0, ix0, iy0, img1, pts0, guess, patch, iters, eps)


class LevelPlan(NamedTuple):
    """How one pyramid level is tracked: its shape, which semantics it
    takes, and the scale from level-0 pixels to its own (2^-level)."""
    H: int
    W: int
    pallas: bool
    scale: float


def level_table(shapes: Sequence, patch: int) -> list[LevelPlan]:
    """The TPU route's rule (`lmono_tpu/ops/lk.py:track_pyramid`) for each
    level, finest first: levels at least `PALLAS_MIN_WIDTH` wide take the
    TPU kernel's semantics, narrower ones the vmapped reference's.  Raises where a TPU-semantics level is smaller
    than patch + 1 in either direction."""
    out = []
    for lvl, (H, W) in enumerate(shapes):
        pallas = W >= PALLAS_MIN_WIDTH
        if pallas and (H < patch + 1 or W < patch + 1):
            raise ValueError(f"level {lvl} ({H}x{W}) too small for patch {patch}")
        out.append(LevelPlan(int(H), int(W), pallas, 2.0 ** -lvl))
    return out


def track_pyramid_plain(pyr0: Sequence, grads0: Sequence, pyr1: Sequence,
                        pts0: torch.Tensor, mask: torch.Tensor, patch: int,
                        iters: int, eps: float
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Track pts0 (N,2) from pyramid pyr0 to pyr1, coarse→fine, with
    `lk_level_plain` on each level as `level_table` says: the plain
    version, on CPU and CUDA tensors alike (the kernel runs both
    directions of `track_fb` at once).

    pyr*/grads0 are lists (len L) of (H,W) tensors (grads0[l] = (ix, iy)).
    Returns (pts1 (N,2), ok (N,)).
    """
    levels = level_table([p.shape for p in pyr0], patch)
    guess = pts0 * levels[-1].scale
    ok = mask
    for lvl in range(len(levels) - 1, -1, -1):
        ix0, iy0 = grads0[lvl]
        guess, conv = lk_level_plain(pyr0[lvl], ix0, iy0, pyr1[lvl],
                                     pts0 * levels[lvl].scale, guess, patch,
                                     iters, pallas=levels[lvl].pallas, eps=eps)
        ok = ok & conv
        if lvl > 0:
            guess = guess * 2.0
    H, W = pyr0[0].shape
    inb = ((guess[:, 0] > 1) & (guess[:, 0] < W - 2)
           & (guess[:, 1] > 1) & (guess[:, 1] < H - 2))
    return guess, ok & inb


def track_pyramid(pyr0: Sequence, grads0: Sequence, pyr1: Sequence,
                  pts0: torch.Tensor, mask: torch.Tensor, patch: int,
                  iters: int, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """One-way pyramidal track of pts0 (N,2) from pyr0 to pyr1 (see
    `track_pyramid_plain`): CUDA tensors take one kernel launch for every
    level, CPU tensors `track_pyramid_plain`.  Only the first frame's
    gradients are read."""
    if pts0.is_cuda:
        from lmono_tpu_torch.ops.cuda.lk import track_pyramid_cuda
        return track_pyramid_cuda(pyr0, grads0, pyr1, pts0.contiguous(),
                                  mask.contiguous(), patch, iters, eps)
    return track_pyramid_plain(pyr0, grads0, pyr1, pts0, mask, patch, iters, eps)


def _fb_gate(pts0, back, ok1, ok2, fb_thresh):
    fb_err = torch.linalg.norm(back - pts0, dim=-1)
    return ok1 & ok2 & (fb_err < fb_thresh)


def track_fb_plain(pyr0, grads0, pyr1, grads1, pts0, mask, patch: int = 21,
                   iters: int = 10, eps: float = 0.01, fb_thresh: float = 0.5):
    """Plain PyTorch forward-backward tracking: `track_pyramid_plain`
    there and back (reference `FeatureTracker.cc:218-235`).  Returns (pts1 (N,2),
    ok (N,))."""
    pts1, ok1 = track_pyramid_plain(pyr0, grads0, pyr1, pts0, mask, patch,
                                    iters, eps)
    back, ok2 = track_pyramid_plain(pyr1, grads1, pyr0, pts1, ok1, patch,
                                    iters, eps)
    return pts1, _fb_gate(pts0, back, ok1, ok2, fb_thresh)


def track_fb(pyr0, grads0, pyr1, grads1, pts0, mask, patch: int = 21,
             iters: int = 10, eps: float = 0.01, fb_thresh: float = 0.5):
    """Forward-backward tracking: CUDA tensors take one kernel launch for
    every level and both directions, CPU tensors `track_fb_plain`."""
    if pts0.is_cuda:
        from lmono_tpu_torch.ops.cuda.lk import track_fb_cuda
        pts1, ok1, back, ok2 = track_fb_cuda(
            pyr0, grads0, pyr1, grads1, pts0.contiguous(), mask.contiguous(),
            patch, iters, eps)
        return pts1, _fb_gate(pts0, back, ok1, ok2, fb_thresh)
    return track_fb_plain(pyr0, grads0, pyr1, grads1, pts0, mask, patch,
                          iters, eps, fb_thresh)
