"""Dense image ops: pyramids, gradients, bilinear sampling, blurs, max
pool, and the morphology of the depth completion.

Port of `lmono_tpu/ops/image.py`.  Images
are (H, W) float32 tensors.  `conv_general_dilated` is a cross-correlation,
as `F.conv2d` is, so kernels are not flipped; SAME padding pads with zeros
for the blurs and with −inf for `max_pool_same`.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

_I32_MIN = -2147483648.0
_I32_LIMIT = 2147483648.0      # 2^31: the first f32 above int32's range


def to_int32_xla(x: torch.Tensor) -> torch.Tensor:
    """f32 → int32 as XLA converts: truncation toward zero, NaN → 0, and
    saturation at the int32 range.  (`Tensor.to(torch.int32)` on the CPU
    gives −2^31 for NaN and for overflow in both directions.)"""
    big = x >= _I32_LIMIT
    safe = torch.where(torch.isnan(x) | big, torch.zeros_like(x), x)
    i = safe.clamp(min=_I32_MIN).to(torch.int32)
    return torch.where(big, torch.full_like(i, 2147483647), i)


def avg_pool2(img: torch.Tensor) -> torch.Tensor:
    """2x2 average downsample (pyramid level); odd edges are cropped
    (KITTI images are 1241 px wide)."""
    H, W = img.shape
    h2, w2 = (H // 2) * 2, (W // 2) * 2
    return img[:h2, :w2].reshape(H // 2, 2, W // 2, 2).mean(dim=(1, 3))


def build_pyramid(img: torch.Tensor, levels: int) -> list:
    """Gaussian-ish pyramid as a list of (H/2^l, W/2^l) tensors."""
    pyr = [img]
    for _ in range(levels - 1):
        img = avg_pool2(gauss_blur3(img))
        pyr.append(img)
    return pyr


_G3 = (0.25, 0.5, 0.25)
_SCHARR_D = (-0.5, 0.0, 0.5)
_SCHARR_S = (3.0 / 16.0, 10.0 / 16.0, 3.0 / 16.0)


@functools.lru_cache(maxsize=None)
def _taps(k: tuple, shape: tuple, dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    """A conv weight made once per device: building it per call would copy
    from host memory, which waits for the device."""
    return torch.tensor(k, dtype=dtype, device=device).reshape(shape)


def _sep_conv(img: torch.Tensor, kx, ky) -> torch.Tensor:
    """Separable 2D cross-correlation with SAME zero padding: `ky` along
    rows (H) first, then `kx` along columns (W).  img: (H, W)."""
    kh = _taps(ky, (1, 1, -1, 1), img.dtype, img.device)
    kw = _taps(kx, (1, 1, 1, -1), img.dtype, img.device)
    x = F.conv2d(img[None, None], kh, padding="same")
    x = F.conv2d(x, kw, padding="same")
    return x[0, 0]


def gauss_blur3(img: torch.Tensor) -> torch.Tensor:
    return _sep_conv(img, _G3, _G3)


_G5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def gauss_blur5(img: torch.Tensor) -> torch.Tensor:
    return _sep_conv(img, _G5, _G5)


def scharr_gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(Ix, Iy) via Scharr kernels (same choice OpenCV's KLT uses)."""
    return _sep_conv(img, _SCHARR_D, _SCHARR_S), _sep_conv(img, _SCHARR_S, _SCHARR_D)


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample img (H, W) at subpixel positions xy (..., 2) in (x, y) order.

    Each coordinate is clipped to the border on its own (callers gate
    validity separately); NaN passes the clip and reads pixel 0 with NaN
    weights, as in the reference.
    """
    H, W = img.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0 = to_int32_xla(torch.floor(x))
    y0 = to_int32_xla(torch.floor(y))
    fx = x - x0
    fy = y - y0
    x0, y0 = x0.long(), y0.long()
    i00 = img[y0, x0]
    i01 = img[y0, x0 + 1]
    i10 = img[y0 + 1, x0]
    i11 = img[y0 + 1, x0 + 1]
    top = i00 + fx * (i01 - i00)
    bot = i10 + fx * (i11 - i10)
    return top + fy * (bot - top)


def max_pool_same(img: torch.Tensor, k: int) -> torch.Tensor:
    """k×k max pool with SAME (−inf) padding, for NMS; k odd."""
    return F.max_pool2d(img[None, None], k, stride=1, padding=k // 2)[0, 0]


def dilate(img: torch.Tensor, k: int) -> torch.Tensor:
    """Grayscale morphological dilation with a k×k square structuring
    element (depth-completion building block)."""
    return max_pool_same(img, k)


def erode(img: torch.Tensor, k: int) -> torch.Tensor:
    return -max_pool_same(-img, k)


def dilate_masked(img: torch.Tensor, valid: torch.Tensor, k: int,
                  kernel=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Dilation treating invalid pixels as −inf; optional 0/1 numpy kernel
    shape (CROSS / DIAMOND / FULL).  The shaped form is a max over shifted
    copies that wrap around the borders (`roll`), as in the reference.
    Returns (dilated, new_valid)."""
    neg = torch.where(valid, img, torch.full_like(img, -torch.inf))
    if kernel is None:
        out = max_pool_same(neg, k)
    else:
        out = torch.full_like(img, -torch.inf)
        r = k // 2
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                if kernel[dy + r, dx + r] == 0:
                    continue
                out = torch.maximum(out, torch.roll(neg, (dy, dx), dims=(0, 1)))
    new_valid = out > -torch.inf
    return torch.where(new_valid, out, torch.zeros_like(out)), new_valid


def median_blur_approx(img: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Exact k×k median: the middle of the k² shifted copies (wrapping
    around the borders, as the reference's `roll`s do)."""
    r = k // 2
    stack = torch.stack([torch.roll(img, (dy, dx), dims=(0, 1))
                         for dy in range(-r, r + 1) for dx in range(-r, r + 1)])
    return torch.sort(stack, dim=0).values[stack.shape[0] // 2]
