"""Sparse depth-map construction + morphological completion.

Port of `lmono_tpu/mapping/depth.py`: projection is one batched
`space_to_plane` and a scatter-min (`scatter_reduce` "amin", which has no
order to depend on), completion is dilate → close → dilate → median → blur
on the inverted depth.  `torch.round`, like `jnp.round`, rounds half to
even; the float→int casts follow XLA's rule (`to_int32_xla`).
"""

from __future__ import annotations

import numpy as np
import torch

from lmono_tpu_torch.camera.base import CameraModel
from lmono_tpu_torch.config import MappingConfig
from lmono_tpu_torch.ops.image import (
    dilate_masked,
    erode,
    gauss_blur5,
    max_pool_same,
    median_blur_approx,
    to_int32_xla,
)


def kernel_shape(kind: str, k: int) -> np.ndarray:
    """Structuring elements matching the reference's FULL/CROSS/DIAMOND
    options (`kernel_type` in kitti_map_config, Map_Builder.cc:336-360)."""
    y, x = np.mgrid[-(k // 2): k // 2 + 1, -(k // 2): k // 2 + 1]
    if kind == "full":
        return np.ones((k, k), np.float32)
    if kind == "cross":
        return ((x == 0) | (y == 0)).astype(np.float32)
    if kind == "diamond":
        return (np.abs(x) + np.abs(y) <= k // 2).astype(np.float32)
    raise ValueError(kind)


def project_cloud(points_cam: torch.Tensor, valid: torch.Tensor,
                  cam: CameraModel, depth_min: float, depth_max: float):
    """Scatter-min LiDAR points into a sparse depth image.

    points_cam: (N, 3) in camera frame.  Returns (depth (H,W), mask (H,W)).
    """
    H, W = cam.height, cam.width
    z = points_cam[..., 2]
    uv = cam.space_to_plane(points_cam)
    u = to_int32_xla(torch.round(uv[..., 0]))
    v = to_int32_xla(torch.round(uv[..., 1]))
    ok = (valid & (z > depth_min) & (z < depth_max)
          & (u >= 0) & (u < W) & (v >= 0) & (v < H))
    u = torch.clamp(u, 0, W - 1).long()
    v = torch.clamp(v, 0, H - 1).long()
    zz = torch.where(ok, z, torch.full_like(z, torch.inf))
    big = torch.full((H * W,), torch.inf, dtype=points_cam.dtype,
                     device=points_cam.device)
    depth = big.scatter_reduce(0, v * W + u, zz, "amin").reshape(H, W)
    mask = torch.isfinite(depth)
    return torch.where(mask, depth, torch.zeros_like(depth)), mask


def complete_depth(depth: torch.Tensor, mask: torch.Tensor,
                   cfg: MappingConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Morphological depth completion (reference `depthFill`) on inverted
    depth, so that near surfaces win the max-pools: invert → dilate(kernel)
    → close → small-hole dilate → median → blur → re-invert."""
    dmax = cfg.depth_max
    zero = torch.zeros_like(depth)
    inv = torch.where(mask, dmax - depth, zero)

    kern = kernel_shape(cfg.kernel_type, cfg.filter_size)
    inv, m1 = dilate_masked(inv, mask, cfg.filter_size, kern)
    # morphological close (dilate then erode) to seal speckle holes
    closed = erode(max_pool_same(inv, 5), 5)
    inv = torch.where(m1, inv, torch.clamp(closed, min=0.0))
    m2 = m1 | (closed > 0.0)
    # fill remaining small holes with a wider dilation
    wide, m3 = dilate_masked(inv, m2, 7)
    inv = torch.where(m2, inv, wide)
    m_all = m2 | m3
    # median to kill speckle, then blur to smooth
    inv = median_blur_approx(inv, 3)
    if cfg.blur_type == "gaussian":
        inv = gauss_blur5(inv)
    else:
        # bilateral-ish: blur but keep strong edges via median guard
        sm = gauss_blur5(inv)
        inv = torch.where(torch.abs(sm - inv) < 2.0, sm, inv)
    out_mask = m_all & (inv > 0)
    return torch.where(out_mask, dmax - inv, zero), out_mask


def backproject_colored(depth: torch.Tensor, mask: torch.Tensor,
                        image: torch.Tensor, cam: CameraModel,
                        cfg: MappingConfig, stride: int = 2):
    """Completed depth + RGB/gray image → colored camera-frame points,
    subsampled by `stride`.  Returns (pts (P,3), colors (P,3), valid (P,))."""
    H, W = depth.shape
    dev = depth.device
    vv, uu = torch.meshgrid(torch.arange(0, H, stride, device=dev),
                            torch.arange(0, W, stride, device=dev),
                            indexing="ij")
    uv = torch.stack([uu.to(torch.float32) + 0.5,
                      vv.to(torch.float32) + 0.5], -1).reshape(-1, 2)
    z = depth[vv, uu].reshape(-1)
    ok = mask[vv, uu].reshape(-1) & (z > cfg.depth_min) & (z < cfg.depth_max)
    rays = cam.lift_projective(uv)
    pts = rays * (z / torch.clamp(rays[..., 2], min=1e-6))[:, None]
    if image.ndim == 2:
        g = image[vv, uu].reshape(-1)
        colors = torch.stack([g, g, g], -1)
    else:
        colors = image[vv, uu].reshape(-1, 3)
    return pts, colors, ok
