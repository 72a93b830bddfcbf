"""Stereo support: right-image tracking pass + disparity→depth.

Port of `lmono_tpu/estimator/stereo.py`: `FeatureTracker::trackImage`'s
optional right-image pass (`FeatureTracker.cc:305-347`, the `stereo:`
config flag) and `StereoModel::projectDisparityTo3d`
(`src/image_process/CameraModel.cc:16-54`, the OpenCV Q-matrix).  Stereo
depths give features metric depth at once, with no multi-view
triangulation delay.

`stereo_match` tracks the left features into the right image one way
through `ops.lk.track_pyramid`: one launch of the LK kernel over every
level on CUDA tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lmono_tpu_torch.ops.image import build_pyramid
from lmono_tpu_torch.ops.lk import track_pyramid


class StereoModel(NamedTuple):
    """Rectified stereo rig: fx/fy/cx/cy of the left camera + baseline."""

    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float   # meters (Tx)

    def disparity_to_depth(self, disparity: torch.Tensor) -> torch.Tensor:
        """z = fx·B / d (projectDisparityTo3d's z row)."""
        return self.fx * self.baseline / torch.clamp(disparity, min=1e-6)

    def disparity_to_3d(self, uv: torch.Tensor, disparity: torch.Tensor) -> torch.Tensor:
        """Pixels + disparity → left-camera 3D points (Q-matrix semantics)."""
        z = self.disparity_to_depth(disparity)
        x = (uv[..., 0] - self.cx) / self.fx * z
        y = (uv[..., 1] - self.cy) / self.fy * z
        return torch.stack([x, y, z], dim=-1)


def stereo_match(left_pyr, left_grads, right_image: torch.Tensor,
                 uv_left: torch.Tensor, alive: torch.Tensor, patch: int = 21,
                 iters: int = 10, max_vertical_err: float = 1.5,
                 levels: int = 3) -> tuple[torch.Tensor, torch.Tensor]:
    """Track left-image features into the right image (LK along the
    epipolar line of a rectified pair) and return disparities.

    left_pyr / left_grads: the left image's pyramid (finest first) and its
    (ix, iy) per level; uv_left (N,2) level-0 pixels; alive (N,) bool.
    Returns (disparity (N,), ok (N,)).  The right pyramid's gradients,
    which the reference builds and never reads, are not computed.
    """
    right_pyr = build_pyramid(right_image, levels)
    uv_r, ok = track_pyramid(list(left_pyr[:levels]), list(left_grads[:levels]),
                             right_pyr, uv_left, alive, patch, iters, 0.01)
    disparity = uv_left[:, 0] - uv_r[:, 0]
    vert = torch.abs(uv_r[:, 1] - uv_left[:, 1])
    ok = ok & (disparity > 0.1) & (vert < max_vertical_err)
    return disparity, ok
