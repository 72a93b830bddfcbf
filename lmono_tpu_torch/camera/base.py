"""Camera model API: batched projection and lifting over tensors.

Port of `lmono_tpu/camera/base.py`.  A model is a parameter dict plus two
pure functions.  Parameters are host floats rounded to float32, as the
reference stores them (`jnp.float32`): reading one (the tracker's focal
length) never waits for the device, and tensor arithmetic with them runs
in float32 as the reference's does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class CameraModel:
    """A camera model = parameter dict + pure projection functions.

    space_to_plane(params, P):  (...,3) camera-frame points → (...,2) pixels
    lift_projective(params, uv): (...,2) pixels → (...,3) unit rays
    """

    name: str
    params: dict
    width: int
    height: int
    _space_to_plane: Callable
    _lift_projective: Callable

    def space_to_plane(self, P: torch.Tensor) -> torch.Tensor:
        return self._space_to_plane(self.params, P)

    def lift_projective(self, uv: torch.Tensor) -> torch.Tensor:
        return self._lift_projective(self.params, uv)

    def lift_to_normalized(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixels → normalized image-plane coords (x/z, y/z)."""
        ray = self.lift_projective(uv)
        return ray[..., :2] / torch.clamp(ray[..., 2:3], min=1e-9)

    def undist_to_plane(self, xy_norm: torch.Tensor) -> torch.Tensor:
        """Normalized undistorted coords → distorted pixel coords
        (camodocal `Camera::undistToPlane` semantics)."""
        P = torch.cat([xy_norm, torch.ones_like(xy_norm[..., :1])], -1)
        return self.space_to_plane(P)

    def in_image(self, uv: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
        return ((uv[..., 0] >= margin) & (uv[..., 0] < self.width - margin)
                & (uv[..., 1] >= margin) & (uv[..., 1] < self.height - margin))


def _iterative_undistort(distort_fn, xy_d: torch.Tensor,
                         iters: int = 8) -> torch.Tensor:
    """Fixed-point inversion x_u ≈ x_d − D(x_u), as camodocal's recursive
    undistortion does (`PinholeCamera.cc` liftProjective loop).  Always
    `iters` steps, even with zero distortion: 0·inf is NaN, as in the
    reference."""
    x = xy_d
    for _ in range(iters):
        x = xy_d - distort_fn(x)
    return x
