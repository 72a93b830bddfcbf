"""The port's pinhole camera (`lmono_tpu_torch.camera`) against
`lmono_tpu.camera`: projection and lifting within 1e-4 px / 1e-6 in
normalized coordinates (f32, the same formulas), with and without radtan
distortion.  The other four models: `test_torch_camera_models.py`."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmono_tpu.camera import camera_from_config as jcam_from_config
from lmono_tpu.config import CameraConfig, kitti_scale_config, synthetic_config
from lmono_tpu_torch.camera import camera_from_config, pinhole_camera
from lmono_tpu_torch.config import CameraConfig as TCameraConfig

DISTORTED = CameraConfig(width=1920, height=1200, fx=978.536621, fy=957.115245,
                         cx=1009.157043, cy=614.557359,
                         distortion=(-0.158559839, 0.129945558, -6.04e-4, 9.13e-4))


def _port_cfg(cfg):
    return TCameraConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("cfg", [kitti_scale_config().camera,
                                 synthetic_config().camera, DISTORTED])
def test_pinhole_matches(cfg):
    jc, tc = jcam_from_config(cfg), camera_from_config(_port_cfg(cfg))
    assert tc.params == {k: float(v) for k, v in jc.params.items()}
    rng = np.random.default_rng(0)
    uv = (rng.random((300, 2)) * [cfg.width, cfg.height]).astype(np.float32)
    np.testing.assert_allclose(tc.lift_to_normalized(torch.from_numpy(uv)).numpy(),
                               np.asarray(jc.lift_to_normalized(jnp.asarray(uv))),
                               rtol=0, atol=1e-6)
    P = np.concatenate([rng.normal(size=(300, 2)), 2 + 10 * rng.random((300, 1))],
                       -1).astype(np.float32)
    np.testing.assert_allclose(tc.space_to_plane(torch.from_numpy(P)).numpy(),
                               np.asarray(jc.space_to_plane(jnp.asarray(P))),
                               rtol=0, atol=1e-4)
    xy = P[:, :2] / P[:, 2:]
    np.testing.assert_allclose(tc.undist_to_plane(torch.from_numpy(xy)).numpy(),
                               np.asarray(jc.undist_to_plane(jnp.asarray(xy))),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tc.in_image(torch.from_numpy(uv), 8.0).numpy(),
                                  np.asarray(jc.in_image(jnp.asarray(uv), 8.0)))


def test_undistortion_runs_its_fixed_iterations():
    # zero distortion still takes the 8 steps: 0·inf is NaN, as in the reference
    jc = jcam_from_config(synthetic_config().camera)
    tc = camera_from_config(_port_cfg(synthetic_config().camera))
    uv = np.array([[1e30, 5.0], [10.0, 20.0]], np.float32)
    a = np.asarray(jc.lift_to_normalized(jnp.asarray(uv)))
    b = tc.lift_to_normalized(torch.from_numpy(uv)).numpy()
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    assert np.isnan(b[0]).all()
    np.testing.assert_allclose(b[1], a[1], rtol=0, atol=1e-6)


def test_unknown_model_raises():
    with pytest.raises(ValueError):
        camera_from_config(TCameraConfig(model="fisheye9"))
    cam = pinhole_camera(64, 32, 50.0, 50.0, 32.0, 16.0)
    assert cam.name == "pinhole" and isinstance(cam.params["fx"], float)
