"""The port's four wide-angle / rational camera models and its camera factory
(`lmono_tpu_torch.camera`) against `lmono_tpu.camera`, on the parameters of
`tests/test_camera.py` and seeded numpy inputs.

Tolerances (f32, the same formulas and fixed iteration counts):
* `space_to_plane` within 1e-4 px (1e-3 px for scaramuzza, whose 20 Newton
  steps start at ρ = 100 and end on the f32 grid of ρ);
* `lift_projective` and `lift_to_normalized` within 1e-5 (the equidistant
  lift's Newton derivative is written out where the reference takes
  `jax.grad`; the two round differently);
* the factory: the same model, size and parameters (float32-exact) from a
  config dict (the aliases and defaults), a camodocal YAML file per model
  written to `tmp_path` and a `CameraConfig`.  The port also reads
  camodocal's nested `poly_parameters: {p0: …}` block, which the
  reference's factory cannot (its scaramuzza takes a sequence);
* differentiability: `torch.func.jacrev` of each model's projection with
  respect to the points and to parameters passed as tensors, against
  `jax.jacrev` of the reference's, within 1e-3 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmono_tpu.camera import camera_from_config as jfrom_config
from lmono_tpu.camera import camera_from_dict as jfrom_dict
from lmono_tpu.camera import models as jm
from lmono_tpu.config import CameraConfig
from lmono_tpu_torch.camera import (camera_from_config, camera_from_dict,
                                    camera_from_yaml)
from lmono_tpu_torch.camera import models as tm
from lmono_tpu_torch.config import CameraConfig as TCameraConfig

# (name, constructor args, kwargs, field of view of the test points, px atol)
MODELS = [
    ("pinhole_full", (1280, 720, 600.0, 600.0, 640.0, 360.0),
     dict(k1=-0.2, k2=0.05, k3=-0.01, k4=-0.15, k5=0.03, k6=-0.005, p1=1e-4, p2=1e-4),
     0.4, 1e-4),
    ("mei", (752, 480, 370.0, 369.0, 376.0, 240.0),
     dict(xi=0.9, k1=-0.05, k2=0.005, p1=2e-4, p2=-1e-4), 0.6, 1e-4),
    ("equidistant", (752, 480, 350.0, 350.0, 376.0, 240.0),
     dict(k2=0.01, k3=-0.002, k4=0.0005, k5=1e-5), 0.8, 1e-4),
    ("scaramuzza", (752, 480, (-250.0, 0.0, 0.002), 376.0, 240.0),
     dict(c=1.0, d=0.001, e=-0.001), 0.5, 1e-3),
]


def _make(name, args, kw):
    ctor = f"{name}_camera"
    return getattr(jm, ctor)(*args, **kw), getattr(tm, ctor)(*args, **kw)


def _points(seed, fov, n=256):
    rng = np.random.default_rng(seed)
    z = rng.uniform(2.0, 30.0, (n, 1))
    xy = fov * rng.uniform(-1.0, 1.0, (n, 2)) * z
    return np.concatenate([xy, z], -1).astype(np.float32)


def _pixels(seed, w, h, n=256):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 0.9, (n, 2)) * [w, h]).astype(np.float32)


@pytest.mark.parametrize("name,args,kw,fov,atol", MODELS, ids=[m[0] for m in MODELS])
def test_model_matches(name, args, kw, fov, atol):
    jc, tc = _make(name, args, kw)
    assert tc.name == jc.name and (tc.width, tc.height) == (jc.width, jc.height)
    for k, v in jc.params.items():
        np.testing.assert_array_equal(np.asarray(tc.params[k], np.float32), np.asarray(v))
    P = _points(1, fov)
    np.testing.assert_allclose(tc.space_to_plane(torch.from_numpy(P)).numpy(),
                               np.asarray(jc.space_to_plane(jnp.asarray(P))),
                               rtol=0, atol=atol)
    uv = _pixels(2, jc.width, jc.height)
    np.testing.assert_allclose(tc.lift_projective(torch.from_numpy(uv)).numpy(),
                               np.asarray(jc.lift_projective(jnp.asarray(uv))),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tc.lift_to_normalized(torch.from_numpy(uv)).numpy(),
                               np.asarray(jc.lift_to_normalized(jnp.asarray(uv))),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,args,kw,fov,atol", MODELS[:3], ids=[m[0] for m in MODELS[:3]])
def test_model_is_differentiable(name, args, kw, fov, atol):
    """The projection's Jacobian in the points and in the parameters, as
    the calibration's GN takes it, against the reference's."""
    jc, tc = _make(name, args, kw)
    P = _points(3, fov, n=8)
    keys = sorted(jc.params)

    def jfun(theta, P):
        return jc._space_to_plane(dict(zip(keys, theta)), P)

    def tfun(theta, P):
        return tc._space_to_plane({k: theta[i] for i, k in enumerate(keys)}, P)

    theta = np.array([jc.params[k] for k in keys], np.float32)
    jj = jax.jacrev(jfun, argnums=(0, 1))(list(jnp.asarray(theta)), jnp.asarray(P))
    tj = torch.func.jacrev(tfun, argnums=(0, 1))(torch.from_numpy(theta), torch.from_numpy(P))
    j_theta = np.stack([np.asarray(g) for g in jj[0]], -1)
    for a, b in ((tj[0].numpy(), j_theta), (tj[1].numpy(), np.asarray(jj[1]))):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3 * np.abs(b).max())


YAML = {
    "pinhole": """%YAML:1.0
---
model_type: PINHOLE
camera_name: kitti00
image_width: 1241
image_height: 376
distortion_parameters:
   k1: -0.1
   k2: 0.01
   p1: 1.0e-4
   p2: -2.0e-4
projection_parameters:
   fx: 718.856
   fy: 718.856
   cx: 607.1928
   cy: 185.2157
""",
    "pinhole_full": """model_type: FULL_PINHOLE
image_width: 1280
image_height: 720
distortion_parameters:
   k1: -0.2
   k2: 0.05
   k3: -0.01
   k4: -0.15
   k5: 0.03
   k6: -0.005
   p1: 1.0e-4
   p2: 1.0e-4
projection_parameters:
   fx: 600.0
   fy: 601.0
   cx: 640.0
   cy: 360.0
""",
    "mei": """model_type: MEI
image_width: 752
image_height: 480
mirror_parameters:
   xi: 0.9   # unified-model mirror parameter
distortion_parameters:
   k1: -0.05
   k2: 0.005
   p1: 2.0e-4
   p2: -1.0e-4
projection_parameters:
   gamma1: 370.0
   gamma2: 369.0
   u0: 376.0
   v0: 240.0
""",
    "equidistant": """model_type: KANNALA_BRANDT
image_width: 752
image_height: 480
projection_parameters:
   k2: 0.01
   k3: -0.002
   k4: 0.0005
   k5: 1.0e-5
   mu: 350.0
   mv: 351.0
   u0: 376.0
   v0: 240.0
""",
    # camodocal's nested poly block, which the reference's factory cannot
    # read (it takes a sequence); its dict form is checked below
    "scaramuzza": """model_type: SCARAMUZZA
image_width: 752
image_height: 480
poly_parameters:
   p0: -250.0
   p1: 0.0
   p2: 0.002
affine_parameters:
   ac: 1.0
   ad: 0.001
   ae: -0.001
projection_parameters:
   center_x: 376.0
   center_y: 240.0
""",
}


SCARA_DICT = {"model_type": "SCARAMUZZA", "image_width": 752, "image_height": 480,
              "poly_parameters": [-250.0, 0.0, 0.002],
              "affine_parameters": {"ac": 1.0, "ad": 0.001, "ae": -0.001},
              "projection_parameters": {"center_x": 376.0, "center_y": 240.0}}

# the aliases, the `width`/`height` keys and the defaults of absent blocks
DICTS = [
    {"model_type": "pinhole", "width": 640, "height": 480,
     "projection_parameters": {"fx": 500.0, "fy": 501.0, "cx": 320.0, "cy": 240.0}},
    {"model_type": "PINHOLE_FULL", "image_width": 640, "image_height": 480,
     "projection_parameters": {"fx": 500.0, "fy": 501.0, "cx": 320.0, "cy": 240.0},
     "distortion_parameters": {"k1": -0.2, "k4": -0.1, "p2": 1e-4}},
    {"model_type": "CATA", "image_width": 752, "image_height": 480,
     "projection_parameters": {"gamma1": 370.0, "gamma2": 369.0, "u0": 376.0, "v0": 240.0}},
    {"model_type": "EQUIDISTANT", "image_width": 752, "image_height": 480,
     "projection_parameters": {"mu": 350.0, "mv": 351.0, "u0": 376.0, "v0": 240.0,
                               "k2": 0.01}},
    dict(SCARA_DICT, model_type="OCAM", affine_parameters={}),
    SCARA_DICT,
]


def _same_camera(tc, jc):
    assert tc.name == jc.name and (tc.width, tc.height) == (jc.width, jc.height)
    assert set(tc.params) == set(jc.params)
    for k, v in jc.params.items():
        np.testing.assert_array_equal(np.asarray(tc.params[k], np.float32), np.asarray(v),
                                      err_msg=k)


@pytest.mark.parametrize("name", list(YAML))
def test_factory_from_yaml(name, tmp_path):
    from lmono_tpu.camera.factory import camera_from_yaml as jfrom_yaml

    path = tmp_path / f"{name}.yaml"
    path.write_text(YAML[name])
    tc = camera_from_yaml(str(path))
    assert tc.name == name
    if name == "scaramuzza":
        with pytest.raises(TypeError):
            jfrom_yaml(str(path))
        jc = jfrom_dict(SCARA_DICT)
    else:
        jc = jfrom_yaml(str(path))
    _same_camera(tc, jc)


@pytest.mark.parametrize("d", DICTS, ids=[d["model_type"] for d in DICTS])
def test_factory_from_dict(d):
    _same_camera(camera_from_dict(d), jfrom_dict(d))


def test_factory_unknown_model_raises():
    with pytest.raises(ValueError):
        camera_from_dict({"model_type": "FISHEYE9", "width": 8, "height": 8})


@pytest.mark.parametrize("model,extra,dist", [
    ("pinhole", (), (-0.1, 0.01, 1e-4, -2e-4)),
    ("pinhole_full", (), (-0.2, 0.05, -0.01, -0.15, 0.03, -0.005, 1e-4, 1e-4)),
    ("mei", (0.9,), (-0.05, 0.005, 2e-4, -1e-4)),
    ("equidistant", (), (0.01, -0.002, 0.0005, 1e-5)),
    ("scaramuzza", (-250.0, 0.0, 0.002), ()),
])
def test_factory_from_config(model, extra, dist):
    cfg = CameraConfig(model=model, width=752, height=480, fx=370.0, fy=369.0,
                       cx=376.0, cy=240.0, distortion=dist, extra=extra)
    jc = jfrom_config(cfg)
    tc = camera_from_config(TCameraConfig(**dataclasses.asdict(cfg)))
    _same_camera(tc, jc)
    uv = _pixels(5, 752, 480, n=64)
    np.testing.assert_allclose(tc.lift_projective(torch.from_numpy(uv)).numpy(),
                               np.asarray(jc.lift_projective(jnp.asarray(uv))),
                               rtol=0, atol=1e-5)
