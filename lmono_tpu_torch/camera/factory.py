"""Camera factory: build any of the five models from a `CameraConfig`, a
config dict or a camodocal-style YAML file.

Port of `lmono_tpu/camera/factory.py`: the same `model_type` strings and
aliases and the same parameter layouts as camodocal's
`CameraFactory::generateCameraFromYamlFile` (e.g. `kitti00_cam.yaml` with
`model_type: PINHOLE`), read by a parser with no YAML dependency.
"""

from __future__ import annotations

import re
from typing import Optional

from lmono_tpu_torch.camera.base import CameraModel
from lmono_tpu_torch.camera.models import (
    equidistant_camera,
    mei_camera,
    pinhole_camera,
    pinhole_full_camera,
    scaramuzza_camera,
)
from lmono_tpu_torch.config import CameraConfig

_ALIASES = {
    "PINHOLE": "pinhole",
    "PINHOLE_FULL": "pinhole_full",
    "FULL_PINHOLE": "pinhole_full",
    "MEI": "mei",
    "CATA": "mei",
    "KANNALA_BRANDT": "equidistant",
    "EQUIDISTANT": "equidistant",
    "SCARAMUZZA": "scaramuzza",
    "OCAM": "scaramuzza",
}


def _poly(v) -> list:
    """Scaramuzza's polynomial from a sequence, or from camodocal's nested
    `poly_parameters: {p0: …, p1: …}` block, which the reference's factory
    cannot read (it takes a sequence only)."""
    if isinstance(v, dict):
        return [v[f"p{i}"] for i in range(len(v))]
    return list(v)


def camera_from_dict(d: dict) -> CameraModel:
    mt = _ALIASES.get(str(d.get("model_type", "pinhole")).upper(),
                      str(d.get("model_type", "pinhole")).lower())
    w = int(d.get("image_width", d.get("width")))
    h = int(d.get("image_height", d.get("height")))
    dist = d.get("distortion_parameters", {})
    proj = d.get("projection_parameters", {})
    if mt == "pinhole":
        return pinhole_camera(
            w, h, proj["fx"], proj["fy"], proj["cx"], proj["cy"],
            dist.get("k1", 0.0), dist.get("k2", 0.0),
            dist.get("p1", 0.0), dist.get("p2", 0.0))
    if mt == "pinhole_full":
        return pinhole_full_camera(
            w, h, proj["fx"], proj["fy"], proj["cx"], proj["cy"],
            dist.get("k1", 0.0), dist.get("k2", 0.0), dist.get("k3", 0.0),
            dist.get("k4", 0.0), dist.get("k5", 0.0), dist.get("k6", 0.0),
            dist.get("p1", 0.0), dist.get("p2", 0.0))
    if mt == "mei":
        return mei_camera(
            w, h, proj["gamma1"], proj["gamma2"], proj["u0"], proj["v0"],
            d.get("mirror_parameters", {}).get("xi", 1.0),
            dist.get("k1", 0.0), dist.get("k2", 0.0),
            dist.get("p1", 0.0), dist.get("p2", 0.0))
    if mt == "equidistant":
        return equidistant_camera(
            w, h, proj["mu"], proj["mv"], proj["u0"], proj["v0"],
            proj.get("k2", 0.0), proj.get("k3", 0.0),
            proj.get("k4", 0.0), proj.get("k5", 0.0))
    if mt == "scaramuzza":
        return scaramuzza_camera(
            w, h, _poly(d["poly_parameters"]), proj["center_x"], proj["center_y"],
            d.get("affine_parameters", {}).get("ac", 1.0),
            d.get("affine_parameters", {}).get("ad", 0.0),
            d.get("affine_parameters", {}).get("ae", 0.0))
    raise ValueError(f"unknown camera model_type {mt}")


def camera_from_config(cfg: CameraConfig) -> CameraModel:
    dd = list(cfg.distortion) + [0.0] * 8
    if cfg.model == "pinhole":
        return pinhole_camera(cfg.width, cfg.height, cfg.fx, cfg.fy,
                              cfg.cx, cfg.cy, *dd[:4])
    if cfg.model == "pinhole_full":
        return pinhole_full_camera(cfg.width, cfg.height, cfg.fx, cfg.fy,
                                   cfg.cx, cfg.cy, *dd[:8])
    if cfg.model == "mei":
        xi = cfg.extra[0] if cfg.extra else 1.0
        return mei_camera(cfg.width, cfg.height, cfg.fx, cfg.fy, cfg.cx,
                          cfg.cy, xi, *dd[:4])
    if cfg.model == "equidistant":
        return equidistant_camera(cfg.width, cfg.height, cfg.fx, cfg.fy,
                                  cfg.cx, cfg.cy, *dd[:4])
    if cfg.model == "scaramuzza":
        return scaramuzza_camera(cfg.width, cfg.height, list(cfg.extra),
                                 cfg.cx, cfg.cy)
    raise ValueError(f"unknown camera model {cfg.model}")


def camera_from_yaml(path: str) -> CameraModel:
    """Parse a camodocal-style OpenCV YAML: flat key/value lines with one
    level of nesting under a bare `key:` line."""
    d: dict = {}
    cur: Optional[dict] = None
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].rstrip()
            if not line or line.startswith("%"):
                continue
            m = re.match(r"^(\w+):\s*$", line)
            if m:
                cur = {}
                d[m.group(1)] = cur
                continue
            m = re.match(r"^(\s*)(\w+):\s*(.+)$", line)
            if m:
                indent, k, v = m.groups()
                v = v.strip().strip('"')
                try:
                    val = float(v) if re.match(r"^[-+0-9.eE]+$", v) else v
                except ValueError:
                    val = v
                if indent and cur is not None:
                    cur[k] = val
                else:
                    d[k] = val
                    cur = None
    return camera_from_dict(d)
