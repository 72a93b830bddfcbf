"""Camera factory: build a model from a `CameraConfig`.

Port of `lmono_tpu/camera/factory.py:camera_from_config` for the pinhole
model.  The reference's other four models are still to port (ROADMAP
Queue 1) and raise `NotImplementedError`.
"""

from __future__ import annotations

from lmono_tpu_torch.camera.base import CameraModel
from lmono_tpu_torch.camera.models import pinhole_camera
from lmono_tpu_torch.config import CameraConfig

_NOT_PORTED = ("pinhole_full", "mei", "equidistant", "scaramuzza")


def camera_from_config(cfg: CameraConfig) -> CameraModel:
    dd = list(cfg.distortion) + [0.0] * 8
    if cfg.model == "pinhole":
        return pinhole_camera(cfg.width, cfg.height, cfg.fx, cfg.fy,
                              cfg.cx, cfg.cy, *dd[:4])
    if cfg.model in _NOT_PORTED:
        raise NotImplementedError(
            f"camera model {cfg.model!r} is not ported yet (pinhole only)")
    raise ValueError(f"unknown camera model {cfg.model}")
