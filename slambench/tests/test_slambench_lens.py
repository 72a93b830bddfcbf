"""The simulator's lens and figure-8 against the port's own camera model and
trajectory: the lens projects as `camera_from_config` does on the Hong Kong
rig's 1920×1200 radtan camera, and inverts itself; the figure-8 closes on
itself every lap and runs on the port's centre line."""

from __future__ import annotations

import math

import pytest
import torch

from slambench.tests.tiny import TINY
from slambench.traffic import figure8, lens, sim
from slambench.traffic.drive import Drive


@pytest.fixture(scope="module")
def hk():
    from lmono_tpu_torch.camera.factory import camera_from_config
    from lmono_tpu_torch.config import hk_config

    c = hk_config().camera
    cam = {"width": c.width, "height": c.height, "fx": c.fx, "fy": c.fy, "cx": c.cx, "cy": c.cy}
    k = lens.lens_of({"model": c.model, "distortion": list(c.distortion)})
    return cam, k, camera_from_config(c)


def _pixel_centres(cam):
    u = torch.arange(cam["width"], dtype=torch.float64) + 0.5
    v = torch.arange(cam["height"], dtype=torch.float64) + 0.5
    return torch.stack(torch.meshgrid(u, v, indexing="xy"), -1)


def test_lens_projects_as_the_port(hk):
    cam, k, model = hk
    assert k is not None and k[0] < -0.1
    rays = lens.camera_ray_dirs(cam, k, dtype=torch.float64)
    port = model.space_to_plane(rays.float()).double()
    ours = lens.project(cam, k, rays)
    assert float((port - ours).abs().max()) < 1e-3


def test_lens_round_trips(hk):
    cam, k, _ = hk
    grid = _pixel_centres(cam)
    back = lens.project(cam, k, lens.camera_ray_dirs(cam, k, dtype=torch.float64))
    assert float((back - grid).abs().max()) < 1e-3
    back32 = lens.project(cam, k, lens.camera_ray_dirs(cam, k))
    assert float((back32 - grid.float()).abs().max()) < 1e-3
    x, y = lens.lift(cam, k, grid[..., 0], grid[..., 1])
    p = torch.stack([x, y, torch.ones_like(x)], -1)
    assert float((lens.project(cam, k, p) - grid).abs().max()) < 1e-3


def test_lens_reprojects_through_the_distortion(hk):
    """A pixel seen from one pose lands, after the render's ray and the
    forward distortion, where the same pose puts it: the identity motion
    gives the pixel back."""
    cam, k, _ = hk
    scene = sim.make_city_scene()
    pose = (torch.tensor([30.0, 0.0, 1.7]), sim.quat_from_axis_angle(
        torch.tensor([-math.pi / 2, 0.0, 0.0])))
    uv0 = torch.tensor([[5.0, 7.0], [960.0, 600.0], [1900.0, 1180.0], [300.0, 900.0]])
    uv1, ok = lens.reproject_pixels(scene, pose, pose, cam, k, uv0)
    assert bool(ok.any())
    assert float((uv1[ok] - uv0[ok]).abs().max()) < 1e-3


def test_lens_of_refuses_what_the_simulator_lacks():
    assert lens.lens_of({"model": "pinhole", "distortion": [0.0, 0.0, 0.0, 0.0]}) is None
    assert lens.lens_of({"model": "pinhole"}) is None
    for cam in ({"model": "mei", "distortion": [0.1, 0, 0, 0]},
                {"model": "equidistant", "distortion": [0.0] * 4},
                {"model": "pinhole", "distortion": [0.1, 0, 0, 0, 0.01]}):
        with pytest.raises(ValueError, match="not in the simulator"):
            lens.lens_of(cam)


def test_drive_renders_through_a_distorted_lens():
    """A configuration with radtan distortion renders, lifts and reprojects
    through the lens; the same camera without it through the pinhole."""
    system = {"lidar": dict(TINY["lidar"], min_range=1.0, vertical_fov_deg=[-24.9, 2.0]),
              "camera": dict(TINY["camera"], model="pinhole",
                             distortion=[-0.16, 0.13, -6e-4, 9e-4])}
    traffic = {"generator": "figure8", "lap_frames": 204, "radius_m": 26.0, "height_m": 1.7,
               "swing_m": 0.8, "tilt": 0.18, "dt_s": 0.1, "scene_seed": 7,
               "noise_std_m": 0.01, "history": None}
    bent = Drive(traffic, system, torch.device("cpu"))
    straight = Drive(traffic, dict(system, camera=TINY["camera"]), torch.device("cpu"))
    assert bent.lens is not None and straight.lens is None
    assert torch.equal(bent.ray_dirs(), lens.camera_ray_dirs(bent.cam, bent.lens))
    assert torch.equal(straight.ray_dirs(), sim.camera_ray_dirs(straight.cam))
    corner = (bent.ray_dirs()[0, 0] - straight.ray_dirs()[0, 0]).abs().max()
    assert float(corner) > 1e-3
    img_b, img_s = bent.make([3], 1)[0]["image"], straight.make([3], 1)[0]["image"]
    assert not torch.equal(img_b, img_s)


@pytest.mark.parametrize("start", [0, 37, 240])
def test_figure8_closes_every_lap(start):
    idx = torch.arange(start, start + 204)
    a = figure8.figure8_pose(idx, 204, 26.0, 1.7, 0.8, 0.18)
    b = figure8.figure8_pose(idx + 204, 204, 26.0, 1.7, 0.8, 0.18)
    # float32 rounding of the lap's parameter at ~20 rad, times the radius
    assert float((a[0] - b[0]).abs().max()) < 2e-4
    assert float((a[1] - b[1]).abs().max()) < 2e-5


def test_figure8_runs_on_the_ports_centre_line():
    from lmono_tpu_torch.io.synthetic import figure8_trajectory

    lap, radius, dt = 204, 26.0, 0.1
    speed = 2.0 * math.pi * radius / (lap * dt)   # the port's parameter at equal s
    port = figure8_trajectory(lap, radius=radius, dt=dt, speed=speed)
    t, q = figure8.figure8_pose(torch.arange(lap), lap, radius, 1.7, 0.8, 0.18, dt)
    assert float((port.t[:, :2] - t[:, :2]).abs().max()) < 1e-4

    def yaw(q):   # both compose yaw, pitch, roll in that order (ZYX)
        return torch.atan2(2 * (q[:, 0] * q[:, 3] + q[:, 1] * q[:, 2]),
                           1 - 2 * (q[:, 2] ** 2 + q[:, 3] ** 2))

    gap = torch.remainder(yaw(q) - yaw(port.q) + math.pi, 2 * math.pi) - math.pi
    assert float(gap.abs().max()) < 1e-4


def test_figure8_in_bfloat16_follows_its_input():
    t, q = figure8.figure8_pose(torch.arange(10), 204, 26.0, 1.7, 0.8, 0.18,
                                dtype=torch.bfloat16)
    assert t.dtype == q.dtype == torch.bfloat16
