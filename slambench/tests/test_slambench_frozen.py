"""The cells that drive the circuit through a pinhole camera keep their
frames and truth: through the drive that also knows the figure-8 and the
lens, each of their traffic mixes gives, at the small cell's widths, exactly
what the frozen simulator's own functions give, and the simulator itself is
the file it was."""

from __future__ import annotations

import hashlib
import json

import pytest
import torch

from slambench.tests.tiny import BENCH, TINY
from slambench.traffic import sim
from slambench.traffic.drive import Drive

# the cells of the circuit, each traffic mix with its configuration
CIRCUIT = {"lap1": "kitti00", "revisit": "kitti00", "yaw-only": "kitti02-calib"}
SIM_SHA256 = "ef40a2a02fb67777768b29c880403ad66f64f831bd49e6240d71bdf81d0d10de"
SCAN = ("points", "ranges", "valid")


def _system(config: str) -> dict:
    system = json.loads((BENCH / "configs" / f"{config}.json").read_text())["system"]
    for group in ("lidar", "camera"):
        system[group].update(TINY[group])
    return system


def _frames(traffic: dict, system: dict, indices, seed: int) -> list:
    """The frames as the simulator makes them, written out with its own
    functions: the circuit, the rig, the sweep and the pinhole render."""
    lid, cam = system["lidar"], {k: system["camera"][k]
                                 for k in ("width", "height", "fx", "fy", "cx", "cy")}
    scene = sim.make_city_scene(seed=traffic["scene_seed"])
    T_LC = sim.inverse(sim.rig_T_CL())
    g = torch.Generator().manual_seed(seed)
    dirs_s = sim.lidar_ray_dirs(lid["num_rings"], lid["horiz_res"], lid["vertical_fov_deg"])
    dirs_c = sim.camera_ray_dirs(cam)
    out = []
    for i in indices:
        t, q = sim.circuit_pose(torch.tensor([i]), traffic["lap_frames"], traffic["radius_m"],
                                traffic["height_m"], traffic["wobble"], traffic["dt_s"])
        noise = torch.randn(dirs_s.shape[:2], generator=g)
        scan = sim.simulate_lidar(scene, (t[0], q[0]), dirs_s, lid["min_range"],
                                  lid["max_range"], noise, traffic["noise_std_m"])
        img, _ = sim.render_camera(scene, sim.compose((t[0], q[0]), T_LC), dirs_c)
        out.append({**scan, "image": img})
    return out


def _equal_frames(a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x[k], y[k]) for x, y in zip(a, b)
                                    for k in SCAN + ("image",))


@pytest.mark.parametrize("traffic", sorted(CIRCUIT))
def test_circuit_cells_are_unchanged(traffic):
    tr = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    system = _system(CIRCUIT[traffic])
    drive = Drive(tr, system, torch.device("cpu"))
    assert tr["generator"] == "circuit" and drive.lens is None
    idx = torch.arange(500)
    t, q = drive.laser_pose(idx)
    t0, q0 = sim.circuit_pose(idx, tr["lap_frames"], tr["radius_m"], tr["height_m"],
                              tr["wobble"], tr["dt_s"])
    assert torch.equal(t, t0) and torch.equal(q, q0)
    ct, cq = drive.cam_pose(idx)
    ct0, cq0 = sim.compose((t0, q0), sim.inverse(sim.rig_T_CL()))
    assert torch.equal(ct, ct0) and torch.equal(cq, cq0)
    tb, qb = drive.laser_pose(idx, torch.bfloat16)
    tb0, qb0 = sim.circuit_pose(idx, tr["lap_frames"], tr["radius_m"], tr["height_m"],
                                tr["wobble"], tr["dt_s"], dtype=torch.bfloat16)
    assert torch.equal(tb, tb0) and torch.equal(qb, qb0)

    assert _equal_frames(drive.make([0, 1, 125, 249], seed=1),
                         _frames(tr, system, [0, 1, 125, 249], 1))
    if tr["history"]:
        h = tr["history"]
        assert _equal_frames(drive.make(range(h["frames"])[:2], h["seed"]),
                             _frames(tr, system, range(2), h["seed"]))

    assert torch.equal(drive.ray_dirs(), sim.camera_ray_dirs(drive.cam))
    assert torch.equal(drive.ray_dirs(dtype=torch.bfloat16),
                       sim.camera_ray_dirs(drive.cam, dtype=torch.bfloat16))
    uv0 = torch.stack(torch.meshgrid(torch.arange(3.0, 160.0, 11.0),
                                     torch.arange(2.0, 96.0, 7.0), indexing="xy"), -1)
    uv0 = uv0.reshape(-1, 2)
    p0, p1 = (ct[10], cq[10]), (ct[11], cq[11])
    uv1, ok = drive.reproject(p0, p1, uv0)
    uv1_s, ok_s = sim.reproject_pixels(drive.scene, p0, p1, drive.cam, uv0)
    assert torch.equal(uv1, uv1_s) and torch.equal(ok, ok_s) and bool(ok.any())


def test_the_simulator_is_the_file_it_was():
    assert hashlib.sha256((BENCH / "traffic" / "sim.py").read_bytes()).hexdigest() == SIM_SHA256
