"""The benchmark's frozen figure-8: a drive that excites all three rotation
axes, so that the hand-eye calibration of a rig that starts from the
identity extrinsic has rotations to solve AX = XB with.

A plain-torch copy of `lmono_tpu_torch/io/synthetic.py:figure8_trajectory`
(a Gerono lemniscate, the sensor's x axis along the road, pitch and roll
swinging with the height) that imports nothing of the port.  Two changes,
as `sim.circuit_pose` makes them to the circuit:

* the speed comes from the lap length, so that one lap is `lap_frames`
  frames exactly, and the height, pitch and roll swing `CYCLES` whole times
  a lap (the port's 1.7, 2.3 and 1.9 per radian of its parameter), so that
  the pose of frame i is the pose of frame i mod `lap_frames`: a staged lap
  replays without a jump;
* its arithmetic's dtype comes from its inputs (the control of `correct`
  runs it in bfloat16).

Quaternions are Hamilton (w, x, y, z); a pose (t, q) maps body to world.
"""

from __future__ import annotations

import math

import torch

from slambench.traffic import sim

CYCLES = 2


def figure8_pose(idx: torch.Tensor, lap_frames: int, radius: float, height: float,
                 swing: float, tilt: float, dt: float = 0.1, dtype=torch.float32):
    """Laser poses of frames `idx` on the figure-8 of half-width `radius`:
    the height `height` ± `swing`, pitch ± `tilt` and roll ± 0.7 `tilt`
    (radians), each `CYCLES` times a lap."""
    t = idx.to(dtype) * dt
    speed = 2.0 * math.pi * radius / (lap_frames * dt)
    s = speed * t / radius
    x = radius * torch.cos(s)
    y = radius * torch.sin(s) * torch.cos(s)
    dx = -radius * torch.sin(s)
    dy = radius * (torch.cos(s) ** 2 - torch.sin(s) ** 2)
    pos = torch.stack([x, y, height + swing * torch.sin(CYCLES * s)], -1)
    yaw = torch.atan2(dy, dx)
    pitch = tilt * torch.sin(CYCLES * s)
    roll = tilt * 0.7 * torch.cos(CYCLES * s)
    zero = torch.zeros_like(yaw)
    q = sim.quat_mul(sim.quat_from_axis_angle(torch.stack([zero, zero, yaw], -1)),
                     sim.quat_mul(sim.quat_from_axis_angle(torch.stack([zero, pitch, zero], -1)),
                                  sim.quat_from_axis_angle(torch.stack([roll, zero, zero], -1))))
    return pos, q
