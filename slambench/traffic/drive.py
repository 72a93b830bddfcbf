"""The one generator of the benchmark's traffic: drives through the city.

A traffic mix is a JSON file beside this one (`traffic/<name>.json`) whose
`generator` names the drive; its parameters:

* `generator` "circuit": `lap_frames`, `radius_m`, `height_m`, `wobble`,
  `dt_s` (`sim.circuit_pose`); "figure8": `lap_frames`, `radius_m`,
  `height_m`, `swing_m`, `tilt`, `dt_s` (`figure8.figure8_pose`);
* `scene_seed`: the city scene; `noise_std_m`: the LiDAR range noise;
* `history`: null, or {"frames", "seed"}: a prior drive from frame 0 that
  the system has already run (its state is a checkpoint made once per
  checkout, `harness.history_state`), its noise from its own fixed seed;
* `first_frame`: the drive index of the run's first frame;
* `staged_frames`: frames made at set-up from `--seed` and kept on the
  device; past them the drive replays them in order;
* `warmup_frames`: frames run before the measured window;
* `map_check_frames`, `map_check_span`: the window frames, drawn from the
  seed among the first `map_check_span`, whose map merge `correct` checks;
* `marg_check_calls`, `marg_check_span`: the window's marginalizations,
  drawn from the seed among its first `marg_check_span`, whose prior
  `correct` checks;
* `trace_skip`, `trace_frames`: the window frames a `--trace 1` run
  profiles on the device.

The seed gives the noise of every staged frame and nothing else, so every
seed runs the same poses and sizes.

The camera is the configuration's: a pinhole whose distortion is all zero
takes `sim`'s render and reprojection, and one with radial-tangential
distortion takes `lens`'s; any other model is refused.
"""

from __future__ import annotations

import torch

from slambench.traffic import figure8, lens, sim

GENERATORS = ("circuit", "figure8")


class Drive:
    """Frames and truth of one traffic mix under one configuration.

    system: the configuration's `system` tree (a plain dict)."""

    def __init__(self, traffic: dict, system: dict, device):
        if traffic.get("generator") not in GENERATORS:
            raise ValueError(f"unknown generator {traffic.get('generator')!r}")
        self.p = traffic
        self.device = device
        lid, cam = system["lidar"], system["camera"]
        self.lidar = lid
        self.cam = {k: cam[k] for k in ("width", "height", "fx", "fy", "cx", "cy")}
        self.lens = lens.lens_of(cam)
        self.scene = sim.make_city_scene(seed=traffic["scene_seed"], device=device)
        self.T_CL = sim.rig_T_CL(device)
        self.T_LC = sim.inverse(self.T_CL)
        self.history = (traffic["history"] or {}).get("frames", 0)

    # ------------------------------------------------------------------
    def laser_pose(self, idx, dtype=torch.float32):
        """Truth laser poses of drive indices `idx` (a tensor), computed
        in `dtype` (the control's bfloat16, or float32)."""
        p = self.p
        idx = torch.as_tensor(idx, device=self.device)
        if p["generator"] == "figure8":
            return figure8.figure8_pose(idx, p["lap_frames"], p["radius_m"], p["height_m"],
                                        p["swing_m"], p["tilt"], p["dt_s"], dtype=dtype)
        return sim.circuit_pose(idx, p["lap_frames"], p["radius_m"], p["height_m"],
                                p["wobble"], p["dt_s"], dtype=dtype)

    def cam_pose(self, idx, dtype=torch.float32):
        """Truth world-from-camera poses of drive indices `idx`."""
        t, q = self.laser_pose(idx, dtype)
        T_LC = (self.T_LC[0].to(t.dtype).expand(t.shape),
                self.T_LC[1].to(t.dtype).expand(q.shape))
        return sim.compose((t, q), T_LC)

    def run_index(self, j: int) -> int:
        """Drive index of the run's j-th frame (after any history)."""
        return self.p["first_frame"] + j % self.p["staged_frames"]

    def ray_dirs(self, device=None, dtype=torch.float32):
        """Camera-frame unit rays of the pixel centres (H, W, 3)."""
        if self.lens is None:
            return sim.camera_ray_dirs(self.cam, device, dtype)
        return lens.camera_ray_dirs(self.cam, self.lens, device, dtype)

    def reproject(self, pose_wc0, pose_wc1, uv0, scene=None):
        """Where the scene points seen at pixels uv0 (N, 2) of camera 0
        appear in camera 1: (uv1, ok).  scene: the drive's, unless given
        (the control's bfloat16 copy)."""
        scene = self.scene if scene is None else scene
        if self.lens is None:
            return sim.reproject_pixels(scene, pose_wc0, pose_wc1, self.cam, uv0)
        return lens.reproject_pixels(scene, pose_wc0, pose_wc1, self.cam, self.lens, uv0)

    # ------------------------------------------------------------------
    def make(self, indices, seed: int) -> list:
        """Frames {points, ranges, valid, image} at drive `indices`, the
        range noise drawn in order from `seed` on the device."""
        lid = self.lidar
        g = torch.Generator(device=self.device).manual_seed(int(seed) % (2 ** 63))
        dirs_s = sim.lidar_ray_dirs(lid["num_rings"], lid["horiz_res"],
                                    lid["vertical_fov_deg"], self.device)
        dirs_c = self.ray_dirs(self.device)
        frames = []
        for i in indices:
            lt, lq = self.laser_pose(torch.tensor([i]))
            pose = (lt[0], lq[0])
            noise = torch.randn(dirs_s.shape[:2], generator=g, device=self.device)
            scan = sim.simulate_lidar(self.scene, pose, dirs_s, lid["min_range"],
                                      lid["max_range"], noise, self.p["noise_std_m"])
            img, _ = sim.render_camera(self.scene, sim.compose(pose, self.T_LC), dirs_c)
            frames.append({**scan, "image": img})
        return frames

    def stage(self, seed: int) -> list:
        """The run's staged frames."""
        first = self.p["first_frame"]
        return self.make(range(first, first + self.p["staged_frames"]), seed)

    def history_frames(self) -> list:
        """The prior drive's frames, from its own fixed seed."""
        h = self.p["history"]
        return self.make(range(h["frames"]), h["seed"])
