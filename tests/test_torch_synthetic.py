"""The port's LiDAR simulator against `lmono_tpu.io.synthetic`.

* The scene arrays come from the same numpy RandomState: BIT-EQUAL.
* The ray caster, fed the same world-frame rays: ranges within 1e-4 m.
* Whole noise-free sweeps: `valid` agrees on at least 99.9% of rays, and
  ranges agree within 1e-4 m on at least 99% of the rays both call valid
  and within 1 cm on all of them.  The ray directions differ between the
  packages by a few ulps (the `linspace` grids and the rotation's cross
  products round differently), and a ray that grazes a wall or the ground
  turns that into millimetres of range; the 1e-4 m bound of the ray-caster
  test holds once the rays are the same.

The camera half:
* the lattice hash bit-equal, int32 wraparound included; the value noise,
  albedo and colour within 1e-6;
* the per-pixel rays within 1e-6, and rendered images (grey and RGB) within
  1e-4 on at least 99.5% of pixel values: a pixel on a silhouette flips
  between two surfaces, as grazing LiDAR rays do, and the finest texture
  octave turns the rays' few-ulp differences into more than 1e-4 on
  surfaces some 90 m away;
* `reproject_pixels`, the port's ground truth of a track, returns a pixel
  unmoved under the same pose and comes back to it through the reverse
  motion where nothing occludes it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from lmono_tpu.config import synthetic_config
from lmono_tpu.io import synthetic as jsyn
from lmono_tpu.utils.lie import Pose as JPose
from lmono_tpu_torch.config import CameraConfig as TCameraConfig
from lmono_tpu_torch.io import synthetic as tsyn
from lmono_tpu_torch.utils.lie import Pose as TPose

CAM = dataclasses.replace(synthetic_config().camera, width=256, height=128,
                          fx=128.0, fy=128.0, cx=128.0, cy=64.0)
PIXEL_ATOL = 1e-4
PIXEL_SHARE = 0.995
RANGE_ATOL_M = 1e-4
RANGE_SHARE = 0.99
GRAZING_ATOL_M = 1e-2
VALID_AGREE = 0.999


def test_scene_bit_equal():
    js, ts = jsyn.make_city_scene(), tsyn.make_city_scene()
    for name in jsyn.Scene._fields:
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(ts, name).numpy(), err_msg=name)


def test_trajectory_and_rig_match():
    jt, tt = jsyn.circuit_trajectory(50), tsyn.circuit_trajectory(50)
    np.testing.assert_allclose(np.asarray(jt.t), tt.t.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jt.q), tt.q.numpy(), rtol=0, atol=1e-6)
    jr, tr = jsyn.synthetic_T_CL(), tsyn.synthetic_T_CL()
    np.testing.assert_allclose(np.asarray(jr.q), tr.q.numpy(), atol=1e-7)
    np.testing.assert_array_equal(np.asarray(jr.t), tr.t.numpy())


def test_ray_dirs_match():
    cfg = synthetic_config().lidar
    np.testing.assert_allclose(np.asarray(jsyn.lidar_ray_dirs(cfg)),
                               tsyn.lidar_ray_dirs(cfg).numpy(), rtol=0, atol=1e-6)


def test_noise_free_sweeps_match():
    cfg = dataclasses.replace(synthetic_config().lidar, num_rings=16,
                              horiz_res=256)
    jscene, tscene = jsyn.make_city_scene(), tsyn.make_city_scene()
    traj = jsyn.circuit_trajectory(30)
    n_rays = agree = 0
    for i in (0, 11, 29):
        t, q = np.array(traj.t[i]), np.array(traj.q[i])
        j = jsyn.simulate_lidar(jscene, JPose(jnp.asarray(t), jnp.asarray(q)), cfg,
                                noise_std=0.0)
        s = tsyn.simulate_lidar(tscene, TPose(torch.from_numpy(t), torch.from_numpy(q)),
                                cfg, noise_std=0.0)
        jv, tv = np.asarray(j["valid"]), s["valid"].numpy()
        both = jv & tv
        diff = np.abs(np.asarray(j["ranges"]) - s["ranges"].numpy())[both]
        assert diff.max() < GRAZING_ATOL_M
        assert (diff < RANGE_ATOL_M).mean() >= RANGE_SHARE
        n_rays += jv.size
        agree += int((jv == tv).sum())
        assert both.sum() > 0.5 * jv.size
    assert agree >= VALID_AGREE * n_rays


def test_ray_cast_matches_on_the_same_rays():
    cfg = dataclasses.replace(synthetic_config().lidar, num_rings=16,
                              horiz_res=256)
    jscene, tscene = jsyn.make_city_scene(), tsyn.make_city_scene()
    traj = jsyn.circuit_trajectory(30)
    dirs = jsyn.lidar_ray_dirs(cfg)
    for i in (0, 11, 29):
        d = np.array(jsyn.quat_rotate(traj.q[i][None, None, :], dirs))
        o = np.ascontiguousarray(np.broadcast_to(np.asarray(traj.t[i]), d.shape))
        rj = np.asarray(jsyn.ray_cast(jscene, jnp.asarray(o), jnp.asarray(d)))
        rt = tsyn.ray_cast(tscene, torch.from_numpy(o), torch.from_numpy(d)).numpy()
        hit = rj < 1e8
        np.testing.assert_array_equal(hit, rt < 1e8)
        np.testing.assert_allclose(rj[hit], rt[hit], rtol=0, atol=RANGE_ATOL_M)


def test_noise_from_generator_or_tensor():
    cfg = dataclasses.replace(synthetic_config().lidar, num_rings=8, horiz_res=64)
    scene = tsyn.make_city_scene()
    traj = tsyn.circuit_trajectory(2)
    pose = TPose(traj.t[1], traj.q[1])
    clean = tsyn.simulate_lidar(scene, pose, cfg, noise_std=0.0)
    a = tsyn.simulate_lidar(scene, pose, cfg, 0.01,
                            generator=torch.Generator().manual_seed(3))
    b = tsyn.simulate_lidar(scene, pose, cfg, 0.01,
                            generator=torch.Generator().manual_seed(3))
    assert torch.equal(a["ranges"], b["ranges"])
    noise = torch.randn(8, 64, generator=torch.Generator().manual_seed(3))
    c = tsyn.simulate_lidar(scene, pose, cfg, 0.01, noise=noise)
    assert torch.equal(a["ranges"], c["ranges"])
    both = clean["valid"] & a["valid"]
    diff = (a["ranges"] - clean["ranges"])[both]
    assert 0.005 < float(diff.std()) < 0.02


def test_hash_and_texture_match():
    rng = np.random.default_rng(11)
    ijk = rng.integers(-2 ** 31, 2 ** 31, size=(3, 4000)).astype(np.int32)
    ijk[:, :3] = [[2 ** 31 - 1, -2 ** 31, -1], [-2 ** 31, 2 ** 31 - 1, 0],
                  [2 ** 31 - 1, 2 ** 31 - 1, -2 ** 31]]
    np.testing.assert_array_equal(
        tsyn._hash3(*(torch.from_numpy(x) for x in ijk)).numpy(),
        np.asarray(jsyn._hash3(*(jnp.asarray(x) for x in ijk))))
    p = (rng.normal(size=(4000, 3)) * 60.0).astype(np.float32)
    for fn in ("value_noise3", "world_intensity", "world_color"):
        np.testing.assert_allclose(getattr(tsyn, fn)(torch.from_numpy(p)).numpy(),
                                   np.asarray(getattr(jsyn, fn)(jnp.asarray(p))),
                                   rtol=0, atol=1e-6, err_msg=fn)


def _camera_pose(i, n=30):
    traj = jsyn.circuit_trajectory(n)
    jp = JPose(traj.t[i], traj.q[i]).compose(jsyn.synthetic_T_CL().inverse())
    return jp, TPose(torch.from_numpy(np.asarray(jp.t)), torch.from_numpy(np.asarray(jp.q)))


def test_rendered_images_match():
    tcam = TCameraConfig(**dataclasses.asdict(CAM))
    np.testing.assert_allclose(tsyn.camera_ray_dirs(tcam).numpy(),
                               np.asarray(jsyn.camera_ray_dirs(CAM)), rtol=0, atol=1e-6)
    jscene, tscene = jsyn.make_city_scene(), tsyn.make_city_scene()
    for i, rgb in ((0, False), (13, False), (29, True)):
        jp, tp = _camera_pose(i)
        a = np.asarray(jsyn.render_camera(jscene, jp, CAM, rgb=rgb))
        b = tsyn.render_camera(tscene, tp, tcam, rgb=rgb).numpy()
        assert a.shape == b.shape == ((128, 256, 3) if rgb else (128, 256))
        # per value: a grey pixel, or one channel of an RGB one
        share = float((np.abs(a - b) <= PIXEL_ATOL).mean())
        assert share >= PIXEL_SHARE, (i, rgb, share)


def test_reprojected_pixels_are_consistent():
    tcam = TCameraConfig(**dataclasses.asdict(CAM))
    scene = tsyn.make_city_scene()
    _, p0 = _camera_pose(10)
    _, p1 = _camera_pose(11)
    rng = np.random.default_rng(12)
    uv0 = torch.from_numpy((rng.random((400, 2)) * [255, 127]).astype(np.float32))
    same, hit = tsyn.reproject_pixels(scene, p0, p0, tcam, uv0)
    assert hit.float().mean() > 0.5
    torch.testing.assert_close(same[hit], uv0[hit], rtol=0, atol=1e-3)
    uv1, hit1 = tsyn.reproject_pixels(scene, p0, p1, tcam, uv0)
    moved = (uv1 - uv0).norm(dim=-1)[hit1]
    assert 0.1 < float(moved.median()) < 30.0
    back, hit2 = tsyn.reproject_pixels(scene, p1, p0, tcam, uv1)
    ok = hit1 & hit2
    err = (back - uv0).norm(dim=-1)[ok]
    assert float((err < 1e-2).float().mean()) >= 0.95
