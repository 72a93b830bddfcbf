"""The port's dense-map slice (`lmono_tpu_torch.ops.image`'s morphology,
`mapping.depth`, `mapping.builder`) against `lmono_tpu`'s, on the same numpy
inputs: a 32×512 sweep with 0.01 m range noise and a 256×128 render of the
JAX simulator's city, seen through the synthetic rig.

Tolerances:
* the 5-tap blur within 1e-5 abs (sums in another order); dilations,
  erosion and the 3×3 median exact (max, min and sort of the same values);
* `project_cloud` depth and mask equal, except at pixels a point reaches
  within 1e-5 px of a .5 rounding edge (both packages round half to even,
  but `space_to_plane` sums in another order);
* `complete_depth` on the same sparse input: masks agree on ≥ 99.9% of
  pixels and depths within 1e-4 m where they agree (the blurs and the
  `|blur − inv| < 2` guard follow f32 rounding);
* `backproject_colored` points within 1e-5 relative, colours and masks
  equal;
* `colormap_update_hash` and the sort merge: slots, points, colours and
  mask equal bit for bit on the same inputs; `MapBuilder`'s flushes and
  PLY counts equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmono_tpu.camera import pinhole_camera as jpinhole
from lmono_tpu.config import synthetic_config
from lmono_tpu.io import synthetic as jsyn
from lmono_tpu.mapping import builder as jb
from lmono_tpu.mapping import depth as jd
from lmono_tpu.ops import image as jim
from lmono_tpu.utils.lie import Pose as JPose
from lmono_tpu_torch.camera import camera_from_config
from lmono_tpu_torch.convert import colormap_from_numpy, config_from_json
from lmono_tpu_torch.mapping import builder as tb
from lmono_tpu_torch.mapping import depth as td
from lmono_tpu_torch.ops import image as tim
from lmono_tpu_torch.utils.lie import Pose as TPose

_BASE = synthetic_config()
CFG = _BASE.replace(camera=dataclasses.replace(
    _BASE.camera, width=256, height=128, fx=128.0, fy=128.0, cx=128.0, cy=64.0))
TCFG = config_from_json(CFG.to_json())
ROUND_EDGE_PX = 1e-5


@functools.lru_cache(maxsize=None)
def _frames(n=3):
    """n sweeps and renders along the circuit, the sweeps in the camera
    frame, and the camera poses (world-from-camera)."""
    scene = jsyn.make_city_scene()
    traj = jsyn.circuit_trajectory(n)
    T_CL = jsyn.synthetic_T_CL()
    sim = jax.jit(lambda p, k: jsyn.simulate_lidar(scene, p, CFG.lidar, noise_std=0.01,
                                                   key=k))
    render = jax.jit(lambda p: jsyn.render_camera(scene, p, CFG.camera))
    out = []
    for i in range(n):
        p = JPose(traj.t[i], traj.q[i])
        s = sim(p, jax.random.PRNGKey(10 + i))
        cam_pose = p.compose(T_CL.inverse())
        out.append({
            "pts_cam": np.array(T_CL.apply(s["points"].reshape(-1, 3))),
            "valid": np.array(s["valid"].reshape(-1)),
            "image": np.array(render(cam_pose)),
            "cam_t": np.asarray(cam_pose.t), "cam_q": np.asarray(cam_pose.q)})
    return out


def _cams():
    c = CFG.camera
    return jpinhole(c.width, c.height, c.fx, c.fy, c.cx, c.cy), camera_from_config(TCFG.camera)


def _sparse(fr):
    jcam, _ = _cams()
    m = CFG.mapping
    d, k = jd.project_cloud(jnp.asarray(fr["pts_cam"]), jnp.asarray(fr["valid"]),
                            jcam, m.depth_min, m.depth_max)
    return np.array(d), np.array(k)


def test_morphology_matches():
    rng = np.random.default_rng(0)
    img = rng.random((40, 56)).astype(np.float32)
    valid = rng.random((40, 56)) < 0.3
    ji, ti = jnp.asarray(img), torch.from_numpy(img)
    np.testing.assert_allclose(tim.gauss_blur5(ti).numpy(),
                               np.asarray(jim.gauss_blur5(ji)), rtol=0, atol=1e-5)
    for k in (3, 5):
        np.testing.assert_array_equal(tim.dilate(ti, k).numpy(), np.asarray(jim.dilate(ji, k)))
        np.testing.assert_array_equal(tim.erode(ti, k).numpy(), np.asarray(jim.erode(ji, k)))
    np.testing.assert_array_equal(tim.median_blur_approx(ti, 3).numpy(),
                                  np.asarray(jim.median_blur_approx(ji, 3)))
    for kind in ("cross", "diamond", "full", None):
        kern = None if kind is None else jd.kernel_shape(kind, 7)
        a, am = jax.jit(lambda i, v: jim.dilate_masked(i, v, 7, kern))(ji, jnp.asarray(valid))
        b, bm = tim.dilate_masked(ti, torch.from_numpy(valid), 7,
                                  None if kind is None else td.kernel_shape(kind, 7))
        np.testing.assert_array_equal(bm.numpy(), np.asarray(am))
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _round_edge_pixels(fr) -> np.ndarray:
    """Pixels that a valid point reaches from within ROUND_EDGE_PX of a .5
    rounding edge in u or v (it could land on either side)."""
    jcam, _ = _cams()
    uv = np.asarray(jcam.space_to_plane(jnp.asarray(fr["pts_cam"]))).astype(np.float64)
    H, W = CFG.camera.height, CFG.camera.width
    near = (np.abs(np.abs(uv - np.floor(uv)) - 0.5) < ROUND_EDGE_PX).any(-1) & fr["valid"]
    edge = np.zeros((H, W), bool)
    for u, v in uv[near]:
        for uu in (np.floor(u), np.ceil(u)):
            for vv in (np.floor(v), np.ceil(v)):
                if 0 <= uu < W and 0 <= vv < H:
                    edge[int(vv), int(uu)] = True
    return edge


def test_project_cloud_matches():
    _, tcam = _cams()
    m = CFG.mapping
    for fr in _frames():
        jdep, jm = _sparse(fr)
        tdep, tm = td.project_cloud(torch.from_numpy(fr["pts_cam"]),
                                    torch.from_numpy(fr["valid"]), tcam,
                                    m.depth_min, m.depth_max)
        keep = ~_round_edge_pixels(fr)
        assert jm.sum() > 1000
        np.testing.assert_array_equal(tm.numpy()[keep], jm[keep])
        np.testing.assert_array_equal(tdep.numpy()[keep], jdep[keep])


@pytest.mark.parametrize("kernel_type,blur_type", [
    ("cross", "bilateral"), ("diamond", "gaussian"), ("full", "bilateral")])
def test_complete_depth_matches(kernel_type, blur_type):
    mc = dataclasses.replace(CFG.mapping, kernel_type=kernel_type, blur_type=blur_type)
    tmc = dataclasses.replace(TCFG.mapping, kernel_type=kernel_type, blur_type=blur_type)
    dep, msk = _sparse(_frames()[0])
    jdep, jm = (np.asarray(x) for x in jax.jit(
        lambda d, m: jd.complete_depth(d, m, mc))(jnp.asarray(dep), jnp.asarray(msk)))
    tdep, tm = td.complete_depth(torch.from_numpy(dep), torch.from_numpy(msk), tmc)
    tdep, tm = tdep.numpy(), tm.numpy()
    assert jm.mean() > 0.3
    assert (tm == jm).mean() >= 0.999
    both = tm & jm
    np.testing.assert_allclose(tdep[both], jdep[both], rtol=0, atol=1e-4)


def test_backproject_colored_matches():
    jcam, tcam = _cams()
    fr = _frames()[1]
    dep, msk = _sparse(fr)
    jdep, jm = jax.jit(lambda d, m: jd.complete_depth(d, m, CFG.mapping))(
        jnp.asarray(dep), jnp.asarray(msk))
    a = [np.asarray(x) for x in jd.backproject_colored(jdep, jm, jnp.asarray(fr["image"]),
                                                       jcam, CFG.mapping)]
    b = [x.numpy() for x in td.backproject_colored(
        torch.from_numpy(np.asarray(jdep)), torch.from_numpy(np.asarray(jm)),
        torch.from_numpy(fr["image"]), tcam, TCFG.mapping)]
    np.testing.assert_array_equal(b[2], a[2])
    np.testing.assert_array_equal(b[1], a[1])
    ok = a[2]
    assert ok.sum() > 1000
    np.testing.assert_allclose(b[0][ok], a[0][ok], rtol=1e-5, atol=1e-6)


def _merge_inputs(seed, n=3000):
    """A bank already half full and n new points, many in its voxels and
    many sharing voxels among themselves, at world scale."""
    rng = np.random.default_rng(seed)
    pts = (rng.random((n, 3)) * [40, 40, 4] + [100, -20, 0]).astype(np.float32)
    pts[n // 2:] = pts[: n - n // 2] + rng.normal(0, 0.03, (n - n // 2, 3)).astype(np.float32)
    cols = rng.random((n, 3)).astype(np.float32)
    mask = rng.random(n) < 0.9
    return pts, cols, mask


@pytest.mark.parametrize("capacity", [1024, 8192])
def test_colormap_update_hash_matches_bit_for_bit(capacity):
    pts, cols, mask = _merge_inputs(capacity)
    jm = jb.ColorMap.empty(capacity)
    tm = tb.ColorMap.empty(capacity)
    for lo, hi in ((0, 1500), (1500, 3000)):      # into an empty, then a filled bank
        jm = jb.colormap_update_hash(jm, jnp.asarray(pts[lo:hi]), jnp.asarray(cols[lo:hi]),
                                     jnp.asarray(mask[lo:hi]), 0.2)
        tm = tb.colormap_update_hash(tm, torch.from_numpy(pts[lo:hi]),
                                     torch.from_numpy(cols[lo:hi]),
                                     torch.from_numpy(mask[lo:hi]), 0.2)
        for f in ("points", "colors", "mask"):
            np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)))
    assert 0 < int(tm.mask.sum()) < capacity


def test_colormap_sort_merge_matches_bit_for_bit():
    pts, cols, mask = _merge_inputs(5, n=2000)
    center = np.array([110.0, -10.0, 1.0], np.float32)
    jm, tm = jb.ColorMap.empty(1500), tb.ColorMap.empty(1500)
    for lo, hi in ((0, 1000), (1000, 2000)):
        jm = jb.colormap_update(jm, jnp.asarray(pts[lo:hi]), jnp.asarray(cols[lo:hi]),
                                jnp.asarray(mask[lo:hi]), 0.2, jnp.asarray(center))
        tm = tb.colormap_update(tm, torch.from_numpy(pts[lo:hi]), torch.from_numpy(cols[lo:hi]),
                                torch.from_numpy(mask[lo:hi]), 0.2, torch.from_numpy(center))
        for f in ("points", "colors", "mask"):
            np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)))


def test_build_frame_matches():
    jcam, tcam = _cams()
    fr = _frames()[2]
    T_CL = jsyn.synthetic_T_CL()
    pts_l = np.asarray(T_CL.inverse().apply(jnp.asarray(fr["pts_cam"])))
    T_WC = JPose(jnp.asarray(fr["cam_t"]), jnp.asarray(fr["cam_q"]))
    a = [np.asarray(x) for x in jax.jit(lambda p, v, im: jb.build_frame(
        p, v, im, T_CL, T_WC, jcam, CFG.mapping))(jnp.asarray(pts_l), jnp.asarray(fr["valid"]),
                                                  jnp.asarray(fr["image"]))]
    tp = lambda p: TPose(torch.from_numpy(np.asarray(p.t)), torch.from_numpy(np.asarray(p.q)))
    b = [x.numpy() for x in tb.build_frame(torch.from_numpy(pts_l), torch.from_numpy(fr["valid"]),
                                           torch.from_numpy(fr["image"]), tp(T_CL), tp(T_WC),
                                           tcam, TCFG.mapping)]
    both = a[2] & b[2]
    assert (a[2] == b[2]).mean() >= 0.999 and both.sum() > 1000
    np.testing.assert_allclose(b[0][both], a[0][both], rtol=1e-5, atol=1e-4)


def test_map_builder_absorb_flush_and_ply_match(tmp_path):
    """The same chunk banks absorbed by both builders: the same flushes
    (occupancy mode and every-N-frames mode) and PLY counts."""
    jcam, tcam = _cams()
    for flush_every in (0, 3):
        mc = dataclasses.replace(CFG.mapping, map_capacity=1024, flush_every=flush_every)
        jmb = jb.MapBuilder(jcam, mc)
        tmb = tb.MapBuilder(tcam, dataclasses.replace(TCFG.mapping, map_capacity=1024,
                                                      flush_every=flush_every), device="cpu")
        cm = jb.ColorMap.empty(1024)
        for c in range(4):
            pts, cols, mask = _merge_inputs(20 + c, n=1200)
            cm = jb.colormap_update_hash(cm, jnp.asarray(pts), jnp.asarray(cols),
                                         jnp.asarray(mask), 0.2)
            jmb.absorb_chunk(cm, 2)
            tmb.absorb_chunk(colormap_from_numpy(jax.device_get(cm), "cpu"), 2)
            n = int(jnp.sum(jmb.map.mask))
            jmb.flush_if_full(n)
            tmb.flush_if_full(n)
            assert tmb._archived_n == jmb._archived_n
            assert int(tmb.map.mask.sum()) == int(jnp.sum(jmb.map.mask))
            cm = jmb.map
        assert jmb._archived_n > 0
        assert (tmb.save_ply(str(tmp_path / "t.ply"))
                == jmb.save_ply(str(tmp_path / "j.ply")) == tmb.n_points)
        assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_map_builder_process_runs_on_the_cpu():
    _, tcam = _cams()
    T_CL = jsyn.synthetic_T_CL()
    tp = lambda p: TPose(torch.from_numpy(np.asarray(p.t)), torch.from_numpy(np.asarray(p.q)))
    mb = tb.MapBuilder(tcam, TCFG.mapping, device="cpu")
    for fr in _frames():
        pts_l = np.asarray(T_CL.inverse().apply(jnp.asarray(fr["pts_cam"])))
        out = mb.process(torch.from_numpy(pts_l), torch.from_numpy(fr["valid"]),
                         torch.from_numpy(fr["image"]), tp(T_CL),
                         TPose(torch.from_numpy(fr["cam_t"]), torch.from_numpy(fr["cam_q"])))
        assert out["depth"].shape == (CFG.camera.height, CFG.camera.width)
    assert 1000 < int(out["n_points"]) == mb.n_points


def test_map_builder_runs_on_the_card_unless_asked_for_the_cpu():
    _, tcam = _cams()
    if torch.cuda.is_available():
        assert tb.MapBuilder(tcam, TCFG.mapping).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tb.MapBuilder(tcam, TCFG.mapping)
    assert tb.MapBuilder(tcam, TCFG.mapping, device="cpu").device == torch.device("cpu")
