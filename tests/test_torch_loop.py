"""The port's loop lane (`lmono_tpu_torch.loop.landmarks`, `loop.detector`)
against `lmono_tpu.loop`'s, on the same numpy inputs: keyframes the JAX
simulator makes along the circuit (256×128 renders, 32×512 sweeps with
0.01 m range noise), their Shi–Tomasi corners as window landmarks with
LiDAR depth, and a revisit whose estimate has drifted by decimetres.  The
PnP draws are the Gumbel noise behind the reference's keys (one key per
candidate, split from the keyframe's key).

Tolerances:
* `window_landmarks` (scan and depth-image sources) and
  `subsample_features`: selections equal, points within 1e-5 relative;
* `detect_and_verify`, with and without the LiDAR refinement (which runs
  the port's KNN, K1's plain version here): `found`, `old_seq`,
  `refined` equal, the PnP relative pose within 1 mm and 1e-4 in q; a
  refined one within the registration's own bound, 1 cm and 1e-3 (its
  plane fits are ill-conditioned, ROADMAP Queue 3);
* `LoopDetector.process_keyframe` over a sequence: the same keyframes
  gated, the same results, and the DB's packed descriptors equal.
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
from lmono_tpu.lidar.features import extract_features
from lmono_tpu.loop import detector as jdet
from lmono_tpu.loop import landmarks as jlm
from lmono_tpu.mapping.depth import complete_depth, project_cloud
from lmono_tpu.ops.corners import detect_grid
from lmono_tpu.utils.lie import Pose as JPose
from lmono_tpu_torch.camera import camera_from_config
from lmono_tpu_torch.convert import (config_from_json, keyframe_db_from_numpy,
                                     loop_detector_from_numpy, window_state_from_numpy)
from lmono_tpu_torch.loop import detector as tdet
from lmono_tpu_torch.loop import landmarks as tlm
from lmono_tpu_torch.ops import knn as tknn
from lmono_tpu_torch.utils.lie import Pose as TPose
from torch_estimator_cases import one_torch_thread, window_problem  # noqa: F401

_BASE = synthetic_config()
CFG = _BASE.replace(
    camera=dataclasses.replace(_BASE.camera, width=256, height=128, fx=128.0, fy=128.0,
                               cx=128.0, cy=64.0),
    loop=dataclasses.replace(_BASE.loop, db_capacity=16, max_keypoints=96, window_points=48,
                             pnp_ransac_iters=32, kf_edge_points=128, kf_planar_points=256,
                             search_gap=1, search_time=0.3, min_brief_matches=12,
                             refine_min_inliers=30, skip_time=0.15))
TCFG = config_from_json(CFG.to_json())
KF_FRAMES = (0, 2, 4, 6, 8, 10)
REVISITS = ((2, 0.3), (5, 0.5))       # (circuit frame, drift in metres)
DRIFT_DIR = np.array([1.0, -0.6, 0.15], np.float32) / np.linalg.norm([1.0, -0.6, 0.15])


def _cams():
    c = CFG.camera
    return jpinhole(c.width, c.height, c.fx, c.fy, c.cx, c.cy), camera_from_config(TCFG.camera)


@functools.lru_cache(maxsize=None)
def _keyframe_fn():
    """The jitted keyframe maker: circuit pose, scan key and drift → the
    keyframe's image, window landmarks (corners with LiDAR depth, in a world
    drifted by `drift` metres), the drifted camera pose, and the scan's
    subsampled LiDAR features."""
    jcam, _ = _cams()
    scene = jsyn.make_city_scene()
    T_CL = jsyn.synthetic_T_CL()
    m, lc = CFG.mapping, CFG.loop

    @jax.jit
    def make(t, q, key, drift):
        p = JPose(t, q)
        scan = jsyn.simulate_lidar(scene, p, CFG.lidar, noise_std=0.01, key=key)
        cam_pose = p.compose(T_CL.inverse())
        image = jsyn.render_camera(scene, cam_pose, CFG.camera)
        uv, ok = detect_grid(image, 8, lc.window_points, jnp.zeros((1, 2)),
                             jnp.zeros((1,), bool))
        d, dm = project_cloud(T_CL.apply(scan["points"].reshape(-1, 3)),
                              scan["valid"].reshape(-1), jcam, m.depth_min, m.depth_max)
        d, dm = complete_depth(d, dm, m)
        ui = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32), 0, d.shape[1] - 1)
        vi = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32), 0, d.shape[0] - 1)
        z = d[vi, ui]
        norm = jcam.lift_to_normalized(uv)
        drifted = JPose(cam_pose.t + drift * jnp.asarray(DRIFT_DIR), cam_pose.q)
        pts = drifted.apply(jnp.concatenate([norm, jnp.ones_like(norm[:, :1])], -1)
                            * z[:, None])
        f = extract_features(scan["points"], scan["ranges"], scan["valid"], CFG.lidar)
        le, lem = jlm.subsample_features(f.edge_points, f.edge_mask, lc.kf_edge_points)
        lp, lpm = jlm.subsample_features(f.planar_points, f.planar_mask, lc.kf_planar_points)
        return dict(image=image, win_uv=uv, win_norm=norm, win_pts=pts, win_mask=ok,
                    wpnp=ok & dm[vi, ui], t=drifted.t, q=drifted.q,
                    lidar=(le, lem, lp, lpm))

    return make


@functools.lru_cache(maxsize=None)
def _keyframe(frame: int, seed: int, drift: float = 0.0):
    """The keyframe at circuit frame `frame` (see `_keyframe_fn`)."""
    traj = jsyn.circuit_trajectory(12)
    return jax.device_get(_keyframe_fn()(traj.t[frame], traj.q[frame],
                                         jax.random.PRNGKey(seed), np.float32(drift)))


def _t(x):
    return torch.from_numpy(np.array(x))


def _lidar_pack(kf, port: bool):
    T_CL = jsyn.synthetic_T_CL()
    if port:
        return (*[_t(a) for a in kf["lidar"]],
                TPose(_t(T_CL.t), _t(T_CL.q)), TCFG.lidar)
    return (*kf["lidar"], T_CL, CFG.lidar)


# ---------------------------------------------------------------- landmarks

@functools.lru_cache(maxsize=None)
def _scan_wall():
    """A wall of scan points 8–20 m ahead of the window's newest laser pose
    (sensor frame), so some features take LiDAR depth and some do not."""
    rng = np.random.default_rng(3)
    y, z = np.meshgrid(np.linspace(-10, 10, 96), np.linspace(-2.5, 1.0, 24))
    x = 8.0 + 12.0 * rng.random(y.shape)
    pts = np.stack([x, y, z], -1).astype(np.float32)
    return pts, rng.random(y.shape) < 0.9


@pytest.mark.parametrize("Kw", [24, 64])
@pytest.mark.parametrize("source", ["scan", "depth"])
def test_window_landmarks_match(Kw, source):
    jw, _ = window_problem(seed=4)
    tw = window_state_from_numpy(jax.device_get(jw), "cpu")
    jcam, tcam = _cams()
    pts, valid = _scan_wall()
    m = CFG.mapping
    if source == "scan":
        a = jax.jit(lambda w, p, v: jlm.window_landmarks(w, jcam, m, Kw, scan_points=p,
                                                         scan_valid=v))(
            jw, jnp.asarray(pts), jnp.asarray(valid))
        b = tlm.window_landmarks(tw, tcam, TCFG.mapping, Kw, scan_points=_t(pts),
                                 scan_valid=_t(valid))
    else:
        T_CL = JPose(jw.ex_t, jw.ex_q)
        d, dm = jax.jit(lambda p, v: complete_depth(*project_cloud(
            T_CL.apply(p.reshape(-1, 3)), v.reshape(-1), jcam, m.depth_min, m.depth_max), m))(
            jnp.asarray(pts), jnp.asarray(valid))
        a = jlm.window_landmarks(jw, jcam, m, Kw, depth=d, depth_mask=dm)
        b = tlm.window_landmarks(tw, tcam, TCFG.mapping, Kw, depth=_t(d), depth_mask=_t(dm))
    for f in ("sel", "sel_pnp"):
        np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f)))
    for f in ("pts_w", "norm", "uv"):
        np.testing.assert_allclose(getattr(b, f).numpy(), np.asarray(getattr(a, f)),
                                   rtol=1e-5, atol=1e-5)
    assert 0 < int(b.sel_pnp.sum()) <= min(Kw, 48)


def test_subsample_features_match():
    x = np.random.default_rng(0).random((1000, 3)).astype(np.float32)
    mk = np.arange(1000) % 3 > 0
    for cap in (128, 300, 1000, 2000):
        a = jlm.subsample_features(jnp.asarray(x), jnp.asarray(mk), cap)
        b = tlm.subsample_features(_t(x), _t(mk), cap)
        np.testing.assert_array_equal(b[0].numpy(), np.asarray(a[0]))
        np.testing.assert_array_equal(b[1].numpy(), np.asarray(a[1]))


# ----------------------------------------------------------------- detector

@functools.lru_cache(maxsize=None)
def _reference_run():
    """The reference's LoopDetector over the keyframes and the revisits:
    (each call's result or None, the PnP noise each processed call drew,
    the DB after the keyframes, the detector)."""
    jcam, _ = _cams()
    det = jdet.LoopDetector(CFG.loop, (CFG.camera.height, CFG.camera.width),
                            lidar_cfg=CFG.lidar)
    Kw, iters = CFG.loop.window_points, CFG.loop.pnp_ransac_iters
    calls = [(_keyframe(f, 100 + f), 0.1 * f) for f in KF_FRAMES]
    calls += [(_keyframe(f, 200 + f, drift), 3.0 + 0.5 * n)
              for n, (f, drift) in enumerate(REVISITS)]
    results, noise, db_after_kfs = [], [], None
    for n, (kf, time) in enumerate(calls):
        if n == len(KF_FRAMES):
            db_after_kfs = jax.device_get(det.db)
        key = det._key
        res = det.process_keyframe(
            kf["image"], jcam, kf["win_uv"], kf["win_norm"], kf["win_pts"],
            kf["win_mask"], JPose(kf["t"], kf["q"]), time, win_pnp_mask=kf["wpnp"],
            lidar_features=kf["lidar"], extrinsic=jsyn.synthetic_T_CL(), defer_note=True)
        if res is None:
            noise.append(None)
        else:
            k = jax.random.split(key)[0]
            noise.append(np.stack([np.asarray(jax.random.gumbel(kk, (iters, 6, Kw)))
                                   for kk in jax.random.split(k, tdet.TOP_K)]))
        results.append(None if res is None else jax.device_get(res))
    return calls, results, noise, db_after_kfs, jax.device_get(det.db), det


def _check(res_t, res_j, what):
    for f in ("found", "old_seq", "refined"):
        assert int(getattr(res_t, f)) == int(getattr(res_j, f)), (what, f)
    if bool(res_j.found):
        # a refined pose comes from the LiDAR registration, whose plane fits
        # hold the two packages only to 1 cm / 1e-3 (ROADMAP Queue 3)
        t_tol, q_tol = (1e-2, 1e-3) if bool(res_j.refined) else (1e-3, 1e-4)
        np.testing.assert_allclose(res_t.rel_t.numpy(), res_j.rel_t, rtol=0, atol=t_tol,
                                   err_msg=what)
        np.testing.assert_allclose(res_t.rel_q.numpy(), res_j.rel_q, rtol=0, atol=q_tol,
                                   err_msg=what)


@pytest.mark.parametrize("lidar", [False, True])
def test_detect_and_verify_matches(lidar):
    calls, _, noise, db_kfs, _, _ = _reference_run()
    jcam, tcam = _cams()
    tdb, count = keyframe_db_from_numpy(db_kfs, "cpu")
    det = tdet.LoopDetector(TCFG.loop, (CFG.camera.height, CFG.camera.width), device="cpu")
    for n, (kf, time) in enumerate(calls[len(KF_FRAMES):]):
        key = jax.random.PRNGKey(n)
        # the reference's keypoints and descriptors, for both
        kp_uv, kp_ok, jdesc, jwdesc = jax.jit(det_prep_ref)(kf["image"], kf["win_uv"],
                                                            kf["win_mask"])
        kw = dict(desc=_t(jdesc), kp_mask=_t(kp_ok), win_desc=_t(jwdesc),
                  win_pts=_t(kf["win_pts"]), win_norm=_t(kf["win_norm"]),
                  win_mask=_t(kf["win_mask"]), win_pnp_mask=_t(kf["wpnp"]))
        g = np.stack([np.asarray(jax.random.gumbel(kk, (CFG.loop.pnp_ransac_iters, 6,
                                                        CFG.loop.window_points)))
                      for kk in jax.random.split(key, tdet.TOP_K)])
        ref = _ref_detect(lidar)(db_kfs, jdesc, kp_ok, jwdesc, kf["win_pts"], kf["win_norm"],
                                 kf["win_mask"], kf["t"], kf["q"], kf["wpnp"], *kf["lidar"],
                                 jnp.int32(count), np.float32(time), key)
        calls_before = tknn.knn_plain_calls
        out = tdet.detect_and_verify(
            tdb, det.codebook, TCFG.loop, cur_pose=TPose(_t(kf["t"]), _t(kf["q"])),
            cur_seq=count, cur_time=float(np.float32(time)), gumbel=_t(g),
            lidar=_lidar_pack(kf, True) if lidar else None, **kw)
        ref = jax.device_get(ref)
        assert bool(ref.found), "the revisit closes in the reference"
        _check(out, ref, f"revisit {n}")
        # the refinement's registration: 2 KNN calls per outer iteration
        n_outer = max(1, (CFG.loop.refine_iters + 1) // 2)
        assert tknn.knn_plain_calls - calls_before == (2 * n_outer if lidar else 0)


@functools.lru_cache(maxsize=None)
def _ref_detect(lidar: bool):
    codebook = jdet.make_codebook(CFG.loop.brief_bits, CFG.loop.vocab_dim)

    @jax.jit
    def run(db, d, ok, wd, wp, wn, wm, t, q, pm, le, lem, lp, lpm, seq, time, key):
        return jdet.detect_and_verify(
            db, codebook, CFG.loop, desc=d, kp_mask=ok, win_desc=wd, win_pts=wp,
            win_norm=wn, win_mask=wm, cur_pose=JPose(t, q), cur_seq=seq, cur_time=time,
            key=key, win_pnp_mask=pm,
            lidar=(le, lem, lp, lpm, jsyn.synthetic_T_CL(), CFG.lidar) if lidar else None)

    return run


def det_prep_ref(image, win_uv, win_mask):
    """The reference's keyframe prep (`LoopDetector.__init__.prep`)."""
    H = CFG.camera.height
    lc = CFG.loop
    from lmono_tpu.ops.brief import brief_describe

    kp_uv, kp_ok = detect_grid(image, max(8, H // 24), lc.max_keypoints,
                               jnp.zeros((1, 2)), jnp.zeros((1,), bool))
    return (kp_uv, kp_ok, brief_describe(image, kp_uv, kp_ok),
            brief_describe(image, win_uv, win_mask))


def test_loop_detector_sequence_matches():
    calls, results, noise, _, db_ref, _ = _reference_run()
    _, tcam = _cams()
    det = tdet.LoopDetector(TCFG.loop, (CFG.camera.height, CFG.camera.width),
                            lidar_cfg=TCFG.lidar, device="cpu")
    T_CL = jsyn.synthetic_T_CL()
    for n, ((kf, time), ref, g) in enumerate(zip(calls, results, noise)):
        out = det.process_keyframe(
            _t(kf["image"]), tcam, _t(kf["win_uv"]), _t(kf["win_norm"]), _t(kf["win_pts"]),
            _t(kf["win_mask"]), TPose(_t(kf["t"]), _t(kf["q"])), time,
            win_pnp_mask=_t(kf["wpnp"]), lidar_features=tuple(_t(a) for a in kf["lidar"]),
            extrinsic=TPose(_t(T_CL.t), _t(T_CL.q)), defer_note=True,
            gumbel=None if g is None else _t(g))
        assert (out is None) == (ref is None), n
        if ref is not None:
            _check(out, ref, f"call {n}")
    assert det.count == int(db_ref.count) >= len(KF_FRAMES)
    assert any(bool(r.found) for r in results if r is not None)
    for f in ("desc", "win_desc", "kp_mask", "win_mask", "seq", "valid", "lidar_edge"):
        np.testing.assert_array_equal(getattr(det.db, f).numpy(), np.asarray(getattr(db_ref, f)),
                                      err_msg=f)


def test_loop_detector_state_converts():
    # the reference detector after its sequence: DB, keyframe count and
    # skip gates carried over, so the port goes on where it stopped
    _, _, _, _, db_ref, ref = _reference_run()
    det = tdet.LoopDetector(TCFG.loop, (CFG.camera.height, CFG.camera.width), device="cpu")
    loop_detector_from_numpy(det, ref, "cpu")
    assert det.count == int(db_ref.count) and det._last_time == ref._last_time
    np.testing.assert_array_equal(det._last_pos, np.asarray(ref._last_pos))
    assert det._last_loop_time == ref._last_loop_time and det._last_loop_pos is None
    for f in ("desc", "gdesc", "seq", "valid", "time", "lidar_planar"):
        np.testing.assert_array_equal(getattr(det.db, f).numpy(), np.asarray(getattr(db_ref, f)),
                                      err_msg=f)


def test_loop_detector_runs_on_the_card_unless_asked_for_the_cpu():
    shape = (CFG.camera.height, CFG.camera.width)
    if torch.cuda.is_available():
        assert tdet.LoopDetector(TCFG.loop, shape).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdet.LoopDetector(TCFG.loop, shape)
    assert tdet.LoopDetector(TCFG.loop, shape, device="cpu").device == torch.device("cpu")
