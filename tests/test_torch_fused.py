"""The port's fused pipeline (`lmono_tpu_torch.fused`: odometry → KLT
tracker → window fusion) against `lmono_tpu.fused` on the JAX package's
TPU route for the tracker (the backend `lmono_tpu.ops.lk` sees patched to
"tpu", the Pallas LK kernel in interpret mode, as `test_torch_tracker.py`
holds the tracker) and its CPU route for the odometry (exact KNN, as
`test_torch_odometry.py` holds the odometry), on frames the JAX
simulator makes along the circuit (32×512 sweeps with 0.01 m range noise,
256×128 renders through the synthetic rig), at a small width: 512 edge and
1024 planar features against banks of 2048 and 4096 points, 40 tracker
slots, window 4, 48 table rows.  The RANSAC noise is the Gumbel noise
behind the JAX key's draws (`k1` of `jax.random.split(key, 3)` per frame).

Tolerances (the odometry's, ROADMAP Queue 3: its plane fit moves by
millimetres under one-ulp input changes, and the tracker's slots agree on
97%):
* teacher-forced for 12 frames (each frame starts from the JAX state,
  `fused_state_from_numpy`): the odometry's pose within 1 cm and 1e-3 in q,
  and the fused pose within that frame's odometry gap plus the estimator's
  own teacher-forced bound (1 mm, 1e-4; `test_torch_estimator.py`), so at
  most 1.1 cm and 1.1e-3: the window takes the odometry's pose as its
  laser factor, so it inherits the odometry's gap (ROADMAP Queue 3);
* a free-running 16-frame `FusedPipeline` run with the same noise: ATE
  within 5 mm of the JAX run's, and under 0.2 m;
* `process` equal to `process_chunk` (port against port, so on smaller
  LiDAR feature sets, which make the CPU odometry cheaper);
* `system_chunk` (the fused step plus the dense-map merge and the loop
  lane's landmarks, one depth image per frame shared by both) over 8
  frames, each package's `fused_step` replaced by the JAX run's state and
  outputs for that frame, so that the two packages' system stages see the
  same inputs and the odometry's gap above does not enter: `ccam_*` within
  1e-6, landmark selections and LiDAR feature subsets equal, landmark
  points within 1e-5 relative, the map bank's slots, colours and
  `map_fill` equal bit for bit and its points within 1e-5 relative (0.1 mm
  absolute: the back-projection's f32 sums in another order).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lmono_tpu.ops.lk as jlk
import lmono_tpu.ops.pallas.lk as plk
from lmono_tpu import fused as jf
from lmono_tpu.camera import pinhole_camera as jpinhole
from lmono_tpu.config import synthetic_config
from lmono_tpu.io import synthetic as jsyn
from lmono_tpu.mapping.builder import ColorMap as JColorMap
from lmono_tpu.utils.lie import Pose as JPose
from lmono_tpu_torch import fused as tf
from lmono_tpu_torch.camera import camera_from_config
from lmono_tpu_torch.convert import (colormap_from_numpy, config_from_json,
                                     fused_state_from_numpy)
from lmono_tpu_torch.eval.ate import ate_rmse
from lmono_tpu_torch.lidar.features import ScanFeatures
from lmono_tpu_torch.ops import knn as tknn
from lmono_tpu_torch.ops import lk as tlk
from lmono_tpu_torch.utils.lie import Pose as TPose
from torch_estimator_cases import one_torch_thread

T_ATOL_M, Q_ATOL = 1e-2, 1e-3
EST_T_ATOL_M, EST_Q_ATOL = 1e-3, 1e-4
N_FRAMES = 16
N_TEACHER = 12
ATE_ATOL_M = 5e-3
_BASE = synthetic_config()
CFG = _BASE.replace(
    lidar=dataclasses.replace(_BASE.lidar, max_edge_features=512, max_planar_features=1024,
                              map_edge_capacity=2048, map_planar_capacity=4096),
    camera=dataclasses.replace(_BASE.camera, width=256, height=128, fx=128.0,
                               fy=128.0, cx=128.0, cy=64.0),
    tracker=dataclasses.replace(_BASE.tracker, max_features=40, min_dist=16,
                                pyramid_levels=3, lk_patch=15),
    estimator=dataclasses.replace(_BASE.estimator, window_size=4, max_tracks=48))
TCFG = config_from_json(CFG.to_json())


@functools.lru_cache(maxsize=None)
def _frames():
    scene = jsyn.make_city_scene()
    traj = jsyn.circuit_trajectory(N_FRAMES)
    T_LC = jsyn.synthetic_T_CL().inverse()
    sim = jax.jit(lambda p, k: jsyn.simulate_lidar(scene, p, CFG.lidar, noise_std=0.01,
                                                   key=k))
    render = jax.jit(lambda p: jsyn.render_camera(scene, p, CFG.camera))
    frames = []
    for i in range(N_FRAMES):
        p = JPose(traj.t[i], traj.q[i])
        s = sim(p, jax.random.PRNGKey(100 + i))
        frames.append({**{k: np.asarray(s[k]) for k in ("points", "ranges", "valid")},
                       "image": np.asarray(render(p.compose(T_LC)))})
    return frames, np.asarray(traj.t), np.asarray(traj.q)


def _t_cl():
    T = jsyn.synthetic_T_CL()
    return T, TPose(torch.tensor(np.array(T.t)), torch.tensor(np.array(T.q)))


class _TpuView:
    """`jax` as `lmono_tpu.ops.lk` sees it under the fixture: the TPU
    backend, so `track_pyramid` takes the Pallas kernel."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


@pytest.fixture
def jax_tpu_route(monkeypatch):
    monkeypatch.setattr(plk, "lk_level_pallas",
                        functools.partial(plk.lk_level_pallas, interpret=True))
    monkeypatch.setattr(jlk, "jax", _TpuView())
    return _jax_run


@functools.lru_cache(maxsize=None)
def _jax_run():
    """The JAX run: (states before each frame, outputs with the scan's
    LiDAR features, each frame's tracker noise)."""
    c = CFG.camera
    cam = jpinhole(c.width, c.height, c.fx, c.fy, c.cx, c.cy)
    step = jax.jit(lambda s, fr: jf.fused_step(s, fr, cam, CFG, with_features=True))
    state = jf.FusedState.init(CFG, _t_cl()[0])
    states, outs, noise = [], [], []
    frames, _, _ = _frames()
    for fr in frames:
        states.append(jax.device_get(state))
        _, k1, _ = jax.random.split(state.key, 3)
        noise.append(np.asarray(jax.random.gumbel(
            k1, (CFG.tracker.f_ransac_iters, 8, CFG.tracker.max_features))))
        state, out = step(state, {k: jnp.asarray(v) for k, v in fr.items()})
        outs.append(jax.device_get(out))
    return states, outs, noise


def _port_frame(fr):
    return {k: torch.from_numpy(v) for k, v in fr.items()}


def test_teacher_forced_steps_match(jax_tpu_route):
    states, outs, noise = jax_tpu_route()
    frames, _, _ = _frames()
    cam = camera_from_config(TCFG.camera)
    knn0, lk0 = tknn.knn_plain_calls, tlk.lk_plain_calls
    for i in range(N_TEACHER):
        st, n = fused_state_from_numpy(states[i], device="cpu")
        assert n == i
        _, out = tf.fused_step(st, _port_frame(frames[i]), cam, TCFG,
                               torch.from_numpy(noise[i]), n)
        gap = {}
        for k, atol in (("t", T_ATOL_M), ("q", Q_ATOL)):
            gap[k] = np.abs(out["laser_" + k].numpy() - outs[i]["laser_" + k]).max()
            assert gap[k] <= atol, (i, k, gap[k])
        for k, atol in (("t", EST_T_ATOL_M), ("q", EST_Q_ATOL)):
            d = np.abs(out["pose_" + k].numpy() - outs[i]["pose_" + k]).max()
            assert d <= gap[k] + atol, (i, k, d, gap[k])
        assert bool(out["initialized"]) == bool(outs[i]["initialized"]), i
    assert bool(outs[N_TEACHER - 1]["initialized"])
    # the plain versions of K1 and K2 ran on the CPU: 2 KNN calls per outer
    # iteration and one forward-backward track per frame
    n_outer = (TCFG.lidar.scan_to_map_iters + 1) // 2
    assert tknn.knn_plain_calls - knn0 == 2 * n_outer * N_TEACHER
    assert tlk.lk_plain_calls - lk0 >= N_TEACHER


def test_free_running_pipeline_ate_matches(jax_tpu_route):
    _, outs, noise = jax_tpu_route()
    frames, gt_t, gt_q = _frames()
    fp = tf.FusedPipeline(TCFG, camera_from_config(TCFG.camera), _t_cl()[1],
                          device="cpu")
    res = [fp.process(_port_frame(fr), (torch.from_numpy(g), None))
           for fr, g in zip(frames, noise)]
    gt = TPose(torch.from_numpy(gt_t), torch.from_numpy(gt_q))
    est = TPose(torch.stack([r["pose_t"] for r in res]),
                torch.stack([r["pose_q"] for r in res]))
    ref = TPose(torch.from_numpy(np.stack([o["pose_t"] for o in outs])),
                torch.from_numpy(np.stack([o["pose_q"] for o in outs])))
    ate, ate_ref = ate_rmse(est, gt), ate_rmse(ref, gt)
    print(f"fused ATE: jax {ate_ref:.6f} m, port {ate:.6f} m")
    assert abs(ate - ate_ref) <= ATE_ATOL_M
    assert ate < 0.2
    assert fp.frame == N_FRAMES and bool(res[-1]["initialized"])
    assert sum(r["lm_attempts"] for r in res) >= N_FRAMES - TCFG.estimator.window_size
    assert all(r["lm_replayed"] == 0 for r in res)         # the CPU's eager loop


def test_process_matches_process_chunk():
    frames, _, _ = _frames()
    cfg = TCFG.replace(lidar=dataclasses.replace(
        TCFG.lidar, max_edge_features=128, max_planar_features=256))
    cam = camera_from_config(cfg.camera)
    n = 6
    a = tf.FusedPipeline(cfg, cam, _t_cl()[1], device="cpu",
                         generator=torch.Generator().manual_seed(3))
    chunk = a.process_chunk({k: np.stack([f[k] for f in frames[:n]]) for k in frames[0]})
    b = tf.FusedPipeline(cfg, cam, _t_cl()[1], device="cpu",
                         generator=torch.Generator().manual_seed(3))
    for i in range(n):
        out = b.process(frames[i])
        for k, v in out.items():
            if isinstance(v, int):
                assert int(chunk[k][i]) == v, k
            else:
                assert torch.equal(chunk[k][i], v), k
    assert a.frame == b.frame == n
    assert chunk["pose_t"].shape == (n, 3) and chunk["lm_attempts"].shape == (n,)
    assert torch.equal(a.state.est.window.t, b.state.est.window.t)
    assert int(chunk["lm_attempts"].sum()) > 0          # the window solved
    assert int(chunk["lm_replayed"].sum()) == 0          # eagerly, on the CPU


def test_state_from_numpy_matches_init():
    j = jax.device_get(jf.FusedState.init(CFG, _t_cl()[0]))
    t, frame = fused_state_from_numpy(j)
    ref = tf.FusedState.init(TCFG, _t_cl()[1])
    assert frame == 0

    def leaves(nt):
        for x in nt:
            yield from ([x] if isinstance(x, torch.Tensor) else leaves(x))

    for a, b in zip(leaves(t), leaves(ref), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_runs_on_the_card_unless_asked_for_the_cpu():
    cam = camera_from_config(TCFG.camera)
    if torch.cuda.is_available():
        fp = tf.FusedPipeline(TCFG, cam)
        assert fp.device.type == "cuda" and fp.state.est.window.t.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tf.FusedPipeline(TCFG, cam)
    fp = tf.FusedPipeline(TCFG, cam, device="cpu")
    assert fp.device == torch.device("cpu") and not fp.state.odo.pose.t.is_cuda
    g, rp = fp.noise()
    assert g.shape == (TCFG.tracker.f_ransac_iters, 8, 40) and rp is None


SYS_FRAMES = range(4, 12)
SYS_MAP_CAPACITY = 1 << 15


def _corr():
    """A drift correction of decimetres and a few degrees."""
    q = np.array([0.998, 0.02, -0.03, 0.05], np.float32)
    return np.array([0.3, -0.2, 0.05], np.float32), q / np.linalg.norm(q)


@functools.lru_cache(maxsize=None)
def _jax_system_chunk():
    """The JAX package's `system_chunk` over SYS_FRAMES, its `fused_step`
    replaced by the JAX run's state and outputs for each frame."""
    states, outs, _ = _jax_run()
    frames, _, _ = _frames()
    idx = list(SYS_FRAMES)
    stack = lambda *xs: np.stack(xs)  # noqa: E731
    fr = {k: np.stack([frames[i][k] for i in idx]) for k in frames[0]}
    fr["_st"] = jax.tree.map(stack, *[states[i + 1] for i in idx])
    fr["_res"] = jax.tree.map(stack, *[outs[i] for i in idx])
    c = CFG.camera
    cam = jpinhole(c.width, c.height, c.fx, c.fy, c.cx, c.cy)
    real = jf.fused_step
    jf.fused_step = lambda st, frame, *a, **k: (frame["_st"], dict(frame["_res"]))
    try:
        ct, cq = _corr()
        _, cmap, res = jax.jit(lambda s, cm, f: jf.system_chunk(
            s, cm, f, JPose(jnp.asarray(ct), jnp.asarray(cq)), cam, CFG, True, True))(
            states[idx[0]], JColorMap.empty(SYS_MAP_CAPACITY), fr)
    finally:
        jf.fused_step = real
    return jax.device_get(cmap), jax.device_get(res)


def test_system_chunk_teacher_forced_matches(jax_tpu_route, monkeypatch):
    states, outs, _ = jax_tpu_route()
    frames, _, _ = _frames()
    jmap, ref = _jax_system_chunk()
    idx = list(SYS_FRAMES)
    after = {i: fused_state_from_numpy(states[i + 1], device="cpu")[0] for i in idx}

    def forced(state, frame, cam, cfg, gumbel, n, rp=None, with_features=False, mesh=None):
        res = {k: torch.from_numpy(np.asarray(v)) for k, v in outs[n].items()
               if k != "features"}
        res["features"] = ScanFeatures(
            *[torch.from_numpy(np.asarray(v)) for v in outs[n]["features"]])
        return after[n], res

    monkeypatch.setattr(tf, "fused_step", forced)
    ct, cq = _corr()
    st0, _ = fused_state_from_numpy(states[idx[0]], device="cpu")
    fr = {k: torch.from_numpy(np.stack([frames[i][k] for i in idx])) for k in frames[0]}
    _, cmap, res = tf.system_chunk(
        st0, colormap_from_numpy(jax.device_get(JColorMap.empty(SYS_MAP_CAPACITY)), "cpu"),
        fr, TPose(torch.from_numpy(ct), torch.from_numpy(cq)), camera_from_config(TCFG.camera),
        TCFG, True, True, torch.zeros(len(idx), 1), idx[0])
    for k in ("ccam_t", "ccam_q"):
        np.testing.assert_allclose(res[k].numpy(), ref[k], rtol=0, atol=1e-6, err_msg=k)
    for k in ("lm_sel", "lm_pnp", "loop_edge", "loop_edge_mask", "loop_planar",
              "loop_planar_mask"):
        np.testing.assert_array_equal(res[k].numpy(), ref[k], err_msg=k)
    for k in ("lm_pts", "lm_norm", "lm_uv"):
        np.testing.assert_allclose(res[k].numpy(), ref[k], rtol=1e-5, atol=1e-5, err_msg=k)
    for k in ("mask", "colors"):
        np.testing.assert_array_equal(getattr(cmap, k).numpy(), np.asarray(getattr(jmap, k)),
                                      err_msg=k)
    np.testing.assert_allclose(cmap.points.numpy(), jmap.points, rtol=1e-5, atol=1e-4)
    assert int(res["map_fill"]) == int(ref["map_fill"]) == int(cmap.mask.sum()) > 1000
    assert bool(res["lm_pnp"].any()) and bool(res["loop_planar_mask"].any())
