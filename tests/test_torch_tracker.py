"""The port's feature tracker (`lmono_tpu_torch.estimator.tracker`) against
the JAX package's TPU route (`jax.default_backend` patched to "tpu", the
Pallas LK kernel in interpret mode), on frames the JAX simulator renders
along the circuit, with the same RANSAC noise: the port takes the Gumbel
noise behind `jax.random.categorical`'s draws.

Tolerances:
* teacher-forced over 4 frames (each frame starts from the JAX state,
  converted with `tracker_state_from_numpy`): alive and ids equal on at
  least 97% of slots, uv within 1e-3 px where both are alive;
* a free-running 6-frame tracker: the median frame-to-frame track error
  against the simulator's geometry within 0.05 px of the JAX run's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lmono_tpu.ops.pallas.lk as plk
from lmono_tpu.camera import pinhole_camera as jpinhole
from lmono_tpu.config import synthetic_config
from lmono_tpu.estimator.tracker import TrackerState as JState
from lmono_tpu.estimator.tracker import tracker_step as jstep
from lmono_tpu.io import synthetic as jsyn
from lmono_tpu.utils.lie import Pose as JPose
from lmono_tpu_torch.camera import camera_from_config
from lmono_tpu_torch.config import CameraConfig as TCameraConfig
from lmono_tpu_torch.convert import tracker_state_from_numpy
from lmono_tpu_torch.estimator.tracker import (FeatureTracker, TrackerState,
                                               tracker_step)
from lmono_tpu_torch.io import synthetic as tsyn
from lmono_tpu_torch.utils.lie import Pose as TPose

SLOT_AGREE = 0.97
UV_ATOL_PX = 1e-3
MEDIAN_ATOL_PX = 0.05
CAM = dataclasses.replace(synthetic_config().camera, width=256, height=128,
                          fx=128.0, fy=128.0, cx=128.0, cy=64.0)
TCFG = dataclasses.replace(synthetic_config().tracker, max_features=40,
                           min_dist=16, pyramid_levels=3, lk_patch=15)
TCAM = TCameraConfig(**dataclasses.asdict(CAM))


@functools.lru_cache(maxsize=None)
def _poses(n):
    traj = jsyn.circuit_trajectory(n)
    T_LC = jsyn.synthetic_T_CL().inverse()
    return [JPose(traj.t[i], traj.q[i]).compose(T_LC) for i in range(n)]


@functools.lru_cache(maxsize=None)
def _frames(n):
    scene = jsyn.make_city_scene()
    return [np.asarray(jsyn.render_camera(scene, p, CAM)) for p in _poses(n)]


def _gumbel(seed):
    key = jax.random.PRNGKey(seed)
    g = jax.random.gumbel(key, (TCFG.f_ransac_iters, 8, TCFG.max_features))
    return key, torch.from_numpy(np.asarray(g))


@pytest.fixture
def jax_tpu_route(monkeypatch):
    """The JAX package's TPU route on the CPU: Pallas LK in interpret mode.
    Returns its jitted `tracker_step`."""
    monkeypatch.setattr(plk, "lk_level_pallas",
                        functools.partial(plk.lk_level_pallas, interpret=True))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    cam = jpinhole(CAM.width, CAM.height, CAM.fx, CAM.fy, CAM.cx, CAM.cy)
    return jax.jit(lambda s, img, k: jstep(s, img, cam, TCFG, k))


def test_teacher_forced_steps_match(jax_tpu_route):
    cam = camera_from_config(TCAM)
    s = JState.init(TCFG, CAM.height, CAM.width)
    for i, img in enumerate(_frames(4)):
        key, g = _gumbel(10 + i)
        ts, frame = tracker_state_from_numpy(jax.device_get(s))
        assert frame == i
        s, oj = jax_tpu_route(s, jnp.asarray(img), key)
        ts2, ot = tracker_step(ts, torch.from_numpy(img), cam, TCFG, g, frame)
        aj, at = np.asarray(oj.alive), ot.alive.numpy()
        assert (aj == at).mean() >= SLOT_AGREE, i
        assert (np.asarray(oj.ids) == ot.ids.numpy()).mean() >= SLOT_AGREE, i
        both = aj & at
        assert both.sum() >= 0.5 * TCFG.max_features
        np.testing.assert_allclose(ot.uv.numpy()[both], np.asarray(oj.uv)[both],
                                   rtol=0, atol=UV_ATOL_PX)
        np.testing.assert_allclose(ot.norm.numpy()[both], np.asarray(oj.norm)[both],
                                   rtol=0, atol=UV_ATOL_PX / CAM.fx)
        assert int(ts2.frame) == i + 1
        if i > 0:
            assert (np.asarray(oj.track_cnt) >= 2).sum() >= 10


def _median_error(outs, n):
    """Median error (px) of the tracks carried from frame i-1 to i, against
    where the simulator puts the point seen at frame i-1."""
    scene = tsyn.make_city_scene()
    poses = [TPose(torch.from_numpy(np.asarray(p.t)), torch.from_numpy(np.asarray(p.q)))
             for p in _poses(n)]
    errs = []
    for i in range(1, n):
        uv_prev, (uv, alive, cnt) = outs[i - 1][0], outs[i]
        truth, hit = tsyn.reproject_pixels(scene, poses[i - 1], poses[i], TCAM,
                                           torch.from_numpy(uv_prev))
        m = torch.from_numpy(alive & (cnt >= 2)) & hit
        errs.append(torch.linalg.norm(torch.from_numpy(uv) - truth, dim=-1)[m])
    errs = torch.cat(errs)
    assert errs.numel() >= 50
    return float(errs.median())


def test_free_running_track_error_matches(jax_tpu_route):
    n = 6
    s = JState.init(TCFG, CAM.height, CAM.width)
    tracker = FeatureTracker(camera_from_config(TCAM), TCFG, CAM.height, CAM.width,
                             device="cpu")
    outs_j, outs_t = [], []
    for i, img in enumerate(_frames(n)):
        key, g = _gumbel(20 + i)
        s, oj = jax_tpu_route(s, jnp.asarray(img), key)
        ot = tracker.process(img, g)
        outs_j.append(tuple(np.asarray(x) for x in (oj.uv, oj.alive, oj.track_cnt)))
        outs_t.append(tuple(x.numpy() for x in (ot.uv, ot.alive, ot.track_cnt)))
    med_j, med_t = _median_error(outs_j, n), _median_error(outs_t, n)
    print(f"median track error: jax {med_j:.4f} px, port {med_t:.4f} px")
    assert abs(med_t - med_j) <= MEDIAN_ATOL_PX
    assert med_t < 0.6
    assert tracker.frame == n and int(tracker.state.frame) == n


def test_feature_tracker_runs_from_its_generator():
    cam = camera_from_config(TCAM)
    imgs = _frames(3)

    def run(seed):
        tr = FeatureTracker(cam, TCFG, CAM.height, CAM.width, device="cpu",
                            generator=torch.Generator().manual_seed(seed))
        return [tr.process(img) for img in imgs], tr

    a, tr = run(5)
    b, _ = run(5)
    for x, y in zip(a, b):
        for f in x._fields:
            assert torch.equal(getattr(x, f), getattr(y, f)), f
    first = a[0]
    assert first.uv.shape == (TCFG.max_features, 2) and first.ids.dtype == torch.int32
    # frame 0 only detects: ids 0..k-1 in the first k slots, nothing carried
    k = int(first.alive.sum())
    assert k > 0 and first.ids[:k].tolist() == list(range(k))
    assert (first.track_cnt[first.alive] == 1).all()
    assert not first.velocity.any()
    assert tr.frame == 3 and int(tr.state.next_id) >= k
    assert tr.gumbel().shape == (TCFG.f_ransac_iters, 8, TCFG.max_features)


def test_state_from_numpy_matches_init():
    j = jax.device_get(JState.init(TCFG, CAM.height, CAM.width))
    t, frame = tracker_state_from_numpy(j)
    ref = TrackerState.init(TCFG, CAM.height, CAM.width)
    assert frame == 0
    for f in ("uv", "norm", "ids", "track_cnt", "alive", "next_id", "frame"):
        assert getattr(t, f).dtype == getattr(ref, f).dtype, f
        assert torch.equal(getattr(t, f), getattr(ref, f)), f
    assert [p.shape for p in t.pyramid] == [p.shape for p in ref.pyramid]
    assert [g[0].shape for g in t.grads] == [p.shape for p in ref.pyramid]


def test_runs_on_the_card_unless_asked_for_the_cpu():
    from lmono_tpu_torch import default_device

    cam = camera_from_config(TCAM)
    if torch.cuda.is_available():
        tr = FeatureTracker(cam, TCFG, CAM.height, CAM.width)
        assert tr.device.type == "cuda" and tr.state.uv.is_cuda
        assert default_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FeatureTracker(cam, TCFG, CAM.height, CAM.width)
        with pytest.raises(RuntimeError):
            default_device()
    tr = FeatureTracker(cam, TCFG, CAM.height, CAM.width, device="cpu")
    assert tr.device == torch.device("cpu") and not tr.state.uv.is_cuda
    assert default_device("cpu") == torch.device("cpu")
