"""Stereo of the port (`lmono_tpu_torch.estimator.stereo`) against the JAX
package's (`lmono_tpu.estimator.stereo`), on the same numpy inputs:

* the disparity→3D round trip of `StereoModel`, within 1e-5 relative;
* `stereo_match` on a rectified pair rendered at 512×256 (the synthetic
  camera; the right camera shifted 0.54 m along the camera's +x, as
  `tests/test_stereo.py` renders it), with the same detected corners:
  disparities within 0.1 px where both are ok, ok equal on every slot, and
  the port's depths within the reference test's 8% median of the ray-cast
  truth.  The JAX side runs its TPU route (`jax.default_backend` patched to
  "tpu", `lk_level_pallas` in interpret mode), which the port's LK holds
  (`tests/test_torch_lk.py`).

The `gpu` test holds the one-way K2 launch (`ops.lk.track_pyramid` on CUDA
tensors) to `track_pyramid_plain` on the card: one launch, no plain call,
ok equal and points within 1e-3 px where both are ok.  It runs on a host
without JAX:
    python -m pytest tests/test_torch_stereo.py -m gpu --noconftest
"""

import functools

import numpy as np
import pytest
import torch

from lmono_tpu_torch.config import synthetic_config
from lmono_tpu_torch.estimator.stereo import StereoModel, stereo_match
from lmono_tpu_torch.io import synthetic as syn
from lmono_tpu_torch.ops import lk as tlk
from lmono_tpu_torch.ops.corners import detect_grid
from lmono_tpu_torch.ops.image import build_pyramid, scharr_gradients
from lmono_tpu_torch.utils.lie import Pose, quat_rotate

BASELINE = 0.54
DISP_ATOL_PX = 0.1
LEVELS = 3


def test_disparity_to_3d_roundtrip():
    from lmono_tpu.estimator.stereo import StereoModel as JStereo

    sm = StereoModel(fx=256.0, fy=256.0, cx=256.0, cy=128.0, baseline=BASELINE)
    P = np.array([[1.0, 0.5, 10.0], [-2.0, 1.0, 25.0], [0.3, -0.7, 80.0]],
                 np.float32)
    uv = np.stack([sm.fx * P[:, 0] / P[:, 2] + sm.cx,
                   sm.fy * P[:, 1] / P[:, 2] + sm.cy], -1).astype(np.float32)
    disp = (sm.fx * sm.baseline / P[:, 2]).astype(np.float32)
    P2 = sm.disparity_to_3d(torch.from_numpy(uv), torch.from_numpy(disp))
    ref = JStereo(*sm).disparity_to_3d(uv, disp)
    np.testing.assert_allclose(P2.numpy(), np.asarray(ref), rtol=1e-5)
    np.testing.assert_allclose(P2.numpy(), P, rtol=1e-5)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port on one torch thread, as the other parity files run it under
    parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _pair():
    """(img_l, img_r, uv, ok, z_true) as numpy: a rectified pair of the city
    at the synthetic camera, the left camera's corners and their ray-cast
    depths."""
    cc = synthetic_config().camera
    scene = syn.make_city_scene()
    traj = syn.circuit_trajectory(2)
    pose_l = Pose(traj.t[0], traj.q[0]).compose(syn.synthetic_T_CL().inverse())
    offset = quat_rotate(pose_l.q, torch.tensor([BASELINE, 0.0, 0.0]))
    pose_r = Pose(pose_l.t + offset, pose_l.q)
    img_l = syn.render_camera(scene, pose_l, cc)
    img_r = syn.render_camera(scene, pose_r, cc)
    uv, ok = detect_grid(img_l, 16, 64, torch.zeros((1, 2)),
                         torch.zeros(1, dtype=torch.bool))
    rays = torch.cat([(uv[:, :1] - cc.cx) / cc.fx, (uv[:, 1:] - cc.cy) / cc.fy,
                      torch.ones_like(uv[:, :1])], -1)
    rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
    rays_w = quat_rotate(pose_l.q[None], rays)
    t_hit = syn.ray_cast(scene, pose_l.t.expand(rays_w.shape), rays_w)
    return tuple(x.numpy() for x in (img_l, img_r, uv, ok, t_hit * rays[:, 2]))


@functools.lru_cache(maxsize=None)
def _jax_match():
    """The JAX package's `stereo_match` on the TPU route (see the module
    docstring), as numpy (disparity, ok)."""
    import jax
    import jax.numpy as jnp

    import lmono_tpu.ops.pallas.lk as plk
    from lmono_tpu.estimator.stereo import stereo_match as jmatch
    from lmono_tpu.ops.image import build_pyramid as jpyr
    from lmono_tpu.ops.image import scharr_gradients as jgrad

    img_l, img_r, uv, ok, _ = _pair()
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(plk, "lk_level_pallas",
                   functools.partial(plk.lk_level_pallas, interpret=True))
        mp.setattr(jax, "default_backend", lambda: "tpu")
        pyr = jpyr(jnp.asarray(img_l), LEVELS)
        disp, dok = jmatch(pyr, [jgrad(p) for p in pyr], jnp.asarray(img_r),
                           jnp.asarray(uv), jnp.asarray(ok))
    finally:
        mp.undo()
    return np.asarray(disp), np.asarray(dok)


def test_stereo_match_matches_the_reference():
    img_l, img_r, uv, ok, z_true = _pair()
    pyr = build_pyramid(torch.from_numpy(img_l), LEVELS)
    calls = tlk.lk_plain_calls
    disp, dok = stereo_match(pyr, [scharr_gradients(p) for p in pyr],
                             torch.from_numpy(img_r), torch.from_numpy(uv),
                             torch.from_numpy(ok))
    # on CPU tensors: the plain chain, one level at a time
    assert tlk.lk_plain_calls == calls + LEVELS
    disp, dok = disp.numpy(), dok.numpy()
    d_ref, ok_ref = _jax_match()
    assert ok_ref.sum() > 15
    np.testing.assert_array_equal(dok, ok_ref)
    np.testing.assert_allclose(disp[dok], d_ref[dok], rtol=0, atol=DISP_ATOL_PX)

    # the port's depths against the exact ray-cast ranges (tests/test_stereo.py)
    cc = synthetic_config().camera
    sm = StereoModel(cc.fx, cc.fy, cc.cx, cc.cy, BASELINE)
    z_est = sm.disparity_to_depth(torch.from_numpy(disp)).numpy()[dok]
    rel = np.abs(z_est - z_true[dok]) / np.maximum(z_true[dok], 1.0)
    good = z_true[dok] < 40.0
    assert good.sum() > 5
    assert np.median(rel[good]) < 0.08, np.median(rel[good])


def test_stereo_match_skips_the_right_gradients(monkeypatch):
    # the one-way track reads the left image's gradients only
    import lmono_tpu_torch.estimator.stereo as st

    img_l, img_r, uv, ok, _ = _pair()
    pyr = build_pyramid(torch.from_numpy(img_l), LEVELS)
    grads = [scharr_gradients(p) for p in pyr]
    seen = []
    monkeypatch.setattr(st, "track_pyramid",
                        lambda *a: seen.append(len(a)) or tlk.track_pyramid(*a))
    stereo_match(pyr, grads, torch.from_numpy(img_r), torch.from_numpy(uv),
                 torch.from_numpy(ok))
    assert seen == [8]


@pytest.mark.gpu
def test_one_way_launch_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lmono_tpu_torch.ops.cuda import lk as ck

    dev = torch.device("cuda")
    img_l, img_r, uv, ok, _ = _pair()
    pyr0 = build_pyramid(torch.from_numpy(img_l).to(dev), LEVELS)
    grads0 = [scharr_gradients(p) for p in pyr0]
    pyr1 = build_pyramid(torch.from_numpy(img_r).to(dev), LEVELS)
    pts, mask = torch.from_numpy(uv).to(dev), torch.from_numpy(ok).to(dev)
    before, calls = ck.lk_kernel_launches, tlk.lk_plain_calls
    p, okk = tlk.track_pyramid(pyr0, grads0, pyr1, pts, mask, 21, 10, 0.01)
    assert ck.lk_kernel_launches == before + 1 and tlk.lk_plain_calls == calls
    p_p, ok_p = tlk.track_pyramid_plain(pyr0, grads0, pyr1, pts, mask, 21, 10, 0.01)
    p, okk, p_p, ok_p = (x.cpu() for x in (p, okk, p_p, ok_p))
    assert torch.equal(okk, ok_p)
    assert okk.sum() > 15
    torch.testing.assert_close(p[okk], p_p[okk], rtol=0, atol=1e-3)
    with pytest.raises(ValueError):       # levels of pyr1 missing
        ck.track_pyramid_cuda(pyr0, grads0, pyr1[:2], pts, mask, 21, 10, 0.01)
