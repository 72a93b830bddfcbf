"""The port's intrinsic calibration (`lmono_tpu_torch.camera.calibration`)
against `lmono_tpu.camera.calibration`, on the synthetic views of
`tests/test_calibration.py`, and its CLI (`lmono_tpu_torch.intrinsic_calib`)
end to end on the CPU.

Tolerances:
* `calibrate_pinhole` and `calibrate_camera` (pinhole / MEI / equidistant):
  every intrinsic (focal lengths, principal point, ξ) within 1e-3 relative
  of the reference's; the board corners reprojected through the port's
  parameters and view poses within 0.01 px of those through the
  reference's; the final RMSE within 0.01 px; the view poses within 1e-3
  m / 1e-3.  The distortion coefficients one by one: within 1e-3 relative
  of the largest for `calibrate_pinhole`; for the equidistant model within
  twice the reference's own spread under a one-ulp change of its input,
  which exceeds 1e-3 relative (the θ-polynomial's terms trade off against
  each other, and f32 sums in another order move them along that valley);
* `find_chessboard_corners` on the flat board and on tilted boards:
  corners equal to the reference's, in the same order, and the same `ok`;
* `estimate_extrinsics` through a MEI camera, with the Gumbel noise behind
  the reference's key (`jax.random.gumbel(key, (iters, 6, N))`): the same
  verdict, the pose within 1e-4, the inliers equal away from the gate.

The JAX calibrations are cached per worker; the port runs on one torch
thread.
"""

import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmono_tpu.camera import calibration as jcal
from lmono_tpu.camera.models import equidistant_camera as jequi
from lmono_tpu.camera.models import mei_camera as jmei
from lmono_tpu_torch import intrinsic_calib
from lmono_tpu_torch.camera import calibration as tcal
from lmono_tpu_torch.camera.models import mei_camera as tmei
from lmono_tpu_torch.io.png import write_png
from lmono_tpu_torch.utils.lie import Pose as TPose
from test_calibration import _render_tilted_board, _synth_model_views, synth_views
from torch_estimator_cases import one_torch_thread  # noqa: F401

INTRINSICS = {"pinhole": ("fx", "fy", "cx", "cy"),
              "mei": ("gamma1", "gamma2", "u0", "v0", "xi"),
              "equidistant": ("mu", "mv", "u0", "v0")}
WIDE = {"mei": (jmei(640, 480, gamma1=410.0, gamma2=405.0, u0=325.0, v0=245.0,
                     xi=0.9, k1=-0.1, k2=0.02), 1),
        "equidistant": (jequi(640, 480, mu=300.0, mv=298.0, u0=322.0, v0=242.0,
                              k2=0.01, k3=-0.002), 3)}


@functools.lru_cache(maxsize=None)
def _views(model):
    if model == "pinhole":
        return synth_views()
    cam, seed = WIDE[model]
    return _synth_model_views(cam, seed=seed)


@functools.lru_cache(maxsize=None)
def _jax_calibrate(model, scale=1.0):
    """The reference's calibration; `scale` multiplies the pixels (in f32)."""
    if model == "zhang":
        return jcal.calibrate_pinhole(*_views("pinhole"), iters=25)
    obj, img = _views(model)
    img = img if scale == 1.0 else img.astype(np.float32) * np.float32(scale)
    return jcal.calibrate_camera(model, obj, img, image_size=(640, 480))


@functools.lru_cache(maxsize=None)
def _port_calibrate(model):
    torch.set_num_threads(1)
    if model == "zhang":
        return tcal.calibrate_pinhole(*_views("pinhole"), iters=25, device="cpu")
    return tcal.calibrate_camera(model, *_views(model), image_size=(640, 480),
                                 device="cpu")


def _reprojected(model, params, poses, obj):
    """The board corners (V, N, 2) through the port's projection of `model`
    at `params` and `poses` (either package's)."""
    obj3 = torch.cat([torch.as_tensor(obj), torch.zeros(len(obj), 1)], -1)
    t, q = (torch.as_tensor(np.asarray(x)) for x in (poses.t, poses.q))
    P = TPose(t[:, None], q[:, None]).apply(obj3)
    return tcal._project(model, [params[k] for k in tcal._MODEL_THETA[model]], P)


def _check(model, params, poses, rmse, ref_params, ref_poses, ref_rmse, obj):
    for k in INTRINSICS[model]:
        assert abs(params[k] - ref_params[k]) <= 1e-3 * abs(ref_params[k]), \
            (k, params[k], ref_params[k])
    d = (_reprojected(model, params, poses, obj)
         - _reprojected(model, ref_params, ref_poses, obj)).abs().max()
    assert float(d) <= 0.01, float(d)
    assert abs(rmse - ref_rmse) <= 0.01
    np.testing.assert_allclose(poses.t.numpy(), np.asarray(ref_poses.t), rtol=0, atol=1e-3)
    dq = np.minimum(np.abs(poses.q.numpy() - np.asarray(ref_poses.q)),
                    np.abs(poses.q.numpy() + np.asarray(ref_poses.q)))
    assert dq.max() <= 1e-3, dq.max()


def _pinhole_dict(r):
    return dict(zip(("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2"),
                    [r.fx, r.fy, r.cx, r.cy, *[float(x) for x in r.dist]]))


def test_calibrate_pinhole_matches():
    ref, res = _jax_calibrate("zhang"), _port_calibrate("zhang")
    _check("pinhole", _pinhole_dict(res), res.view_poses, res.reproj_rmse,
           _pinhole_dict(ref), ref.view_poses, ref.reproj_rmse, _views("pinhole")[0])
    for k, v in _pinhole_dict(ref).items():
        assert abs(_pinhole_dict(res)[k] - v) <= 1e-3 * max(abs(ref.dist).max(), abs(v))
    # and the truth, as tests/test_calibration.py holds the reference
    assert abs(res.fx - 500.0) < 1.0 and abs(res.dist[0] + 0.15) < 0.01


@pytest.mark.parametrize("model", ["pinhole", "mei", "equidistant"])
def test_calibrate_camera_matches(model):
    ref, res = _jax_calibrate(model), _port_calibrate(model)
    assert res.model == model and list(res.params) == list(ref.params)
    _check(model, res.params, res.view_poses, res.reproj_rmse,
           ref.params, ref.view_poses, ref.reproj_rmse, _views(model)[0])
    assert res.reproj_rmse < 0.5


def test_equidistant_coefficients_within_the_reference_spread():
    """The θ-polynomial's coefficients, one by one: the reference's own
    calibration moves them by more than 1e-3 relative when its pixels are
    scaled by one ulp (1 + 2⁻²³); the port's lie within twice that spread
    of the reference's, or within 1e-3 relative."""
    ref, res = _jax_calibrate("equidistant"), _port_calibrate("equidistant")
    ulp = _jax_calibrate("equidistant", 1 + 2 ** -23)
    spread = {k: abs(ulp.params[k] - ref.params[k]) for k in ("k2", "k3", "k4", "k5")}
    assert max(spread[k] / abs(ref.params[k]) for k in spread) > 1e-3, spread
    for k, s in spread.items():
        assert abs(res.params[k] - ref.params[k]) <= max(2 * s, 1e-3 * abs(ref.params[k])), \
            (k, res.params[k], ref.params[k], s)


def test_calibrate_camera_rejects_other_models():
    with pytest.raises(ValueError):
        tcal.calibrate_camera("scaramuzza", np.zeros((4, 2)), np.zeros((3, 4, 2)),
                              device="cpu")


def _flat_board():
    rows, cols, sq = 4, 6, 24
    yy, xx = np.mgrid[0:(rows + 3) * sq, 0:(cols + 3) * sq]
    return (((xx // sq) + (yy // sq)) % 2).astype(np.float32), rows, cols


BOARDS = {"flat": _flat_board}
for _name, _args in {"tilt32": (32.0, 8.0, 0.0), "tilt40": (40.0, -12.0, 0.0),
                     "mixed": (-34.0, -8.0, 10.0), "mixed2": (6.0, 14.0, 32.0)}.items():
    BOARDS[_name] = functools.partial(
        lambda a: (np.array(_render_tilted_board(5, 7, 26, a[0], yaw_deg=a[1],
                                                 tilt_x_deg=a[2])[0]), 5, 7), _args)


@pytest.mark.parametrize("board", list(BOARDS))
def test_chessboard_corners_match(board):
    img, rows, cols = BOARDS[board]()
    jc, jok = jcal.find_chessboard_corners(jnp.asarray(img), rows, cols)
    tc, tok = tcal.find_chessboard_corners(torch.from_numpy(img), rows, cols)
    assert tok == bool(jok) and tok
    assert tc.shape == (rows * cols, 2) and tc.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_estimate_extrinsics_matches():
    """A MEI camera sees a 3D cloud; 20% of the pixels are outliers."""
    from lmono_tpu.utils.lie import Pose as JPose
    from lmono_tpu.utils.lie import so3_exp_quat

    args = (752, 480, 370.0, 369.0, 376.0, 240.0)
    kw = dict(xi=0.9, k1=-0.05, k2=0.005)
    jcam, tcam = jmei(*args, **kw), tmei(*args, **kw)
    rng = np.random.default_rng(4)
    n, iters = 80, 64
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(3, 12, n)], -1).astype(np.float32)
    pose = JPose(jnp.asarray([0.2, -0.1, 0.5], jnp.float32),
                 so3_exp_quat(jnp.asarray([0.05, -0.1, 0.08], jnp.float32)))
    uv = np.asarray(jcam.space_to_plane(pose.apply(jnp.asarray(X))))
    uv = uv + rng.normal(0, 0.3, uv.shape)
    bad = rng.random(n) < 0.2
    uv[bad] = rng.uniform([0, 0], [752, 480], (int(bad.sum()), 2))
    uv = uv.astype(np.float32)
    key = jax.random.PRNGKey(9)
    jpose, jinl, jok = jax.jit(lambda o, u, k: jcal.estimate_extrinsics(
        jcam, o, u, key=k, iters=iters))(jnp.asarray(X), jnp.asarray(uv), key)
    g = torch.from_numpy(np.asarray(jax.random.gumbel(key, (iters, 6, n))))
    tpose, tinl, tok = tcal.estimate_extrinsics(tcam, X, uv, gumbel=g, iters=iters,
                                                device="cpu")
    assert bool(tok) == bool(jok) and bool(tok)
    np.testing.assert_allclose(tpose.t.numpy(), np.asarray(jpose.t), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tpose.q.numpy(), np.asarray(jpose.q), rtol=0, atol=1e-4)
    xy = np.asarray(jcam.lift_to_normalized(jnp.asarray(uv)))
    Pc = np.asarray(jpose.apply(jnp.asarray(X)))
    e2 = np.sum((Pc[:, :2] / np.maximum(Pc[:, 2:], 1e-6) - xy) ** 2, -1)
    near = np.abs(e2 - 1e-4) < 1e-3 * 1e-4
    np.testing.assert_array_equal(tinl.numpy()[~near], np.asarray(jinl)[~near])
    np.testing.assert_allclose(tpose.t.numpy(), np.asarray(pose.t), atol=0.05)


def test_estimate_extrinsics_draws_its_own_samples():
    rng = np.random.default_rng(5)
    X = np.stack([rng.uniform(-3, 3, 40), rng.uniform(-2, 2, 40),
                  rng.uniform(3, 12, 40)], -1).astype(np.float32)
    cam = tmei(752, 480, 370.0, 369.0, 376.0, 240.0, xi=0.9)
    uv = cam.space_to_plane(torch.from_numpy(X))
    pose, inl, ok = tcal.estimate_extrinsics(cam, X, uv, iters=32)
    assert bool(ok) and int(inl.sum()) == 40
    np.testing.assert_allclose(pose.t.numpy(), 0.0, atol=1e-3)


def test_intrinsic_calib_demo(capsys):
    res = intrinsic_calib.main(["--demo", "--device", "cpu"])
    t = intrinsic_calib.DEMO_TRUTH
    assert abs(res.fx - t["fx"]) < 1.0 and abs(res.fy - t["fy"]) < 1.0
    assert abs(res.cx - t["cx"]) < 1.5 and abs(res.cy - t["cy"]) < 1.5
    assert abs(res.dist[0] - t["k1"]) < 0.01 and res.reproj_rmse < 0.05
    assert "reproj rmse" in capsys.readouterr().out


def test_intrinsic_calib_images(tmp_path, monkeypatch):
    """PNGs of tilted boards, written to tmp_path, through the CLI; the
    working directory is tmp_path and nothing else is written."""
    monkeypatch.chdir(tmp_path)
    for i, (ty, tx, yaw) in enumerate(((30.0, 4.0, 5.0), (-34.0, 10.0, -8.0),
                                       (6.0, 32.0, 14.0), (-8.0, -31.0, 20.0),
                                       (24.0, -24.0, -16.0), (-22.0, 26.0, 9.0))):
        img, _ = _render_tilted_board(5, 7, 26, ty, f=400.0, yaw_deg=yaw, tilt_x_deg=tx)
        write_png(str(tmp_path / f"view{i}.png"),
                  np.round(np.asarray(img) * 255).astype(np.uint8))
    before = sorted(os.listdir(tmp_path))
    res = intrinsic_calib.main(["--images", str(tmp_path / "*.png"), "--rows", "5",
                                "--cols", "7", "--device", "cpu"])
    assert sorted(os.listdir(tmp_path)) == before
    assert len(glob.glob(str(tmp_path / "*.png"))) == 6
    assert res.reproj_rmse < 0.5 and abs(res.fx - 400.0) < 12.0


def test_intrinsic_calib_takes_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        intrinsic_calib.main(["--demo"])
