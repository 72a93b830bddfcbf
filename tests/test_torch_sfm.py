"""Global SfM of the port (`lmono_tpu_torch.estimator.sfm.global_sfm`)
against the JAX package's, on `tests/test_sfm.py`'s two windows (the same
numpy observations, relative pose and anchor):

* noiseless (8 frames, 64 tracks, anchor 0): poses within 1e-3 (m, and
  quaternion components), the same triangulated set, and the reference
  test's own gates on the port's result;
* noisy (6 frames, 48 tracks, 1/460 noise, anchor 1): the reference's
  GN solve is conditioned by the noise, so poses are held within twice the
  distance the reference's own result moves when its observations change
  by one ulp (as `test_torch_window.py::test_triangulate_matches` holds
  the triangulation), and to the reference test's 0.15 m gate.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmono_tpu.estimator.sfm import global_sfm as jsfm
from lmono_tpu.utils.lie import Pose as JPose
from lmono_tpu_torch.estimator.sfm import global_sfm
from lmono_tpu_torch.utils.lie import Pose
from test_sfm import _make_window
from torch_estimator_cases import one_torch_thread  # noqa: F401

CASES = {"noiseless": dict(seed=3, W1=8, M=64, noise=0.0, l=0),
         "noisy": dict(seed=11, W1=6, M=48, noise=1.0 / 460.0, l=1)}
POSE_ATOL = 1e-3


@functools.lru_cache(maxsize=None)
def _case(name):
    c = CASES[name]
    rng = np.random.default_rng(c["seed"])
    obs, mask, t_gt, q_gt = _make_window(rng, W1=c["W1"], M=c["M"], noise=c["noise"])
    l = c["l"]
    pose_l = JPose(jnp.asarray(t_gt[l]), jnp.asarray(q_gt[l]))
    pose_n = JPose(jnp.asarray(t_gt[-1]), jnp.asarray(q_gt[-1]))
    rel = pose_n.inverse().compose(pose_l)
    return (np.asarray(obs), np.asarray(mask), np.asarray(rel.t),
            np.asarray(rel.q), t_gt, q_gt)


@functools.lru_cache(maxsize=None)
def _jitted(l: int):
    return jax.jit(lambda o, m, rt, rq: jsfm(o, m, l, JPose(rt, rq)))


@functools.lru_cache(maxsize=None)
def _reference(name, ulp: bool = False):
    """The JAX package's result (jitted, as tests/test_sfm.py runs it) as
    numpy (t, q, point_ok, ok); ulp: observations moved one ulp up."""
    obs, mask, rt, rq, _, _ = _case(name)
    if ulp:
        obs = np.nextafter(obs, np.float32(np.inf))
    res = _jitted(CASES[name]["l"])(jnp.asarray(obs), jnp.asarray(mask),
                                    jnp.asarray(rt), jnp.asarray(rq))
    return (np.asarray(res.poses.t), np.asarray(res.poses.q),
            np.asarray(res.point_ok), bool(res.ok))


def _port(name):
    obs, mask, rt, rq, _, _ = _case(name)
    res = global_sfm(torch.tensor(obs), torch.tensor(mask), CASES[name]["l"],
                     Pose(torch.tensor(rt), torch.tensor(rq)))
    return res


def _gt_in_frame_l(name):
    _, _, _, _, t_gt, q_gt = _case(name)
    l = CASES[name]["l"]
    T0 = JPose(jnp.asarray(t_gt[l]), jnp.asarray(q_gt[l])).inverse()
    return np.stack([np.asarray(T0.apply(jnp.asarray(t))) for t in t_gt])


def _q_dist(a, b):
    # quaternions up to sign
    return np.minimum(np.abs(a - b), np.abs(a + b))


def test_noiseless_window_matches_the_reference():
    res = _port("noiseless")
    t_ref, q_ref, pok_ref, ok_ref = _reference("noiseless")
    t, q = res.poses.t.numpy(), res.poses.q.numpy()
    np.testing.assert_allclose(t, t_ref, rtol=0, atol=POSE_ATOL)
    assert _q_dist(q, q_ref).max() <= POSE_ATOL
    np.testing.assert_array_equal(res.point_ok.numpy(), pok_ref)
    assert bool(res.ok) and ok_ref

    # tests/test_sfm.py's gates on the port's own result
    assert int(res.point_ok.sum()) > 32
    assert np.linalg.norm(t - _gt_in_frame_l("noiseless"), axis=-1).max() < 0.08
    obs, mask = _case("noiseless")[:2]
    ok = res.point_ok.numpy()
    X = res.points.numpy()[ok]
    pose0 = Pose(res.poses.t[0], res.poses.q[0])
    pc = pose0.apply_inv(torch.from_numpy(X)).numpy()
    e = np.linalg.norm(pc[:, :2] / pc[:, 2:3] - obs[:, 0][ok], axis=-1)[mask[:, 0][ok]]
    assert np.median(e) < 5e-3


def test_noisy_window_within_the_references_spread():
    res = _port("noisy")
    t_ref, q_ref, _, ok_ref = _reference("noisy")
    t_ulp, q_ulp, _, _ = _reference("noisy", ulp=True)
    move_t = np.abs(t_ulp - t_ref).max()
    move_q = _q_dist(q_ulp, q_ref).max()
    assert move_t > 0.0
    t, q = res.poses.t.numpy(), res.poses.q.numpy()
    assert np.abs(t - t_ref).max() <= 2.0 * move_t, (np.abs(t - t_ref).max(), move_t)
    assert _q_dist(q, q_ref).max() <= 2.0 * move_q, (_q_dist(q, q_ref).max(), move_q)
    assert bool(res.ok) and ok_ref
    assert np.linalg.norm(t - _gt_in_frame_l("noisy"), axis=-1).max() < 0.15


@pytest.mark.parametrize("name", list(CASES))
def test_gauge_holds_the_anchor_and_the_last_translation(name):
    res = _port(name)
    obs, mask, rt, rq, _, _ = _case(name)
    l = CASES[name]["l"]
    assert torch.equal(res.poses.t[l], torch.zeros(3))
    assert torch.equal(res.poses.q[l], torch.tensor([1.0, 0.0, 0.0, 0.0]))
    last = Pose(torch.from_numpy(rt), torch.from_numpy(rq)).inverse()
    assert torch.equal(res.poses.t[-1], last.t)
