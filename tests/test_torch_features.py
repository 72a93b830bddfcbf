"""Feature extraction of the port against `lmono_tpu.lidar.features` on the
same numpy scan (made by the JAX simulator).  Masks and points must be
BIT-EQUAL: the points are gathered from the input, so equal picks give
equal values; curvature itself is checked at rtol 1e-6."""

import jax
import numpy as np
import pytest
import torch

from lmono_tpu.config import synthetic_config
from lmono_tpu.io import synthetic as jsyn
from lmono_tpu.lidar import features as jf
from lmono_tpu.utils.lie import Pose as JPose
from lmono_tpu_torch.lidar import features as tf


def _scan(i, noise):
    cfg = synthetic_config().lidar
    scene = jsyn.make_city_scene()
    traj = jsyn.circuit_trajectory(40)
    s = jsyn.simulate_lidar(scene, JPose(traj.t[i], traj.q[i]), cfg,
                            noise_std=noise, key=jax.random.PRNGKey(7 + i))
    return cfg, {k: np.asarray(s[k]) for k in ("points", "ranges", "valid")}


@pytest.mark.parametrize("i,noise", [(0, 0.01), (23, 0.0)])
def test_extract_features_bit_equal(i, noise):
    cfg, s = _scan(i, noise)
    jout = jf.extract_features(s["points"], s["ranges"], s["valid"], cfg)
    tout = tf.extract_features(*(torch.from_numpy(s[k]) for k in
                                 ("points", "ranges", "valid")), cfg)
    for name in jf.ScanFeatures._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jout, name)),
                                      getattr(tout, name).numpy(), err_msg=name)
    assert int(tout.edge_mask.sum()) > 50 and int(tout.planar_mask.sum()) > 200


def test_curvature_and_occlusion_match():
    cfg, s = _scan(5, 0.01)
    pts, rng_, val = (torch.from_numpy(s[k]) for k in ("points", "ranges", "valid"))
    jc, jv = jf.compute_curvature(s["points"], s["valid"], cfg)
    tc, tv = tf.compute_curvature(pts, val, cfg)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_allclose(np.asarray(jc), tc.numpy(), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(np.asarray(jf.occlusion_mask(s["ranges"], s["valid"])),
                                  tf.occlusion_mask(rng_, val).numpy())


def test_select_topk_spaced_ties_and_sentinel():
    # rows with repeated maxima (first maximum wins) and rows too sparse
    # for k picks (validity false once the mask runs out)
    rng = np.random.default_rng(0)
    score = rng.integers(0, 4, size=(6, 40)).astype(np.float32)
    mask = rng.random((6, 40)) < 0.7
    mask[5] = False
    mask[4, :] = False
    mask[4, [3, 20]] = True
    ji, jok = jf._select_topk_spaced(score, mask, 5, 3)
    ti, tok = tf._select_topk_spaced(torch.from_numpy(score), torch.from_numpy(mask), 5, 3)
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    assert tok[4].tolist() == [True, True, False, False, False]
