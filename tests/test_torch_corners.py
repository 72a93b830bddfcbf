"""The port's corner detector (`lmono_tpu_torch.ops.corners`) against
`lmono_tpu.ops.corners`.

Tolerances: the Shi–Tomasi response within rtol 1e-4 and atol 1e-6 times
its maximum.  `detect_grid` equal in uv and valid, except where the
responses of the two picks lie within 1e-5 relative of each other (a tie
that summation order may break either way); such rows are printed.  The
duplicate-scatter and tie orders of the reference are checked exactly.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmono_tpu.config import synthetic_config
from lmono_tpu.io import synthetic as jsyn
from lmono_tpu.ops import corners as jco
from lmono_tpu.utils.lie import Pose as JPose
from lmono_tpu_torch.ops import corners as tco

RTOL, ATOL_REL = 1e-4, 1e-6
TIE_REL = 1e-5
CAM = dataclasses.replace(synthetic_config().camera, width=256, height=128,
                          fx=128.0, fy=128.0, cx=128.0, cy=64.0)


@functools.lru_cache(maxsize=None)
def _rendered(i):
    traj = jsyn.circuit_trajectory(i + 1)
    pose = JPose(traj.t[i], traj.q[i]).compose(jsyn.synthetic_T_CL().inverse())
    return np.asarray(jsyn.render_camera(jsyn.make_city_scene(), pose, CAM))


def _texture(seed, H=128, W=256):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(H // 8, W // 8)).astype(np.float32)
    img = np.kron(base, np.ones((8, 8), np.float32))
    img = np.cumsum(np.cumsum(img, 0), 1)
    return ((img - img.min()) / (img.max() - img.min())).astype(np.float32)


def _occupied(seed, N, H=128, W=256):
    rng = np.random.default_rng(seed)
    uv = (rng.random((N, 2)) * [W + 40, H + 40] - 20).astype(np.float32)
    uv[:5] = [[np.nan, 3.0], [1e10, 5.0], [-1e10, 7.0], [40.0, np.inf], [70.0, 30.0]]
    uv[5] = uv[4] + 1.0        # same cell as slot 4
    mask = rng.random(N) < 0.5
    return uv, mask


def _check_detect(img, uv_occ, mask, cell, max_new):
    uj, vj = jco.detect_grid(jnp.asarray(img), cell, max_new,
                             jnp.asarray(uv_occ), jnp.asarray(mask))
    ut, vt = tco.detect_grid(torch.from_numpy(img), cell, max_new,
                             torch.from_numpy(uv_occ), torch.from_numpy(mask))
    uj, vj, ut, vt = np.asarray(uj), np.asarray(vj), ut.numpy(), vt.numpy()
    assert ut.dtype == np.float32 and vt.dtype == bool
    resp = np.asarray(jco.shi_tomasi_response(jnp.asarray(img)))
    bad = np.flatnonzero((uj != ut).any(1) | (vj != vt))
    for k in bad:
        rj = resp[int(uj[k, 1]), int(uj[k, 0])]
        rt = resp[int(ut[k, 1]), int(ut[k, 0])]
        print(f"near tie at rank {k}: jax {uj[k]} ({rj}), port {ut[k]} ({rt})")
        assert abs(rj - rt) <= TIE_REL * max(abs(rj), abs(rt)), k
    return vt


@pytest.mark.parametrize("src", ["render0", "render4", "texture"])
def test_response_matches(src):
    img = _texture(1) if src == "texture" else _rendered(int(src[-1]))
    a = np.asarray(jco.shi_tomasi_response(jnp.asarray(img)))
    b = tco.shi_tomasi_response(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL_REL * np.abs(a).max())


@pytest.mark.parametrize("src,cell,max_new,n_occ", [
    ("render0", 16, 48, 40), ("render4", 16, 32, 48), ("texture", 16, 48, 32),
    ("texture", 12, 40, 64)])
def test_detect_grid_matches(src, cell, max_new, n_occ):
    img = _texture(2) if src == "texture" else _rendered(int(src[-1]))
    uv, mask = _occupied(cell + n_occ, n_occ)
    valid = _check_detect(img, uv, mask, cell, max_new)
    assert valid.sum() > 10


def test_duplicate_cells_take_the_highest_slot():
    # three slots in one cell: the last writer wins on the JAX CPU
    img = _texture(3)
    for mask, want in (([True, False, True], True), ([True, True, False], False)):
        uv = np.array([[40.0, 40.0], [41.0, 42.0], [39.5, 44.0]], np.float32)
        m = np.array(mask)
        _check_detect(img, uv, m, 16, 40)
        cells = jnp.full(3, 2)
        occ_j = np.asarray(jnp.zeros((8, 16), bool).at[cells, cells].set(jnp.asarray(m)))
        assert bool(occ_j[2, 2]) is want
        ut, vt = tco.detect_grid(torch.from_numpy(img), 16, 128,
                                 torch.from_numpy(uv), torch.from_numpy(m))
        picked = {(int(x) // 16, int(y) // 16) for x, y in ut[vt].tolist()}
        assert ((2, 2) in picked) is (not want)


def test_ties_keep_the_lower_index():
    # a flat image: every free cell ties at exactly 0 in both packages and
    # occupied cells at -inf; the invalid picks (whose positions the
    # tracker keeps) follow index order, so the two must agree exactly
    img = np.full((128, 256), 0.5, np.float32)
    uv, mask = _occupied(4, 16)
    uj, vj = jco.detect_grid(jnp.asarray(img), 16, 128, jnp.asarray(uv),
                             jnp.asarray(mask))
    ut, vt = tco.detect_grid(torch.from_numpy(img), 16, 128,
                             torch.from_numpy(uv), torch.from_numpy(mask))
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert not vt.any()
