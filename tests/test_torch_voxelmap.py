"""Voxel banks of the port are BIT-EQUAL to `lmono_tpu.ops.voxelmap`.

Points span negative and large coordinates so that the int32 wraparound of
the spatial hash is exercised; several new points share voxels (contested
slots), and some fall outside the keep radius (eviction).  No tolerance:
every bank field must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmono_tpu.ops import voxelmap as jv
from lmono_tpu_torch.ops import voxelmap as tv


def _points(rng, n, center, spread):
    p = center + rng.uniform(-spread, spread, size=(n, 3))
    # duplicate some points into the same voxel (contested slots)
    p[n // 2: n // 2 + n // 8] = p[: n // 8] + 0.01
    return p.astype(np.float32)


def _both(bank_np):
    jb = jv.PointBank(jnp.asarray(bank_np[0]), jnp.asarray(bank_np[1]))
    tb = tv.PointBank(torch.from_numpy(bank_np[0]), torch.from_numpy(bank_np[1]))
    return jb, tb


def _equal(jb, tb):
    np.testing.assert_array_equal(np.asarray(jb.points), tb.points.numpy())
    np.testing.assert_array_equal(np.asarray(jb.mask), tb.mask.numpy())


@pytest.mark.parametrize("center", [(0.0, 0.0, 0.0), (-3000.0, 2500.0, -40.0),
                                    (1.5e5, -2.2e5, 7.0e4)])
@pytest.mark.parametrize("update", ["hash", "sort"])
def test_bank_updates_bit_equal(center, update):
    rng = np.random.default_rng(abs(int(center[0])) + len(update))
    center = np.asarray(center, np.float32)
    cap, n_new = 256, 200
    jb, tb = _both((np.zeros((cap, 3), np.float32), np.zeros(cap, bool)))
    jfn = jv.bank_update_hash if update == "hash" else jv.bank_update
    tfn = tv.bank_update_hash if update == "hash" else tv.bank_update
    for step in range(4):
        c = center + np.float32(step * 3.0)
        new = _points(rng, n_new, c, 60.0)       # some beyond the radius
        new_mask = rng.random(n_new) < 0.9
        args = (0.4 * (1 + step % 2), 45.0)
        jb = jfn(jb, jnp.asarray(new), jnp.asarray(new_mask), args[0],
                 jnp.asarray(c), args[1])
        tb = tfn(tb, torch.from_numpy(new), torch.from_numpy(new_mask), args[0],
                 torch.from_numpy(c), args[1])
        _equal(jb, tb)
    assert 0 < int(tb.mask.sum()) < cap


def test_hash_slots_wraparound_bit_equal():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-8e5, 8e5, size=(4096, 3)).astype(np.float32)
    for voxel, cap in [(0.4, 32768), (0.8, 65536), (0.05, 1000)]:
        js = np.asarray(jv._hash_slots(jnp.asarray(pts), voxel, cap))
        ts = tv._hash_slots(torch.from_numpy(pts), voxel, cap).numpy()
        np.testing.assert_array_equal(js, ts)


def test_voxel_keys_bit_equal():
    rng = np.random.default_rng(4)
    origin = np.array([-120.0, 55.0, 3.0], np.float32)
    pts = (origin + rng.uniform(-300, 300, size=(2048, 3))).astype(np.float32)
    jk = np.asarray(jv._voxel_keys(jnp.asarray(pts), 0.4, jnp.asarray(origin)))
    tk = tv._voxel_keys(torch.from_numpy(pts), 0.4, torch.from_numpy(origin)).numpy()
    np.testing.assert_array_equal(jk, tk)


def test_full_bank_keeps_oldest_points():
    rng = np.random.default_rng(5)
    cap = 64
    old = rng.uniform(-20, 20, size=(cap, 3)).astype(np.float32)
    jb, tb = _both((old, np.ones(cap, bool)))
    new = rng.uniform(-20, 20, size=(100, 3)).astype(np.float32)
    nm = np.ones(100, bool)
    c = np.zeros(3, np.float32)
    jb = jv.bank_update(jb, jnp.asarray(new), jnp.asarray(nm), 0.01, jnp.asarray(c), 100.0)
    tb = tv.bank_update(tb, torch.from_numpy(new), torch.from_numpy(nm), 0.01,
                        torch.from_numpy(c), 100.0)
    _equal(jb, tb)
    assert bool(tb.mask.all())
