"""Scan registration of the port against `lmono_tpu.lidar.registration`.

Tolerances: line/plane fits within 1e-5 (f32 covariance sums in another
order, and a closed-form determinant in place of an LU) where the fitted
direction is well conditioned: lines, and plane patches whose two in-plane
eigenvalues are apart by more than 5% of the largest.  In f32 the
trigonometric eigen-solution loses accuracy as that gap closes (both
packages then sit ~1e-5 from a float64 eigensolver, on different sides), so
the other plane patches are held to 1e-4, and sets with two equal
eigenvalues, where the direction is not defined, only to finite values.  `register`
from the same perturbed start on the same banks: within 1e-4 m and
1e-5 rad, with inlier counts within 1% (a fit gate can flip at its
boundary).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmono_tpu.config import synthetic_config
from lmono_tpu.io import synthetic as jsyn
from lmono_tpu.lidar import registration as jr
from lmono_tpu.lidar.features import extract_features
from lmono_tpu.ops.voxelmap import PointBank, bank_update_hash
from lmono_tpu.utils.lie import Pose as JPose, so3_exp_quat, quat_mul
from lmono_tpu_torch.lidar import registration as tr
from lmono_tpu_torch.utils.lie import Pose as TPose, boxminus

FIT_ATOL = 1e-5
T_ATOL_M = 1e-4
R_ATOL_RAD = 1e-5


def _neighbour_sets(seed, Q=128, k=5):
    """Line-like, plane-like and random neighbour sets, with some rows
    masked down to fewer than 3 neighbours."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(Q, 1, 3)) * 20
    d = rng.normal(size=(Q, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    s = rng.uniform(-1, 1, size=(Q, k, 1))
    line = c + s * d + rng.normal(size=(Q, k, 3)) * 0.01
    e1 = np.cross(d, rng.normal(size=(Q, 1, 3)))
    e1 /= np.linalg.norm(e1, axis=-1, keepdims=True)
    e2 = np.cross(d, e1)
    plane = (c + rng.uniform(-1, 1, (Q, k, 1)) * e1
             + rng.uniform(-0.4, 0.4, (Q, k, 1)) * e2
             + rng.normal(size=(Q, k, 3)) * 0.01)
    blob = c + rng.normal(size=(Q, k, 3)) * np.array([1.0, 0.5, 0.2])
    kind = np.arange(Q) % 3
    nbrs = np.where(kind[:, None, None] == 0, line,
                    np.where(kind[:, None, None] == 1, plane, blob)).astype(np.float32)
    ok = rng.random((Q, k)) < 0.9
    ok[::11, 2:] = False
    return nbrs, ok, kind


def test_fit_lines_and_planes_match():
    nbrs, ok, kind = _neighbour_sets(0)
    tn, to = torch.from_numpy(nbrs), torch.from_numpy(ok)
    jc, jv, jok = jr.fit_lines(jnp.asarray(nbrs), jnp.asarray(ok))
    tc, tv, tok = tr.fit_lines(tn, to)
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    np.testing.assert_allclose(np.asarray(jc), tc.numpy(), rtol=0, atol=FIT_ATOL)
    assert np.isfinite(tv.numpy()).all()
    sel = np.asarray(jok) & (kind == 0)
    np.testing.assert_allclose(np.asarray(jv)[sel], tv.numpy()[sel], rtol=0, atol=FIT_ATOL)

    jn, jrho, jpok = jr.fit_planes(jnp.asarray(nbrs), jnp.asarray(ok))
    tn_, trho, tpok = tr.fit_planes(tn, to)
    assert np.isfinite(tn_.numpy()).all() and np.isfinite(trho.numpy()).all()
    np.testing.assert_array_equal(np.asarray(jpok)[kind == 1], tpok.numpy()[kind == 1])
    lam = np.linalg.eigvalsh(np.asarray(jr._weighted_cov(jnp.asarray(nbrs),
                                                         jnp.asarray(ok))[1], np.float64))
    apart = (lam[:, 1] - lam[:, 0]) > 0.05 * lam[:, 2]
    for rows, atol in [(np.asarray(jpok) & (kind == 1), FIT_ATOL * 10),
                       (np.asarray(jpok) & (kind == 1) & apart, FIT_ATOL)]:
        np.testing.assert_allclose(np.asarray(jn)[rows], tn_.numpy()[rows], rtol=0, atol=atol)
        # rho = −n·c: a normal error of atol moves it by up to atol·|c|
        scale = 1.0 + np.linalg.norm(np.asarray(jc), axis=-1)[rows]
        assert (np.abs(np.asarray(jrho)[rows] - trho.numpy()[rows]) <= atol * scale).all()
    sel = np.asarray(jpok) & (kind == 1) & apart
    assert sel.sum() > 15 and (np.asarray(jok) & (kind == 0)).sum() > 30


def test_eigvals_match_and_stay_finite_when_degenerate():
    nbrs, ok, kind = _neighbour_sets(1, Q=64)
    ok[:4] = False                        # empty rows: zero covariance
    _, jcov = jr._weighted_cov(jnp.asarray(nbrs), jnp.asarray(ok))
    _, tcov = tr._weighted_cov(torch.from_numpy(nbrs), torch.from_numpy(ok))
    np.testing.assert_allclose(np.asarray(jcov), tcov.numpy(), rtol=1e-5, atol=1e-6)
    jl = np.asarray(jr._sym3x3_eigvals(jcov))
    tl = tr._sym3x3_eigvals(tcov).numpy()
    assert np.isfinite(tl).all()
    # anisotropic blobs and plane patches: three distinct eigenvalues
    sel = (kind != 0) & (ok.sum(1) == 5)
    np.testing.assert_allclose(jl[sel], tl[sel], rtol=0, atol=FIT_ATOL)
    assert sel.sum() > 10


@functools.lru_cache(maxsize=None)
def _register_inputs():
    cfg = synthetic_config().lidar
    scene = jsyn.make_city_scene()
    traj = jsyn.circuit_trajectory(8)
    poses = [JPose(traj.t[i], traj.q[i]) for i in range(8)]
    edge = PointBank.empty(cfg.map_edge_capacity)
    plane = PointBank.empty(cfg.map_planar_capacity)
    for i in (0, 2, 4):                   # a map from three true poses
        s = jsyn.simulate_lidar(scene, poses[i], cfg, noise_std=0.0)
        f = extract_features(s["points"], s["ranges"], s["valid"], cfg)
        edge = bank_update_hash(edge, poses[i].apply(f.edge_points), f.edge_mask,
                                cfg.map_voxel_size, poses[i].t, cfg.map_keep_radius)
        plane = bank_update_hash(plane, poses[i].apply(f.planar_points),
                                 f.planar_mask, cfg.map_voxel_size * 2.0,
                                 poses[i].t, cfg.map_keep_radius)
    s = jsyn.simulate_lidar(scene, poses[6], cfg, noise_std=0.0)
    f = extract_features(s["points"], s["ranges"], s["valid"], cfg)
    dq = so3_exp_quat(jnp.array([0.004, -0.003, 0.01], jnp.float32))
    start = JPose(poses[6].t + jnp.array([0.15, -0.1, 0.05], jnp.float32),
                  quat_mul(poses[6].q, dq))
    arrays = [f.edge_points, f.edge_mask, f.planar_points, f.planar_mask,
              edge.points, edge.mask, plane.points, plane.mask]
    return cfg, start, poses[6], [np.array(a) for a in arrays]


@pytest.mark.parametrize("iters", [4, 6])
def test_register_matches(iters):
    cfg, start, truth, arrays = _register_inputs()
    jpose, jdiag = jr.register(start, *[jnp.asarray(a) for a in arrays], cfg, iters)
    tstart = TPose(torch.from_numpy(np.array(start.t)), torch.from_numpy(np.array(start.q)))
    tpose, tdiag = tr.register(tstart, *[torch.from_numpy(a) for a in arrays], cfg, iters)
    assert tdiag["costs"].shape == ((iters + 1) // 2,)
    np.testing.assert_allclose(tdiag["inliers"].numpy(), np.asarray(jdiag["inliers"]),
                               rtol=0.01)
    np.testing.assert_allclose(np.asarray(jpose.t), tpose.t.numpy(), rtol=0, atol=T_ATOL_M)
    rot = boxminus(torch.from_numpy(np.array(jpose.q)), tpose.q)
    assert float(rot.norm()) < R_ATOL_RAD
    # and both actually registered: far closer to the true pose than the start
    err0 = float(np.linalg.norm(np.asarray(start.t) - np.asarray(truth.t)))
    assert float(np.linalg.norm(tpose.t.numpy() - np.asarray(truth.t))) < err0 / 3


@pytest.mark.parametrize("select", ["bf16x3", "bf16"])
def test_register_matches_under_reduced_knn_select(monkeypatch, select):
    # the JAX package reads knn_select on its TPU route only: patch the
    # backend, as tests/test_torch_knn.py does, so its KNN takes that route
    import dataclasses

    import jax

    cfg, start, truth, arrays = _register_inputs()
    cfg = dataclasses.replace(cfg, knn_select=select)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jpose, jdiag = jr.register(start, *[jnp.asarray(a) for a in arrays], cfg, 4)
    tstart = TPose(torch.from_numpy(np.array(start.t)), torch.from_numpy(np.array(start.q)))
    tpose, tdiag = tr.register(tstart, *[torch.from_numpy(a) for a in arrays], cfg, 4)
    np.testing.assert_allclose(tdiag["inliers"].numpy(), np.asarray(jdiag["inliers"]),
                               rtol=0.01)
    np.testing.assert_allclose(np.asarray(jpose.t), tpose.t.numpy(), rtol=0, atol=T_ATOL_M)
    rot = boxminus(torch.from_numpy(np.array(jpose.q)), tpose.q)
    assert float(rot.norm()) < R_ATOL_RAD
    err0 = float(np.linalg.norm(np.asarray(start.t) - np.asarray(truth.t)))
    assert float(np.linalg.norm(tpose.t.numpy() - np.asarray(truth.t))) < err0 / 3


def test_unknown_knn_select_raises():
    import dataclasses

    cfg, start, _, arrays = _register_inputs()
    cfg = dataclasses.replace(cfg, knn_select="fp16")
    tstart = TPose(torch.from_numpy(np.array(start.t)), torch.from_numpy(np.array(start.q)))
    with pytest.raises(ValueError):
        tr.register(tstart, *[torch.from_numpy(a) for a in arrays], cfg, 2)


def test_reduced_knn_select_on_a_mesh_axis_merges_by_exact_d2():
    # on a mesh axis the reference merges the shards' picks by top_k of
    # their exact d² (one shard included); without an axis the picks stay
    # in selection order
    import dataclasses

    from lmono_tpu_torch.parallel.mesh import Axis

    cfg, _, _, arrays = _register_inputs()
    cfg = dataclasses.replace(cfg, knn_select="bf16")
    query = torch.from_numpy(arrays[2][:256])
    bank, mask = torch.from_numpy(arrays[6]), torch.from_numpy(arrays[7])
    center = query.mean(0)
    d_sel, n_sel = tr._knn_nbrs(query, bank, mask, cfg, center)
    d_ax, n_ax = tr._knn_nbrs(query, bank, mask, cfg, center, Axis("map", None, 1, 0))
    assert (torch.diff(d_ax, dim=1) >= 0).all()
    assert (torch.diff(d_sel, dim=1) < 0).any()
    order = torch.sort(d_sel, dim=1, stable=True).indices
    assert torch.equal(d_ax, torch.gather(d_sel, 1, order))
    assert torch.equal(n_ax, torch.gather(n_sel, 1, order[..., None].expand(-1, -1, 3)))
