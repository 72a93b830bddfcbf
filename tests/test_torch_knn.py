"""Exact KNN of the port (`lmono_tpu_torch.ops.knn`) against the JAX
package's CPU path (`lmono_tpu.ops.knn.knn`) and its Pallas kernel in
interpret mode (`knn_pallas`, as `tests/test_pallas_knn.py` runs it), and
the CUDA kernel's launch plan (`ops/cuda/knn.py:knn_plan`).

Tolerances: rtol 1e-4 / atol 1e-3 on sorted d² (the references use the
q²−2q·t+t² expansion, the port the difference form), and equal index sets
wherever d² < 1e11 (missing neighbours are 1e12 in every version).  The
`gpu` tests hold the CUDA kernel to the plain version at rtol 1e-5 /
atol 1e-4 (both compute the difference form in f32), with index lists
equal where bank points are duplicated across warp slices and cluster
ranks.  The JAX references
are imported inside the tests that use them, so that the `gpu` test also
runs on a host without JAX:
    python -m pytest tests/test_torch_knn.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from lmono_tpu_torch.ops import knn as tk


def jax_knn(*args, **kw):
    from lmono_tpu.ops.knn import knn

    return knn(*args, **kw)


def knn_pallas(*args, **kw):
    from lmono_tpu.ops.pallas.knn import knn_pallas

    return knn_pallas(*args, **kw)


RTOL, ATOL = 1e-4, 1e-3


def _case(seed, Q, M, keep, scale=10.0, offset=0.0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(Q, 3)) * scale + offset).astype(np.float32)
    t = (rng.normal(size=(M, 3)) * scale + offset).astype(np.float32)
    mask = rng.random(M) < keep
    return q, t, mask


def _check(d_ref, i_ref, d, i):
    d_ref, i_ref = np.asarray(d_ref), np.asarray(i_ref)
    d, i = d.numpy(), i.numpy()
    np.testing.assert_allclose(np.sort(d, 1), np.sort(d_ref, 1), rtol=RTOL, atol=ATOL)
    for r in range(d.shape[0]):
        assert (set(i[r][d[r] < 1e11].tolist())
                == set(i_ref[r][d_ref[r] < 1e11].tolist())), r


@pytest.mark.parametrize("Q,M,keep", [(70, 300, 0.85), (128, 512, 1.0),
                                      (33, 500, 0.5)])
def test_plain_knn_matches_jax(Q, M, keep):
    q, t, mask = _case(Q, Q, M, keep)
    d, i = tk.knn(torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(mask), 5)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    assert (np.diff(d.numpy(), axis=1) >= 0).all()
    _check(*jax_knn(q, t, mask, 5), d, i)
    _check(*knn_pallas(q, t, mask, k=5, chunk=128, tq=8, interpret=True), d, i)


def test_plain_knn_chunking_does_not_change_result():
    q, t, mask = _case(3, 64, 500, 0.8)
    args = (torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(mask), 5)
    d1, i1 = tk.knn_plain(*args, chunk=4096)
    d2, i2 = tk.knn_plain(*args, chunk=37)
    assert torch.equal(d1, d2) and torch.equal(i1, i2)


def test_fewer_than_k_valid_rows():
    q, t, _ = _case(4, 16, 40, 1.0)
    mask = np.zeros(40, bool)
    mask[[3, 17, 31]] = True
    d, i = tk.knn(torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(mask), 5)
    assert (d[:, 3:] == 1e12).all() and (i[:, 3:] == 0).all()
    assert (d[:, :3] < 1e11).all()
    assert set(i[0, :3].tolist()) == {3, 17, 31}
    _check(*jax_knn(q, t, mask, 5), d, i)
    _check(*knn_pallas(q, t, mask, k=5, chunk=8, tq=8, interpret=True), d, i)


def test_exact_ties_go_to_earliest_index():
    # bank rows 2, 5, 7, 9 and 12 coincide; the query sits on them
    rng = np.random.default_rng(5)
    t = rng.normal(size=(16, 3)).astype(np.float32) * 50
    t[[2, 5, 7, 9, 12]] = [1.0, 2.0, 3.0]
    q = np.array([[1.0, 2.0, 3.0]], np.float32)
    mask = np.ones(16, bool)
    mask[5] = False
    d, i = tk.knn(torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(mask), 3)
    assert i[0].tolist() == [2, 7, 9] and (d[0] == 0).all()
    d_ref, i_ref = jax_knn(q, t, mask, 3)
    assert np.asarray(i_ref)[0].tolist() == [2, 7, 9]
    d_p, i_p = knn_pallas(q, t, mask, k=3, chunk=8, tq=8, interpret=True)
    assert np.asarray(i_p)[0].tolist() == [2, 7, 9]
    # ties across chunk boundaries, too
    d2, i2 = tk.knn_plain(torch.from_numpy(q), torch.from_numpy(t),
                          torch.from_numpy(mask), 3, chunk=4)
    assert i2[0].tolist() == [2, 7, 9]


def test_center_recentring_at_world_scale():
    q, t, mask = _case(6, 100, 400, 0.9, scale=5.0, offset=1000.0)
    c = np.full(3, 1000.0, np.float32)
    tq, tt, tm, tc = (torch.from_numpy(x) for x in (q, t, mask, c))
    d, i = tk.knn(tq, tt, tm, 5, center=tc)
    d_ref, i_ref = jax_knn(q, t, mask, 5, center=c)
    _check(d_ref, i_ref, d, i)
    # recentring is exact for distances: same neighbours as the raw call
    d0, i0 = tk.knn(tq - tc, tt - tc, tm, 5)
    assert torch.equal(d, d0) and torch.equal(i, i0)


def test_nn1():
    q, t, mask = _case(7, 50, 200, 0.7)
    d, i = tk.nn1(torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(mask))
    d5, i5 = tk.knn(torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(mask), 5)
    assert torch.equal(d, d5[:, 0]) and torch.equal(i, i5[:, 0])


def test_cpu_tensors_take_the_plain_version():
    q, t, mask = _case(8, 8, 32, 1.0)
    before = tk.knn_plain_calls
    tk.knn(torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(mask), 5)
    assert tk.knn_plain_calls == before + 1


def test_cuda_wrapper_rejects_cpu_tensors():
    from lmono_tpu_torch.ops.cuda.knn import knn_cuda

    q, t, mask = _case(9, 8, 32, 1.0)
    with pytest.raises(ValueError):
        knn_cuda(torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(mask), 5)


# the odometry's shapes (kitti edge and plane, synthetic edge and plane),
# the loop lane's LiDAR refinement (edge and plane), ragged ones, and a
# bank smaller than a warp's share
LOOP_SHAPES = [(512, 512), (1024, 1024)]
PLAN_SHAPES = [(1536, 32768), (4096, 65536), (512, 8192), (1024, 16384), *LOOP_SHAPES,
               (777, 3001), (1, 1), (4097, 65537), (33, 70000)]


@pytest.mark.parametrize("Q,M", PLAN_SHAPES)
@pytest.mark.parametrize("sms", [132, 114])
def test_knn_plan_covers_the_bank_once(Q, M, sms):
    from lmono_tpu_torch.ops.cuda.knn import MAX_CLUSTER, QUERIES_PER_THREAD, knn_plan

    plan = knn_plan(Q, M, sms)
    assert 1 <= plan.cluster <= MAX_CLUSTER and plan.R in QUERIES_PER_THREAD
    assert plan.grid % plan.cluster == 0
    assert plan.grid == plan.q_tiles * plan.cluster
    assert plan.q_tiles * 32 * plan.R >= Q > (plan.q_tiles - 1) * 32 * plan.R
    covered = np.zeros(M, np.int64)
    prev_hi, prev = 0, (0, -1)
    for rank, warp, lo, hi in plan.slices(M):
        # ascending, contiguous ranges by rank, then by warp: the merge order
        assert (rank, warp) > prev and lo == prev_hi and hi >= lo
        covered[lo:hi] += 1
        prev_hi, prev = hi, (rank, warp)
    assert prev_hi == M and (covered == 1).all()


@pytest.mark.parametrize("Q,M", LOOP_SHAPES)
@pytest.mark.parametrize("sms", [132, 114])
def test_knn_plan_gives_every_rank_and_warp_rows_at_the_loop_shapes(Q, M, sms):
    # the refinement's small banks: one CTA per cluster, and no warp slice
    # empty or cut short
    from lmono_tpu_torch.ops.cuda.knn import knn_plan

    plan = knn_plan(Q, M, sms)
    assert plan.cluster == 1 and plan.span * plan.warps == M
    sl = plan.slices(M)
    assert len(sl) == plan.cluster * plan.warps
    assert all(hi - lo == plan.span for _, _, lo, hi in sl)
    assert sl[0][2] == 0 and sl[-1][3] == M


def test_knn_plan_at_the_main_path_shapes():
    # on an H100 (132 SMs), the plans the card measured best: full clusters
    # at kitti scale, two queries a thread where that still fills the card
    from lmono_tpu_torch.ops.cuda.knn import knn_plan

    assert knn_plan(4096, 65536, 132)[:3] == (2, 8, 8)
    assert knn_plan(1536, 32768, 132)[:3] == (1, 8, 8)
    assert knn_plan(1024, 16384, 132)[:3] == (2, 8, 8)
    assert knn_plan(512, 8192, 132)[:3] == (1, 8, 4)
    for Q, M in PLAN_SHAPES:
        plan = knn_plan(Q, M, 132)
        assert plan.grid >= min(132, plan.q_tiles * plan.cluster)
    with pytest.raises(ValueError):
        knn_plan(0, 10, 132)


def _tie_case(Q, M, dev):
    """Bank points duplicated across the warp slices and cluster ranks of
    the kernel's plan, with queries sitting on them: index lists must match
    the plain version's exactly."""
    from lmono_tpu_torch.ops.cuda.knn import _sms, knn_plan

    rng = np.random.default_rng(11)
    t = (rng.normal(size=(M, 3)) * 30.0 + 100.0).astype(np.float32)
    plan = knn_plan(Q, M, _sms(dev))
    bounds = sorted({lo for _, _, lo, _ in plan.slices(M) if 0 < lo < M})
    # copies of one point on both sides of each boundary
    for g, b in enumerate(bounds[:12]):
        src = t[(37 * g) % M].copy()
        for j in (b - 2, b - 1, b, b + 1):
            if 0 <= j < M:
                t[j] = src
    q = t[(37 * np.arange(Q)) % M].copy()
    mask = np.ones(M, bool)
    mask[bounds[:12:3]] = False
    return q, t, mask


@pytest.mark.gpu
@pytest.mark.parametrize("Q,M", [(1536, 32768), (300, 5000)])
def test_cuda_kernel_keeps_the_earliest_index_on_ties(Q, M):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    q, t, mask = _tie_case(Q, M, dev)
    args = [torch.from_numpy(x).to(dev) for x in (q, t, mask)]
    d, i = tk.knn(*args, 5)
    d_p, i_p = tk.knn_plain(*args, 5)
    assert torch.equal(i.cpu(), i_p.cpu())
    torch.testing.assert_close(d.cpu(), d_p.cpu(), rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
def test_cuda_kernel_recentres_in_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lmono_tpu_torch.ops.cuda import knn as ck

    q, t, mask = _case(12, 1536, 32768, 0.9, scale=20.0, offset=1000.0)
    dev = torch.device("cuda")
    tq, tt, tm = (torch.from_numpy(x).to(dev) for x in (q, t, mask))
    c = torch.tensor([1000.0, 990.0, 1010.0], device=dev)
    before = ck.knn_kernel_launches
    d, i = tk.knn(tq, tt, tm, 5, center=c)
    assert ck.knn_kernel_launches == before + 1
    # the same f32 rounding as subtracting the centre with torch first
    d0, i0 = tk.knn(tq - c, tt - c, tm, 5)
    assert torch.equal(d, d0) and torch.equal(i, i0)
    d_p, i_p = tk.knn_plain(tq - c, tt - c, tm, 5)
    torch.testing.assert_close(d.cpu(), d_p.cpu(), rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("Q,M,keep", [(1536, 32768, 0.9), (777, 3001, 0.001),
                                      (4096, 65536, 0.9), (512, 8192, 0.9)])
def test_cuda_kernel_matches_plain(Q, M, keep):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lmono_tpu_torch.ops.cuda import knn as ck

    q, t, mask = _case(10, Q, M, keep, scale=20.0, offset=100.0)
    dev = torch.device("cuda")
    args = [torch.from_numpy(x).to(dev) for x in (q, t, mask)]
    before = ck.knn_kernel_launches
    d, i = tk.knn(*args, 5)
    assert ck.knn_kernel_launches == before + 1
    d_p, i_p = tk.knn_plain(*args, 6)
    d, i, d_p, i_p = (x.cpu() for x in (d, i, d_p, i_p))
    torch.testing.assert_close(d, d_p[:, :5], rtol=1e-5, atol=1e-4)
    gap = (d_p[:, 5] - d_p[:, 4]) > 1e-4
    found = d < 1e11
    sk = torch.sort(torch.where(found, i, -1), 1).values[gap]
    sp = torch.sort(torch.where(found, i_p[:, :5], -1), 1).values[gap]
    assert torch.equal(sk, sp)


# --------------------------------------------------------------------------
# Reduced-precision selection (`select` "bf16x3" / "bf16"): the JAX package
# reads LidarConfig.knn_select only on its TPU route, so the reference is
# that route on the CPU (`jax.default_backend` patched to "tpu"), where
# `approx_min_k` is exact with ties to the lower index.
#
# Tolerances.  Both sides select on the f32 key (q² − 2·q·t) + t² over the
# recentred coordinates (the cross term over bf16-rounded ones for "bf16"),
# but the reference forms the dot and the squared norms in XLA's order, so
# two keys may differ by a few roundings: KEY_ULPS · 2⁻²³ · (|q| + |t|)²
# bounds that (it covers 2⁻²³·(q² + 2|q||t| + t²) for each of the ~8
# roundings on either side).  Where every gap between a row's k+1 smallest
# keys exceeds it, the index lists must be equal and the d² within 1e-6
# relative (both exact difference forms); elsewhere each position's keys
# must agree within it.  Missing entries: d² 1e12 on both sides; the
# reference's index is whichever masked row `approx_min_k` picks, the
# port's 0, so indices are compared only where d² < 1e12.
# --------------------------------------------------------------------------

KEY_ULPS = 16
SEL_RTOL = 1e-6


@pytest.fixture
def jax_tpu_route(monkeypatch):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


def _jax_select(q, t, mask, k, center, select):
    import jax
    import jax.numpy as jnp

    kw = ({"select_dtype": jnp.bfloat16} if select == "bf16"
          else {"select_precision": jax.lax.Precision.HIGH})
    d, i = jax_knn(jnp.asarray(q), jnp.asarray(t), jnp.asarray(mask), k,
                   center=jnp.asarray(center), **kw)
    return np.asarray(d), np.asarray(i)


def _keys64(q, t, center, select):
    """The selection key of every pair in float64 from the f32-recentred
    (and, for "bf16", bf16-rounded) coordinates: (Q, M)."""
    qc = torch.from_numpy(q) - torch.from_numpy(center)
    tc = torch.from_numpy(t) - torch.from_numpy(center)
    qs, ts = qc, tc
    if select == "bf16":
        qs, ts = (x.to(torch.bfloat16).float() for x in (qc, tc))
    qc, tc, qs, ts = (x.double().numpy() for x in (qc, tc, qs, ts))
    key = ((qc * qc).sum(1)[:, None] - 2.0 * qs @ ts.T + (tc * tc).sum(1)[None, :])
    bound = (KEY_ULPS * 2.0 ** -23
             * (np.linalg.norm(qc, axis=1)[:, None] + np.linalg.norm(tc, axis=1).max()) ** 2)
    return key, bound[:, 0]


def _check_select(q, t, mask, center, select, d_ref, i_ref, d, i, k=5):
    d, i = d.numpy(), i.numpy().astype(np.int64)
    key, bound = _keys64(q, t, center, select)
    key = np.where(mask[None, :], key, np.inf)
    kth = np.sort(key, axis=1)[:, :k + 1]
    found, found_ref = d < 1e11, d_ref < 1e11
    np.testing.assert_array_equal(found, found_ref)
    assert (d[~found] == np.float32(1e12)).all() and (i[~found] == 0).all()
    assert (d_ref[~found_ref] == np.float32(1e12)).all()
    with np.errstate(invalid="ignore"):
        safe = (~np.isfinite(kth[:, 1:])
                | (np.diff(kth, axis=1) > bound[:, None])).all(axis=1)
    rows = np.arange(len(q))[:, None]
    for side, (dd, ii) in (("port", (d, i)), ("reference", (d_ref, i_ref))):
        # every pick's key sits at its rank's key, within the bound
        pk = np.where(dd < 1e11, key[rows, ii], np.inf)
        gap = np.abs(np.where(np.isfinite(pk), pk - kth[:, :k], 0.0))
        assert (gap <= bound[:, None]).all(), side
    same = (i == i_ref) & found
    np.testing.assert_allclose(d[same], d_ref[same], rtol=SEL_RTOL, atol=1e-9)
    assert (same | ~found)[safe].all()
    return safe.mean()


SELECT_CASES = {
    # world-scale coordinates recentred, every row valid
    "centred": dict(scale=10.0, offset=1000.0, keep=1.0),
    # about a third of the bank masked
    "masked": dict(scale=10.0, offset=100.0, keep=0.65),
    # three valid rows for k = 5
    "fewer_than_k": dict(scale=10.0, offset=100.0, keep=None),
}


def _select_case(name, Q=150, M=700):
    kw = SELECT_CASES[name]
    q, t, mask = _case(21 + len(name), Q, M, kw["keep"] or 1.0, kw["scale"], kw["offset"])
    if kw["keep"] is None:
        mask = np.zeros(M, bool)
        mask[[5, 300, 611]] = True
    center = np.full(3, kw["offset"], np.float32) + np.array([0.5, -0.25, 0.125], np.float32)
    return q, t, mask, center


@pytest.mark.parametrize("case", list(SELECT_CASES))
@pytest.mark.parametrize("select", ["bf16x3", "bf16"])
def test_select_matches_the_jax_tpu_route(jax_tpu_route, select, case):
    q, t, mask, center = _select_case(case)
    d_ref, i_ref = _jax_select(q, t, mask, 5, center, select)
    d, i = tk.knn(*(torch.from_numpy(x) for x in (q, t, mask)), 5,
                  center=torch.from_numpy(center), select=select)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    safe = _check_select(q, t, mask, center, select, d_ref, i_ref, d, i)
    assert safe > 0.9
    if case == "fewer_than_k":
        assert (d[:, 3:] == 1e12).all() and (d[:, :3] < 1e11).all()
        assert set(i[0, :3].tolist()) == {5, 300, 611}


def test_bf16_select_returns_selection_order():
    # the bf16 key misorders near neighbours: d² is not re-sorted
    q, t, mask, center = _select_case("masked")
    args = [torch.from_numpy(x) for x in (q, t, mask)]
    d, i = tk.knn(*args, 5, center=torch.from_numpy(center), select="bf16")
    key, _ = _keys64(q, t, center, "bf16")
    picked = key[np.arange(len(q))[:, None], i.numpy()]
    assert (np.diff(picked, axis=1) >= 0).all()
    assert (np.diff(d.numpy(), axis=1) < 0).any()


def test_select_plain_chunking_and_counts():
    q, t, mask, center = _select_case("masked", Q=64, M=500)
    c = torch.from_numpy(center)
    args = [torch.from_numpy(q) - c, torch.from_numpy(t) - c, torch.from_numpy(mask)]
    for select in ("bf16x3", "bf16"):
        d1, i1 = tk.knn_select_plain(*args, 5, select, chunk=4096)
        d2, i2 = tk.knn_select_plain(*args, 5, select, chunk=37)
        assert torch.equal(d1, d2) and torch.equal(i1, i2)
    before = tk.knn_plain_calls
    tk.knn(*[torch.from_numpy(x) for x in (q, t, mask)], 5, select="bf16x3")
    assert tk.knn_plain_calls == before + 1


def test_unknown_select_raises():
    q, t, mask = _case(30, 8, 32, 1.0)
    args = [torch.from_numpy(x) for x in (q, t, mask)]
    for select in ("fp16", "EXACT", None):
        with pytest.raises(ValueError):
            tk.knn(*args, 5, select=select)


@pytest.mark.gpu
@pytest.mark.parametrize("select", ["bf16x3", "bf16"])
@pytest.mark.parametrize("Q,M,keep", [(1536, 32768, 0.9), (777, 3001, 0.001),
                                      (4096, 65536, 0.9), (512, 512, 0.9)])
def test_cuda_select_matches_plain(select, Q, M, keep):
    # the kernel forms the plain version's keys bit for bit: equal index
    # lists; d² within 1e-6 relative (fused multiply-adds in the kernel's
    # difference form)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lmono_tpu_torch.ops.cuda import knn as ck

    q, t, mask = _case(40, Q, M, keep, scale=20.0, offset=1000.0)
    dev = torch.device("cuda")
    tq, tt, tm = (torch.from_numpy(x).to(dev) for x in (q, t, mask))
    c = torch.tensor([1000.0, 990.0, 1010.0], device=dev)
    before = ck.knn_kernel_launches
    d, i = tk.knn(tq, tt, tm, 5, center=c, select=select)
    assert ck.knn_kernel_launches == before + 1
    d_p, i_p = tk.knn_select_plain(tq - c, tt - c, tm, 5, select)
    assert torch.equal(i.cpu(), i_p.cpu())
    torch.testing.assert_close(d.cpu(), d_p.cpu(), rtol=1e-6, atol=1e-9)
