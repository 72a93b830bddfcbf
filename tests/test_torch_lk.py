"""Lucas–Kanade of the port (`lmono_tpu_torch.ops.lk`) against the JAX
package's two routes, on the same numpy inputs:

* `lk_level_plain(pallas=True)` against the Pallas kernel
  `lmono_tpu.ops.pallas.lk.lk_level_pallas` in interpret mode (as
  `tests/test_pallas_lk.py` runs it);
* `lk_level_plain(pallas=False)` against the vmapped `lmono_tpu.ops.lk.lk_level`;
* `track_fb_plain` against the JAX package's TPU route (Pallas on levels at
  least 128 px wide, vmapped below), with `jax.default_backend` patched to
  "tpu" and the Pallas kernel to interpret mode.

Tolerances: pt1 within 1e-3 px where both are ok; ok equal except on rows
within 1e-4 of a gate (the last step against its threshold, det against
1e-6, the position against the border), which are printed.  The cases hold
features near all four borders, a flat patch (det = 0), a diverging slot and
non-finite guesses (XLA's float→int rule).  The `gpu` tests hold the CUDA
kernel to the plain versions on the card: one level with the same
tolerances, and the fused forward-backward `track_fb` against
`track_fb_plain` with ok equal on at least 99% of slots and pts1 within
1e-3 px where both are ok.  They run on a host without JAX:
    python -m pytest tests/test_torch_lk.py -m gpu --noconftest
"""

import functools

import numpy as np
import pytest
import torch

from lmono_tpu_torch.ops import image as tim
from lmono_tpu_torch.ops import lk as tlk

PATCH, ITERS, EPS = 15, 10, 0.01
PX_ATOL = 1e-3
GATE_TOL = 1e-4
FLOW = (1.37, -0.61)        # img1(x) = img0(x + FLOW): LK finds -FLOW
FLAT = PATCH + 6            # side of the flat top-right corner of img0


def _scene(seed, H, W):
    """(img0, ix0, iy0, img1) as float32 numpy: a smooth random texture
    with a flat corner, shifted by FLOW.  Built with the port's ops."""
    rng = np.random.default_rng(seed)
    base = torch.from_numpy(rng.normal(size=(H // 6 + 2, W // 6 + 2)).astype(np.float32))
    img = torch.nn.functional.interpolate(base[None, None], size=(H, W),
                                          mode="bicubic", align_corners=False)[0, 0]
    img = (img - img.min()) / (img.max() - img.min())
    img[:FLAT, -FLAT:] = 0.5
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32), indexing="ij")
    img1 = tim.bilinear_sample(img, torch.stack([xx + FLOW[0], yy + FLOW[1]], -1))
    ix, iy = tim.scharr_gradients(img)
    return tuple(x.numpy() for x in (img, ix, iy, img1))


def _points(seed, H, W, n=40):
    """(pts0, guess) (n, 2) float32: random slots, the four corners, slots a
    few px from each border, the flat patch, a diverging guess and
    non-finite guesses."""
    rng = np.random.default_rng(seed)
    pts = (rng.random((n, 2)) * [W - 1, H - 1]).astype(np.float32)
    pts[:10] = [[0.5, 0.5], [W - 1.5, 0.5], [0.5, H - 1.5], [W - 1.5, H - 1.5],
                [3.2, H / 2], [W - 4.3, H / 3], [W / 2, 2.7], [W / 3, H - 3.6],
                [W - FLAT / 2, FLAT / 2], [W / 2, H / 2]]
    guess = pts.copy()
    guess[9] += [9.0, -7.0]                                 # diverges
    guess[10:13] = [[np.nan, 5.0], [1e10, H / 2], [W / 2, -1e10]]
    return pts, guess


def _gates(args, pallas):
    """det and last step of every slot (the port's plain version), for
    telling rows near a gate."""
    img0, ix0, iy0, img1, pts0, guess = args
    if pallas:
        gx = tlk._slab_patches(ix0, pts0[:, 0], pts0[:, 1], PATCH).flatten(1)
        gy = tlk._slab_patches(iy0, pts0[:, 0], pts0[:, 1], PATCH).flatten(1)
    else:
        c0 = pts0[:, None, :] + tlk._patch_offsets(PATCH, pts0.device)
        gx, gy = tim.bilinear_sample(ix0, c0), tim.bilinear_sample(iy0, c0)
    gxx, gxy, gyy = (gx * gx).sum(1), (gx * gy).sum(1), (gy * gy).sum(1)
    det = gxx * gyy - gxy * gxy
    p_prev, _ = tlk.lk_level_plain(*args, PATCH, ITERS - 1, pallas, EPS)
    p_last, _ = tlk.lk_level_plain(*args, PATCH, ITERS, pallas, EPS)
    step = torch.linalg.norm(p_last - p_prev, dim=-1)
    return det.cpu().numpy(), step.cpu().numpy(), p_last.cpu().numpy()


def _check(p_ref, ok_ref, p, ok, args, pallas):
    """pt1 within PX_ATOL where both are ok; ok equal off the gates."""
    p_ref, ok_ref = np.asarray(p_ref), np.asarray(ok_ref)
    p, ok = np.asarray(p), np.asarray(ok)
    both = ok_ref & ok
    assert both.sum() >= len(ok) // 2
    np.testing.assert_allclose(p[both], p_ref[both], rtol=0, atol=PX_ATOL)
    det, step, last = _gates(args, pallas)
    H, W = args[0].shape
    thresh = 0.1 if pallas else 10 * EPS
    near = (np.abs(step - thresh) < GATE_TOL) | (np.abs(det - 1e-6) < GATE_TOL)
    if pallas:
        x, y = last[:, 0], last[:, 1]
        edge = np.min(np.abs(np.stack([x - 1, x - (W - 2), y - 1, y - (H - 2)])), 0)
        near |= edge < GATE_TOL
    for k in np.flatnonzero(ok != ok_ref):
        print(f"ok differs at row {k}: det {det[k]}, step {step[k]}, pt {last[k]}")
        assert near[k], k
    return det


def _torch(*arrays, device="cpu"):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


@pytest.mark.parametrize("H,W", [(64, 128), (40, 155)])
def test_plain_matches_the_pallas_kernel(H, W):
    from lmono_tpu.ops.pallas.lk import lk_level_pallas

    img = _scene(H + W, H, W)
    pts, guess = _points(H, H, W)
    p_ref, ok_ref = lk_level_pallas(*img, pts, guess, patch=PATCH, iters=ITERS,
                                    interpret=True)
    args = _torch(*img, pts, guess)
    p, ok = tlk.lk_level_plain(*args, PATCH, ITERS, pallas=True)
    det = _check(p_ref, ok_ref, p.numpy(), ok.numpy(), args, True)
    # the flat patch: det is 0 and the slot is not ok on either side
    assert det[8] == 0.0 and not np.asarray(ok_ref)[8] and not ok[8]
    # borders: the clamped slab extrapolates and the slots stay in lockstep
    np.testing.assert_allclose(p.numpy()[:4], np.asarray(p_ref)[:4], atol=PX_ATOL)
    # the NaN guess reads slab 0 on both sides (XLA's NaN → 0) and stays NaN
    assert np.isnan(np.asarray(p_ref)[10, 0]) and np.isnan(p.numpy()[10, 0])


@pytest.mark.parametrize("H,W", [(32, 64), (40, 155)])
def test_plain_matches_the_vmapped_reference(H, W):
    import jax
    import jax.numpy as jnp

    from lmono_tpu.ops.lk import lk_level

    img = _scene(H * W, H, W)
    pts, guess = _points(W, H, W)
    jimg = [jnp.asarray(x) for x in img]
    f = jax.vmap(lambda p0, g: lk_level(*jimg, p0, g, PATCH, ITERS, EPS))
    p_ref, ok_ref, _ = f(pts, guess)
    args = _torch(*img, pts, guess)
    p, ok = tlk.lk_level_plain(*args, PATCH, ITERS, pallas=False, eps=EPS)
    det = _check(p_ref, ok_ref, p.numpy(), ok.numpy(), args, False)
    assert det[8] == 0.0 and not np.asarray(ok_ref)[8] and not ok[8]
    # the inverse is zero off the gate, so the flat slot does not move
    np.testing.assert_array_equal(p.numpy()[8], guess[8])


def test_the_two_semantics_part_only_near_borders():
    # the reference's CPU route (vmapped) and TPU route (Pallas) agree on
    # slots whose patch lies inside the level and part near its border, in
    # position and in ok: where their trackers begin to diverge
    H, W = 64, 128
    img = _scene(3, H, W)
    pts, _ = _points(3, H, W)
    args = _torch(*img, pts, pts.copy())
    pa, oa = tlk.lk_level_plain(*args, PATCH, ITERS, pallas=True)
    px, ox = tlk.lk_level_plain(*args, PATCH, ITERS, pallas=False)
    d = torch.linalg.norm(pa - px, dim=-1).numpy()
    both, oa, ox = (oa & ox).numpy(), oa.numpy(), ox.numpy()
    r = PATCH // 2 + 3
    inner = ((pts[:, 0] > r) & (pts[:, 0] < W - 1 - r)
             & (pts[:, 1] > r) & (pts[:, 1] < H - 1 - r))
    assert (inner & both).sum() >= 15
    assert d[inner & both].max() < PX_ATOL
    assert (oa == ox)[inner].all()
    assert d[~inner & both].max() > 0.1
    assert (oa != ox)[~inner].any()


def _pyramids(seed, H=128, W=256, levels=3):
    """Two pyramids and their gradients (numpy), img1 = img0 moved by FLOW."""
    img0, _, _, img1 = _scene(seed, H, W)
    out = []
    for img in (img0, img1):
        pyr = tim.build_pyramid(torch.from_numpy(img), levels)
        out.append(([p.numpy() for p in pyr],
                    [tuple(g.numpy() for g in tim.scharr_gradients(p)) for p in pyr]))
    return out


@pytest.fixture
def jax_tpu_route(monkeypatch):
    """The JAX package's TPU route on the CPU: Pallas LK in interpret mode."""
    import jax

    import lmono_tpu.ops.pallas.lk as plk

    monkeypatch.setattr(plk, "lk_level_pallas",
                        functools.partial(plk.lk_level_pallas, interpret=True))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


def test_track_fb_matches_the_tpu_route(jax_tpu_route):
    # 256, 128 and 64 px wide levels: the Pallas semantics on the first two,
    # the vmapped one on the last, as the reference picks them
    import jax.numpy as jnp

    from lmono_tpu.ops.lk import track_fb as jtrack_fb

    (pyr0, g0), (pyr1, g1) = _pyramids(7)
    rng = np.random.default_rng(8)
    pts = (rng.random((48, 2)) * [255, 127]).astype(np.float32)
    pts[:4] = [[2.0, 2.0], [253.0, 3.0], [1.5, 125.0], [250.0, 124.0]]
    mask = rng.random(48) < 0.9
    def jj(xs):
        return [jnp.asarray(x) for x in xs]

    p_ref, ok_ref = jtrack_fb(jj(pyr0), [tuple(jj(g)) for g in g0], jj(pyr1),
                              [tuple(jj(g)) for g in g1], jnp.asarray(pts),
                              jnp.asarray(mask), patch=PATCH, iters=ITERS,
                              eps=EPS, fb_thresh=0.5)

    def tt(xs):
        return [torch.from_numpy(x) for x in xs]

    args = (tt(pyr0), [tuple(tt(g)) for g in g0], tt(pyr1),
            [tuple(tt(g)) for g in g1], torch.from_numpy(pts),
            torch.from_numpy(mask))
    calls = tlk.lk_plain_calls
    p, ok = tlk.track_fb_plain(*args, patch=PATCH, iters=ITERS, eps=EPS,
                               fb_thresh=0.5)
    assert tlk.lk_plain_calls == calls + 2 * len(pyr0)
    # on CPU tensors track_fb is the plain version
    p2, ok2 = tlk.track_fb(*args, patch=PATCH, iters=ITERS, eps=EPS, fb_thresh=0.5)
    assert torch.equal(ok2, ok) and torch.equal(p2, p)
    p_ref, ok_ref = np.asarray(p_ref), np.asarray(ok_ref)
    assert ok_ref.sum() >= 30
    np.testing.assert_array_equal(ok.numpy(), ok_ref)
    np.testing.assert_allclose(p.numpy()[ok_ref], p_ref[ok_ref], rtol=0, atol=PX_ATOL)
    flow = (p.numpy() - pts)[ok_ref]
    np.testing.assert_allclose(np.median(flow, 0), [-FLOW[0], -FLOW[1]], atol=0.05)


def test_semantics_follow_the_level_width():
    (pyr0, g0), (pyr1, _) = _pyramids(9, H=64, W=256, levels=2)
    seen = []
    orig = tlk.lk_level_plain

    def spy(*args, pallas, eps):
        seen.append((args[0].shape[1], pallas))
        return orig(*args, pallas=pallas, eps=eps)

    tlk.lk_level_plain = spy
    try:
        tlk.track_pyramid_plain([torch.from_numpy(p) for p in pyr0],
                                [tuple(torch.from_numpy(x) for x in g) for g in g0],
                                [torch.from_numpy(p) for p in pyr1],
                                torch.full((4, 2), 30.0),
                                torch.ones(4, dtype=torch.bool), PATCH, ITERS, EPS)
    finally:
        tlk.lk_level_plain = orig
    assert seen == [(128, True), (256, True)]
    assert tlk.PALLAS_MIN_WIDTH == 128


@pytest.mark.parametrize("shapes,pallas", [
    ([(376, 1241), (188, 620), (94, 310), (47, 155)], [True] * 4),
    ([(256, 512), (128, 256), (64, 128)], [True] * 3),
    ([(128, 256), (64, 128), (32, 64)], [True, True, False]),
    ([(40, 127)], [False]),
])
def test_level_table_follows_the_pyramid_rule(shapes, pallas):
    # the table the CUDA wrapper hands the kernel: shape, semantics by the
    # level's width as track_pyramid_plain picks it, and an exact 2^-level scale
    table = tlk.level_table(shapes, 21)
    assert [(t.H, t.W) for t in table] == shapes
    assert [t.pallas for t in table] == pallas
    assert [t.pallas for t in table] == [W >= tlk.PALLAS_MIN_WIDTH for _, W in shapes]
    pts = torch.tensor([[1241.0 / 3, 376.0 / 7], [0.1, 1e-30]])
    for lvl, t in enumerate(table):
        assert t.scale == 2.0 ** -lvl
        assert torch.equal(pts * t.scale, pts / 2.0 ** lvl)


def test_level_table_rejects_levels_too_small_for_the_patch():
    # a TPU-semantics level needs (P+1)² pixels for its slab
    with pytest.raises(ValueError):
        tlk.level_table([(21, 256)], 21)
    with pytest.raises(ValueError):
        tlk.track_pyramid_plain([torch.zeros(21, 256)], [(torch.zeros(21, 256),) * 2],
                                [torch.zeros(21, 256)], torch.zeros(1, 2),
                                torch.ones(1, dtype=torch.bool), 21, 10, 0.01)
    assert [t.pallas for t in tlk.level_table([(22, 256), (11, 100)], 21)] == [True, False]


def test_cpu_tensors_take_the_plain_version():
    # track_fb on CPU tensors is track_fb_plain: one lk_level_plain call per
    # level and direction, the same bits
    (pyr0, g0), (pyr1, g1) = _pyramids(1, H=64, W=256, levels=2)
    args = ([torch.from_numpy(p) for p in pyr0],
            [tuple(torch.from_numpy(x) for x in g) for g in g0],
            [torch.from_numpy(p) for p in pyr1],
            [tuple(torch.from_numpy(x) for x in g) for g in g1],
            torch.from_numpy(_points(1, 64, 256, n=16)[0]),
            torch.ones(16, dtype=torch.bool))
    calls = tlk.lk_plain_calls
    a = tlk.track_fb(*args, patch=PATCH, iters=ITERS, eps=EPS)
    assert tlk.lk_plain_calls == calls + 4
    b = tlk.track_fb_plain(*args, patch=PATCH, iters=ITERS, eps=EPS)
    assert torch.equal(a[1], b[1])
    torch.testing.assert_close(a[0], b[0], equal_nan=True, rtol=0, atol=0)


def test_cuda_wrapper_rejects_cpu_tensors():
    from lmono_tpu_torch.ops.cuda.lk import lk_level_cuda, track_fb_cuda

    args = _torch(*_scene(2, 32, 48), *_points(2, 32, 48, n=16))
    with pytest.raises(ValueError):
        lk_level_cuda(*args, PATCH, ITERS, True, 0.1)
    img0, ix0, iy0, img1, pts, _ = args
    with pytest.raises(ValueError):
        track_fb_cuda([img0], [(ix0, iy0)], [img1], [(ix0, iy0)], pts,
                      torch.ones(16, dtype=torch.bool), PATCH, ITERS, EPS)


@pytest.mark.gpu
@pytest.mark.parametrize("pallas", [True, False])
@pytest.mark.parametrize("H,W,n", [(376, 1241, 150), (47, 155, 150)])
def test_cuda_kernel_matches_plain(pallas, H, W, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lmono_tpu_torch.ops.cuda import lk as ck

    dev = torch.device("cuda")
    args = _torch(*_scene(H, H, W), *_points(W, H, W, n=n), device=dev)
    before = ck.lk_kernel_launches
    p, ok = ck.lk_level_cuda(*args, PATCH, ITERS, pallas,
                             tlk._PALLAS_STEP_THRESH if pallas else 10 * EPS)
    assert ck.lk_kernel_launches == before + 1
    p_p, ok_p = tlk.lk_level_plain(*args, PATCH, ITERS, pallas, EPS)
    _check(p_p.cpu().numpy(), ok_p.cpu().numpy(), p.cpu().numpy(),
           ok.cpu().numpy(), args, pallas)
    assert not ok[8]


@pytest.mark.gpu
@pytest.mark.parametrize("H,W,levels,n", [(376, 1241, 4, 150), (256, 512, 3, 96),
                                          (128, 256, 3, 48)])
def test_fused_track_fb_matches_plain(H, W, levels, n):
    # one launch for every level and both directions; the last case mixes
    # the two semantics (a 64 px level) inside the launch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lmono_tpu_torch.ops.cuda import lk as ck

    dev = torch.device("cuda")
    (pyr0, g0), (pyr1, g1) = _pyramids(H + levels, H=H, W=W, levels=levels)
    rng = np.random.default_rng(n)
    pts = (rng.random((n, 2)) * [W - 1, H - 1]).astype(np.float32)
    pts[:4] = [[2.0, 2.0], [W - 3.0, 3.0], [1.5, H - 3.0], [W - 6.0, H - 4.0]]
    mask = rng.random(n) < 0.9

    def cuda(xs):
        return [torch.from_numpy(x).to(dev) for x in xs]

    args = (cuda(pyr0), [tuple(cuda(g)) for g in g0], cuda(pyr1),
            [tuple(cuda(g)) for g in g1], torch.from_numpy(pts).to(dev),
            torch.from_numpy(mask).to(dev))
    before, calls = ck.lk_kernel_launches, tlk.lk_plain_calls
    p, ok = tlk.track_fb(*args, patch=PATCH, iters=ITERS, eps=EPS)
    assert ck.lk_kernel_launches == before + 1 and tlk.lk_plain_calls == calls
    p_p, ok_p = tlk.track_fb_plain(*args, patch=PATCH, iters=ITERS, eps=EPS)
    p, ok, p_p, ok_p = (x.cpu() for x in (p, ok, p_p, ok_p))
    assert (ok == ok_p).float().mean() >= 0.99
    both = ok & ok_p
    assert both.sum() >= n // 3
    torch.testing.assert_close(p[both], p_p[both], rtol=0, atol=PX_ATOL)
