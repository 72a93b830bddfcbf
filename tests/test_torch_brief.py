"""The port's BRIEF descriptors, vocabulary and keyframe DB
(`lmono_tpu_torch.ops.brief`, `loop.keyframe_db`) against `lmono_tpu`'s, on
the same numpy inputs (a 256×128 render of the JAX simulator's city, its
Shi–Tomasi corners, and descriptor sets built from it).

Tolerances:
* descriptors equal, except comparisons whose two blurred samples lie
  within 1e-5 relative of each other in the reference (the blur sums in
  another order); packed bits and Hamming distances exact (±1 dots are
  exact in f32 with TF32 off); matches equal;
* `global_descriptor` within 1e-6; `db_query` scores within 1e-5 and the
  top-4 slots equal (ties: the lower slot first, as `lax.top_k`);
* the vocabulary assets byte for byte the JAX package's (sha256).
"""

import dataclasses
import functools
import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmono_tpu.config import synthetic_config
from lmono_tpu.io import synthetic as jsyn
from lmono_tpu.loop import keyframe_db as jdb
from lmono_tpu.ops import brief as jbr
from lmono_tpu.ops import image as jim
from lmono_tpu.ops.corners import detect_grid as j_detect
from lmono_tpu.utils.lie import Pose as JPose
from lmono_tpu_torch.convert import keyframe_db_from_numpy
from lmono_tpu_torch.loop import keyframe_db as tdb
from lmono_tpu_torch.ops import brief as tbr

CFG = synthetic_config()
LOOP = dataclasses.replace(CFG.loop, db_capacity=16, max_keypoints=64,
                           window_points=24, search_gap=2, search_time=0.5,
                           kf_edge_points=32, kf_planar_points=48)
CAM = dataclasses.replace(CFG.camera, width=256, height=128, fx=128.0, fy=128.0,
                          cx=128.0, cy=64.0)
TIE_REL = 1e-5


@functools.lru_cache(maxsize=None)
def _images(n=6):
    scene = jsyn.make_city_scene()
    traj = jsyn.circuit_trajectory(3 * n)
    T_LC = jsyn.synthetic_T_CL().inverse()
    render = jax.jit(lambda p: jsyn.render_camera(scene, p, CAM))
    return [np.array(render(JPose(traj.t[3 * i], traj.q[3 * i]).compose(T_LC)))
            for i in range(n)]


@functools.lru_cache(maxsize=None)
def _keypoints(i):
    img = jnp.asarray(_images()[i])
    uv, ok = jax.jit(lambda im: j_detect(im, 8, LOOP.max_keypoints, jnp.zeros((1, 2)),
                                         jnp.zeros((1,), bool)))(img)
    return np.array(uv), np.array(ok)


def _tie_margin(img, kps, angle=None):
    """The reference's |i1 − i2| / max(|i1|, |i2|) of every comparison."""
    sm = jim.gauss_blur5(jim.gauss_blur5(jnp.asarray(img)))
    pat = jnp.asarray(jbr.brief_pattern())
    o1, o2 = pat[None, :, :2], pat[None, :, 2:]
    if angle is not None:
        ca, sa = jnp.cos(angle)[:, None], jnp.sin(angle)[:, None]
        rot = lambda o: jnp.stack([ca * o[..., 0] - sa * o[..., 1],
                                   sa * o[..., 0] + ca * o[..., 1]], -1)
        o1, o2 = rot(o1), rot(o2)
    i1 = np.asarray(jim.bilinear_sample(sm, jnp.asarray(kps)[:, None] + o1))
    i2 = np.asarray(jim.bilinear_sample(sm, jnp.asarray(kps)[:, None] + o2))
    return np.abs(i1 - i2) / np.maximum(np.maximum(np.abs(i1), np.abs(i2)), 1e-30)


@pytest.mark.parametrize("orb", [False, True])
def test_brief_describe_matches(orb):
    img = _images()[0]
    kps, ok = _keypoints(0)
    ang = np.asarray(jbr.patch_orientation(jnp.asarray(img), jnp.asarray(kps))) if orb else None
    a = np.asarray(jbr.brief_describe(jnp.asarray(img), jnp.asarray(kps), jnp.asarray(ok),
                                      None if ang is None else jnp.asarray(ang)))
    if orb:
        t_ang = tbr.patch_orientation(torch.from_numpy(img), torch.from_numpy(kps))
        np.testing.assert_allclose(t_ang.numpy(), ang, rtol=0, atol=1e-4)
    b = tbr.brief_describe(torch.from_numpy(img), torch.from_numpy(kps), torch.from_numpy(ok),
                           None if ang is None else torch.from_numpy(ang)).numpy()
    assert b.dtype == np.int8 and ok.sum() > 20
    near = _tie_margin(img, kps, None if ang is None else jnp.asarray(ang)) < TIE_REL
    near &= ok[:, None]
    np.testing.assert_array_equal(b[~near], a[~near])
    # packing of the reference's descriptors, and back
    pa = np.asarray(jbr.pack_bits(jnp.asarray(a)))
    pb = tbr.pack_bits(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(pb, pa)
    np.testing.assert_array_equal(tbr.unpack_bits(torch.from_numpy(pa)).numpy(),
                                  np.asarray(jbr.unpack_bits(jnp.asarray(pa))))


def _desc(i):
    kps, ok = _keypoints(i)
    d = jbr.brief_describe(jnp.asarray(_images()[i]), jnp.asarray(kps), jnp.asarray(ok))
    return np.asarray(d), ok


def test_hamming_and_matching_are_exact():
    a, am = _desc(0)
    b, bm = _desc(1)
    np.testing.assert_array_equal(
        tbr.hamming_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jbr.hamming_matrix(jnp.asarray(a), jnp.asarray(b))))
    ja, jok = jbr.match_descriptors(jnp.asarray(a), jnp.asarray(am), jnp.asarray(b),
                                    jnp.asarray(bm), 80)
    ta, tok = tbr.match_descriptors(torch.from_numpy(a), torch.from_numpy(am),
                                    torch.from_numpy(b), torch.from_numpy(bm), 80)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(ta.numpy()[tok.numpy()], np.asarray(ja)[np.asarray(jok)])
    assert int(tok.sum()) > 5
    # batched over candidates, as the detector calls it
    tb2, tok2 = tbr.match_descriptors(torch.from_numpy(a), torch.from_numpy(am),
                                      torch.from_numpy(np.stack([b, a])),
                                      torch.from_numpy(np.stack([bm, am])), 80)
    np.testing.assert_array_equal(tok2[0].numpy(), tok.numpy())
    assert bool(tok2[1][torch.from_numpy(am)].all())


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("bits,dim", [(256, 1000), (256, 128), (256, 64)])
def test_codebook_and_assets_match(bits, dim):
    if (bits, dim) in tbr.SHIPPED_VOCABS:
        assert _sha(tbr.vocab_asset_path(bits, dim)) == _sha(jbr.vocab_asset_path(bits, dim))
        assert os.path.dirname(tbr.vocab_asset_path(bits, dim)).endswith(
            os.path.join("lmono_tpu_torch", "assets"))
    np.testing.assert_array_equal(tbr.make_codebook(bits, dim).numpy(),
                                  np.asarray(jbr.make_codebook(bits, dim)))


def test_a_missing_shipped_vocabulary_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(tbr, "vocab_asset_path",
                        lambda bits, dim: str(tmp_path / f"vocab_brief_{bits}x{dim}.npz"))
    with pytest.raises(FileNotFoundError, match="vocabulary asset missing"):
        tbr.make_codebook(256, 1000)
    assert tbr.make_codebook(256, 64).shape == (256, 64)   # no asset: projection


def test_global_descriptor_matches():
    cb = jbr.make_codebook(256, 1000)
    for i in range(3):
        d, ok = _desc(i)
        a = np.asarray(jbr.global_descriptor(jnp.asarray(d), jnp.asarray(ok), cb))
        b = tbr.global_descriptor(torch.from_numpy(d), torch.from_numpy(ok),
                                  torch.from_numpy(np.asarray(cb))).numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _db():
    """The reference's DB after 5 keyframes of the rendered sequence; and
    each keyframe's db_add inputs."""
    cb = jbr.make_codebook(LOOP.brief_bits, LOOP.vocab_dim)
    rng = np.random.default_rng(0)
    db = jdb.KeyframeDB.empty(LOOP)
    add = jax.jit(lambda db, kw: jdb.db_add(db, cb, **kw))
    inputs = []
    for i in range(5):
        d, ok = _desc(i)
        kw = dict(desc=d, kp_norm=rng.random((LOOP.max_keypoints, 2)).astype(np.float32),
                  kp_mask=ok, win_desc=d[:LOOP.window_points],
                  win_pts=rng.random((LOOP.window_points, 3)).astype(np.float32),
                  win_norm=rng.random((LOOP.window_points, 2)).astype(np.float32),
                  win_mask=ok[:LOOP.window_points],
                  t=rng.random(3).astype(np.float32), q=np.array([1.0, 0, 0, 0], np.float32),
                  time=np.float32(0.3 * i),
                  lidar_edge=rng.random((LOOP.kf_edge_points, 3)).astype(np.float32),
                  lidar_edge_mask=rng.random(LOOP.kf_edge_points) < 0.8,
                  lidar_planar=rng.random((LOOP.kf_planar_points, 3)).astype(np.float32),
                  lidar_planar_mask=rng.random(LOOP.kf_planar_points) < 0.8)
        inputs.append(kw)
        db = add(db, kw)
    return jax.device_get(db), inputs, np.asarray(cb)


def test_db_add_matches():
    ref, inputs, cb = _db()
    db = tdb.KeyframeDB.empty(LOOP, device="cpu")
    for i, kw in enumerate(inputs):
        tdb.db_add(db, torch.from_numpy(cb), i,
                   **{k: (torch.from_numpy(np.asarray(v)) if k != "time" else float(v))
                      for k, v in kw.items()})
    for f in tdb.KeyframeDB._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(db, f).numpy()
        if f == "gdesc":
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("cur", [2, 3, 5])
def test_db_query_matches(cur):
    ref, inputs, cb = _db()
    db, count = keyframe_db_from_numpy(ref, "cpu")
    assert count == 5
    d, ok = _desc(cur)
    time = np.float32(0.3 * cur + 0.2)
    a = [np.asarray(x) for x in jdb.db_query(ref, jnp.asarray(cb), jnp.asarray(d),
                                             jnp.asarray(ok), jnp.int32(cur), time, LOOP)]
    b = [x.numpy() for x in tdb.db_query(db, torch.from_numpy(cb), torch.from_numpy(d),
                                         torch.from_numpy(ok), cur, float(time), LOOP)]
    np.testing.assert_allclose(b[0], a[0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(b[1], a[1])
    np.testing.assert_array_equal(b[2], a[2])
    if cur == 3:   # one candidate old enough: the rest tie at −1, lower slot first
        assert a[2].sum() == 1 and list(a[1][1:]) == sorted(a[1][1:])
