"""The port's window state and feature bookkeeping
(`lmono_tpu_torch.estimator.window`, `feature_manager`) against
`lmono_tpu.estimator.window` and `feature_manager`, on inputs made from a
seed with numpy.

Tolerances: integer and bool fields equal, `obs` equal, `inv_depth` within
1e-5 relative; `consistency_check` within 1e-4 (degrees and metres of
order one); `init` equal.  `triangulate` solves a 3×3 system that is
near-singular for rays of small parallax, in f32: the reference's own
depths lie well over 1e-5 relative from the same algorithm run in f64, so
there `inv_depth` is held within 1e-5 relative plus twice the reference's
distance from the f64 run, element by element (ROADMAP Queue 3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmono_tpu.estimator import feature_manager as jfm
from lmono_tpu.estimator import window as jw
from lmono_tpu.io.synthetic import synthetic_T_CL
from lmono_tpu_torch.convert import window_state_from_numpy
from lmono_tpu_torch.estimator import feature_manager as tfm
from lmono_tpu_torch.estimator import window as tw
from lmono_tpu_torch.utils.lie import Pose as TPose
from torch_estimator_cases import (
    CFG,
    jax_track,
    one_torch_thread,
    perturb,
    port_track,
    to_port,
    window_problem,
)

INV_DEPTH_RTOL = 1e-5


def _assert_table(jf, tf, atol=0.0):
    for f in ("ids", "anchor", "obs", "obs_mask", "depth_ok", "alive"):
        np.testing.assert_array_equal(getattr(tf, f).numpy(), np.asarray(getattr(jf, f)),
                                      err_msg=f)
    ref = np.asarray(jf.inv_depth)
    err = np.abs(tf.inv_depth.numpy() - ref)
    assert np.all(err <= INV_DEPTH_RTOL * np.abs(ref) + atol), err.max()


def _assert_window(jw_, tw_, atol=0.0):
    for f in ("t", "q", "lt", "lq", "ex_t", "ex_q"):
        np.testing.assert_allclose(getattr(tw_, f).numpy(), np.asarray(getattr(jw_, f)),
                                   rtol=0, atol=atol, err_msg=f)
    assert int(tw_.count) == int(jw_.count)
    _assert_table(jw_.feats, tw_.feats)


@pytest.mark.parametrize("with_extrinsic", [False, True])
def test_init_matches(with_extrinsic):
    T = synthetic_T_CL() if with_extrinsic else None
    j = jax.device_get(jw.WindowState.init(CFG, T))
    tT = TPose(torch.tensor(np.array(T.t)), torch.tensor(np.array(T.q))) \
        if with_extrinsic else None
    t = tw.WindowState.init(CFG, tT)
    c = window_state_from_numpy(j)
    for a, b in zip(jax.tree.leaves(j), [*_leaves(t)]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for x, y in zip(_leaves(c), _leaves(t)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _to(nt, dtype):
    """Every float32 leaf of a NamedTuple as `dtype`."""
    return type(nt)(*(_to(x, dtype) if not isinstance(x, torch.Tensor)
                      else x.to(dtype) if x.dtype == torch.float32 else x
                      for x in nt))


def _leaves(nt):
    for x in nt:
        if isinstance(x, torch.Tensor):
            yield x
        else:
            yield from _leaves(x)


def test_consistency_check_matches():
    js, _ = window_problem(seed=1, count=4)
    js = perturb(js, seed=2)
    js = js._replace(lt=js.lt + 0.03)
    cj = jw.consistency_check(js)
    ct = tw.consistency_check(to_port(js))
    for k in cj:
        np.testing.assert_allclose(ct[k].numpy(), np.asarray(cj[k]), rtol=0, atol=1e-4,
                                   err_msg=k)
    assert float(ct["rot_err_deg"][-1]) == 0.0      # pair 3-4 is outside count 4


def test_tree_where_selects_every_leaf():
    a = to_port(window_problem(seed=3)[0])
    b = tw.WindowState.init(CFG)
    for cond, ref in ((True, a), (False, b)):
        out = tw.tree_where(torch.tensor(cond), a, b)
        assert type(out.feats) is tw.FeatureTable
        for x, y in zip(_leaves(out), _leaves(ref)):
            assert torch.equal(x, y)


def _tracks(seed, table_ids, n=48, dup=False):
    """A tracker output: some of the table's ids, some new ids, dead slots."""
    rng = np.random.default_rng(seed)
    ids = np.full(n, -1, np.int32)
    known = rng.choice(table_ids[table_ids >= 0], 12, replace=False)
    ids[:12] = known
    ids[12:30] = 1000 + np.arange(18)
    if dup:
        ids[30] = known[0]                              # a duplicate id
    alive = ids >= 0
    alive[5] = False                                    # a known id, dead
    norm = rng.normal(size=(n, 2)).astype(np.float32)
    return {"ids": ids, "norm": norm, "alive": alive}


@pytest.mark.parametrize("slot,dup", [(4, False), (2, False), (4, True)])
def test_ingest_observations_matches(slot, dup):
    js, _ = window_problem(seed=4)
    feats = js.feats
    # free a third of the table rows
    free = np.zeros(CFG.max_tracks, bool)
    free[::3] = True
    feats = feats._replace(alive=feats.alive & ~jnp.asarray(free),
                           ids=jnp.where(jnp.asarray(free), -1, feats.ids))
    d = _tracks(seed=slot, table_ids=np.asarray(feats.ids), dup=dup)
    jf = jfm.ingest_observations(feats, jax_track(d), jnp.asarray(slot, jnp.int32))
    tf = tfm.ingest_observations(to_port(js._replace(feats=feats)).feats,
                                 port_track(d), slot)
    _assert_table(jf, tf)
    assert int(tf.alive.sum()) > int(np.asarray(feats.alive).sum())


@pytest.mark.parametrize("slot", [0, 1, 2, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_keyframe_check_matches(slot, seed):
    js, _ = window_problem(seed=seed)
    if seed == 1:                      # a thin co-visible set
        js = js._replace(feats=js.feats._replace(
            obs_mask=js.feats.obs_mask.at[25:].set(False)))
    cfg = CFG if seed == 0 else dataclasses.replace(CFG, feature_threshold=1e9)
    j = bool(jfm.keyframe_check(js.feats, jnp.asarray(slot, jnp.int32), cfg))
    t = tfm.keyframe_check(to_port(js).feats, slot, cfg)
    assert t.dtype == torch.bool and t.shape == ()
    assert bool(t) == j


def test_triangulate_matches():
    js, _ = window_problem(seed=5)
    js = perturb(js, seed=6, dp=0.02, dth=0.002, ddepth=0.0)
    depth_ok = np.ones(CFG.max_tracks, bool)
    depth_ok[::2] = False
    js = js._replace(feats=js.feats._replace(
        depth_ok=jnp.asarray(depth_ok),
        inv_depth=jnp.where(jnp.asarray(depth_ok), js.feats.inv_depth, 0.0)))
    j = jfm.triangulate(js, CFG)
    t = tfm.triangulate(to_port(js), CFG)
    # the same algorithm in f64: how far the reference's f32 answer lies
    f64 = tfm.triangulate(_to(to_port(js), torch.float64), CFG)
    ref_err = np.abs(np.asarray(j.feats.inv_depth) - f64.feats.inv_depth.numpy())
    _assert_table(j.feats, t.feats, atol=2.0 * ref_err)
    assert ref_err.max() > 0.0
    assert int(t.feats.depth_ok.sum()) > int(depth_ok.sum())


@pytest.mark.parametrize("kind", ["old", "new"])
def test_slides_match(kind):
    js, _ = window_problem(seed=7)
    mask = np.asarray(js.feats.obs_mask).copy()
    mask[:6, 1:] = False                 # features seen only at slot 0
    mask[6:10, :-1] = False              # features seen only at the newest slot
    js = js._replace(feats=js.feats._replace(obs_mask=jnp.asarray(mask)))
    jf, tf = (jfm.slide_old, tfm.slide_old) if kind == "old" else (jfm.slide_new,
                                                                   tfm.slide_new)
    j = jf(js)
    t = tf(to_port(js))
    _assert_window(j, t)
    assert int(t.count) == CFG.window_size
