"""The port's mesh pieces on the space axis (`lmono_tpu_torch.parallel`,
`axis=` of `ops/voxelmap.py` and `mapping/builder.py`) against the JAX
package's, on four gloo ranks spawned once for the file
(`tests/torch_dist_cases.py:parallel_suite`) and on four of the JAX
package's virtual CPU devices:

* `sharded_knn` (K1's plain version on each rank's shard, the gathered
  merge) against `lmono_tpu.parallel.sharded_knn`: d² within rtol 1e-4 /
  atol 1e-3, the same index sets;
* `bank_update_hash(axis=)` on a map=4 mesh: the shards, concatenated,
  equal the JAX sharded update and the single-device bank bit for bit
  (the case of tests/test_dist_engine.py's `test_sharded_bank_update_exact`);
* `colormap_update_hash(axis=)` likewise (`test_sharded_colormap_exact`);
* `odometry_step(axis=)` (`make_dist_odometry_scan`, and
  `make_dist_odometry_step` frame by frame) over three frames: poses and
  gathered banks bit for bit one rank's;
* `pack_words` (the word buffer of the gathers and owner psums): exact
  for float32 and integers, refusing other floating types;
* `check_divisible`'s errors, and a mesh without a process group;
* `convert.py`'s shards of a JAX `FusedState` and `KeyframeDB`.
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dist_cases as cases
from lmono_tpu.config import SystemConfig as JSystemConfig
from lmono_tpu.fused import FusedState as JFusedState
from lmono_tpu.loop.keyframe_db import KeyframeDB as JKeyframeDB
from lmono_tpu.mapping.builder import ColorMap as JColorMap
from lmono_tpu.mapping.builder import colormap_update_hash as jcolormap_update_hash
from lmono_tpu.ops.knn import knn as jknn
from lmono_tpu.ops.voxelmap import PointBank as JPointBank
from lmono_tpu.ops.voxelmap import bank_update_hash as jbank_update_hash
from lmono_tpu.parallel import make_mesh as jmake_mesh
from lmono_tpu.parallel import sharded_knn as jsharded_knn
from lmono_tpu.parallel.dist_engine import make_engine_mesh as jmake_engine_mesh
from lmono_tpu_torch.config import ParallelConfig, synthetic_config
from lmono_tpu_torch.parallel.dist_engine import check_divisible
from lmono_tpu_torch.parallel.launch import run_ranks
from lmono_tpu_torch.parallel.mesh import pack_words, unpack_words

RANKS = 4
BANK_C, MAP_C = 1024, 2048
Q, M_PER = 32, 128


@functools.lru_cache(maxsize=None)
def _inputs() -> dict:
    rng = np.random.default_rng(0)
    arrays = {
        "query": (rng.standard_normal((Q, 3)) * 5).astype(np.float32),
        "bank": (rng.standard_normal((RANKS * M_PER, 3)) * 5).astype(np.float32),
        "bank_mask": rng.random(RANKS * M_PER) < 0.9,
        "pts1": rng.uniform(-20, 20, (512, 3)).astype(np.float32),
        "cm_pts": rng.uniform(-30, 30, (1024, 3)).astype(np.float32),
        "cm_cols": rng.random((1024, 3)).astype(np.float32),
        "cm_mask": np.arange(1024) % 5 != 0,
    }
    arrays["pts2"] = (arrays["pts1"] + 0.02 * rng.standard_normal((512, 3))
                      ).astype(np.float32)
    cfg = JSystemConfig.from_json(cases.ENGINE_CFG.to_json())
    fused = jax.tree.map(np.asarray, JFusedState.init(cfg, None))
    # a recognisable table and bank: every row holds its own index
    w = fused.est.window
    feats = w.feats._replace(ids=np.arange(w.feats.ids.shape[0], dtype=np.int32))
    odo = fused.odo._replace(edge_map=fused.odo.edge_map._replace(
        points=np.arange(fused.odo.edge_map.points.size, dtype=np.float32
                         ).reshape(fused.odo.edge_map.points.shape)))
    fused = fused._replace(odo=odo, est=fused.est._replace(window=w._replace(feats=feats)))
    db = jax.tree.map(np.asarray, JKeyframeDB.empty(cfg.loop))
    db = db._replace(valid=np.arange(db.valid.shape[0]) % 3 == 0,
                     t=rng.standard_normal(db.t.shape).astype(np.float32),
                     count=np.asarray(5, np.int32))
    return {"arrays": arrays, "bank_capacity": BANK_C, "map_capacity": MAP_C,
            "fused": fused, "db": db, "odometry_frames": 3}


@pytest.fixture(scope="module")
def ranks():
    inp = _inputs()
    inp = {**inp, "fused": cases.plain(inp["fused"]), "db": cases.plain(inp["db"])}
    # the JAX package's updates compile while the ranks run
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(run_ranks, cases.parallel_suite, RANKS, (inp,), timeout_s=240)
        _jax_bank()
        return fut.result()


def test_sharded_knn_matches_jax(ranks):
    a = _inputs()["arrays"]
    mesh = jmake_mesh(RANKS, axis="map")
    d2_j, idx_j = jsharded_knn(mesh, jnp.asarray(a["query"]),
                               jnp.asarray(a["bank"]).reshape(RANKS, M_PER, 3),
                               jnp.asarray(a["bank_mask"]).reshape(RANKS, M_PER),
                               k=5, axis="map")
    d2_1, idx_1 = jknn(jnp.asarray(a["query"]), jnp.asarray(a["bank"]),
                       jnp.asarray(a["bank_mask"]), 5)
    for r in ranks:
        d2, idx = (x.numpy() for x in r["knn"])
        np.testing.assert_array_equal(d2, ranks[0]["knn"][0].numpy())
        for ref_d2, ref_idx in ((d2_j, idx_j), (d2_1, idx_1)):
            np.testing.assert_allclose(np.sort(d2, 1), np.sort(np.asarray(ref_d2), 1),
                                       rtol=1e-4, atol=1e-3)
            for q in range(Q):
                assert set(idx[q].tolist()) == set(np.asarray(ref_idx[q]).tolist())


@jax.jit
def _jax_bank_update(bank, p):
    return jbank_update_hash(bank, p, jnp.ones(512, bool), 0.5, jnp.zeros(3), 100.0)


@functools.lru_cache(maxsize=None)
def _jax_bank():
    a = _inputs()["arrays"]
    bank = JPointBank.empty(BANK_C)
    mesh = jmake_engine_mesh(1, RANKS)
    spec = JPointBank(P("map"), P("map"))

    @functools.partial(jax.shard_map, mesh=mesh, check_vma=False,
                       in_specs=(spec, P(), P()), out_specs=spec)
    def upd(b, p, m):
        return jbank_update_hash(b, p, m, 0.5, jnp.zeros(3), 100.0, axis="map")

    upd = jax.jit(upd)
    sb = JPointBank.empty(BANK_C)
    for p in (a["pts1"], a["pts2"]):
        bank = _jax_bank_update(bank, jnp.asarray(p))
        sb = upd(sb, jnp.asarray(p), jnp.ones(512, bool))
    return bank, sb


def test_sharded_bank_update_bitwise(ranks):
    bank, sb = _jax_bank()
    pts = np.concatenate([r["bank"][0].numpy() for r in ranks])
    mask = np.concatenate([r["bank"][1].numpy() for r in ranks])
    for ref in (bank, sb):
        np.testing.assert_array_equal(mask, np.asarray(ref.mask))
        np.testing.assert_array_equal(pts.view(np.int32),
                                      np.asarray(ref.points).view(np.int32))
    assert mask.sum() > 100


def test_sharded_colormap_bitwise(ranks):
    a = _inputs()["arrays"]
    args = (jnp.asarray(a["cm_pts"]), jnp.asarray(a["cm_cols"]), jnp.asarray(a["cm_mask"]))
    cm = jax.jit(lambda *a: jcolormap_update_hash(JColorMap.empty(MAP_C), *a, 0.3))(*args)
    mesh = jmake_engine_mesh(1, RANKS)
    spec = JColorMap(P("map"), P("map"), P("map"))

    @functools.partial(jax.shard_map, mesh=mesh, check_vma=False,
                       in_specs=(spec, P(), P(), P()), out_specs=spec)
    def upd(c, p, co, m):
        return jcolormap_update_hash(c, p, co, m, 0.3, axis="map")

    sm = jax.jit(upd)(JColorMap.empty(MAP_C), *args)
    for i, name in enumerate(("points", "colors", "mask")):
        got = np.concatenate([r["cmap"][i].numpy() for r in ranks])
        for ref in (cm, sm):
            want = np.asarray(getattr(ref, name))
            if want.dtype == np.float32:
                got, want = got.view(np.int32), want.view(np.int32)
            np.testing.assert_array_equal(got, want)
    assert np.asarray(cm.mask).sum() > 200


def test_sharded_odometry_bitwise(ranks):
    """`odometry_step(axis=)` through `make_dist_odometry_scan` and, frame
    by frame, `make_dist_odometry_step` on the map=4 mesh: poses and the
    gathered banks equal one rank's run, bit for bit."""
    for r in ranks:
        (t, edge, plane), (t1, edge1, plane1), stepped = r["odometry"]
        for t2, edge2, plane2 in ((t, edge, plane), stepped):
            assert torch.equal(t2.view(torch.int32), t1.view(torch.int32))
            for a, b in zip(edge2 + plane2, edge1 + plane1):
                assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                                   b.view(torch.int32) if b.is_floating_point() else b)
        assert int(edge[1].sum()) > 100


def test_pack_words_round_trip():
    """float32, int64, int32 and bool leaves through one word buffer, bit
    for bit."""
    x = [torch.tensor([[1.5, -0.0], [float("nan"), 3e-39]]),
         torch.tensor([[2 ** 40 + 3], [-7]]), torch.tensor([[5, -6], [7, 8]], dtype=torch.int32),
         torch.tensor([[True], [False]])]
    buf, layout = pack_words(x)
    assert buf.dtype == torch.int32 and buf.shape[0] == 2
    for a, b in zip(unpack_words(buf, layout), x):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16, torch.bfloat16])
def test_pack_words_refuses_other_floats(dtype):
    with pytest.raises(TypeError, match="float32"):
        pack_words([torch.zeros((2, 3), dtype=dtype)])


def test_check_divisible_errors():
    cfg = synthetic_config()
    check_divisible(cfg, 2, 2)
    for kf, mp, what in ((7, 1, "max_tracks"), (1, 3, "bank capacities"),
                         (5, 1, "db_capacity")):
        with pytest.raises(ValueError, match=what):
            check_divisible(cfg, kf, mp)
    with pytest.raises(ValueError, match="map_capacity"):
        check_divisible(cfg.replace(mapping=dataclasses.replace(
            cfg.mapping, map_capacity=1001)), 1, 2)


def test_mesh_needs_a_process_group():
    from lmono_tpu_torch.pipeline import SlamSystem

    cfg = synthetic_config().replace(parallel=ParallelConfig(kf_shards=2, map_shards=2))
    with pytest.raises(RuntimeError, match="process group"):
        SlamSystem(cfg, device="cpu")


def test_convert_shards_a_jax_state(ranks):
    inp = _inputs()
    fused, db = inp["fused"], inp["db"]
    M = fused.est.window.feats.ids.shape[0] // RANKS
    C = db.valid.shape[0] // RANKS
    for r, res in enumerate(ranks):
        # (kf=4, map=1): the feature rows split, the banks stay whole
        np.testing.assert_array_equal(res["fused_feats_ids"].numpy(),
                                      fused.est.window.feats.ids[r * M:(r + 1) * M])
        np.testing.assert_array_equal(res["fused_edge_points"].numpy(),
                                      fused.odo.edge_map.points)
        assert res["fused_frame"] == 0
        np.testing.assert_array_equal(res["db_valid"].numpy(), db.valid[r * C:(r + 1) * C])
        np.testing.assert_array_equal(res["db_t"].numpy(), db.t[r * C:(r + 1) * C])
        assert res["db_count"] == 5
