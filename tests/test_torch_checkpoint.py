"""Checkpoints of the port (`lmono_tpu_torch.utils.checkpoint`,
`SlamSystem.save_checkpoint` / `load_checkpoint`).

* `save_state` / `load_state` round-trip `FusedState`, `KeyframeDB`,
  `PoseGraph` and `ColorMap` bit for bit, dtypes and devices kept; the npz
  keys are the leaves' tree paths.
* A mismatch raises `CheckpointMismatch` listing every mismatched path
  with both shapes, missing and extra keys included.
* Resume, loop and map on: `SlamSystem.process` over the first 16 frames
  of `test_torch_system.py`'s out-and-back drive (run A), with a
  checkpoint after frame 13, and a fresh system C loaded from it that runs
  frames 14-15.  C's per-frame outputs, `final_trajectory`, closures, DB
  count, map points and PLY bytes equal A's bit for bit; closures are
  applied after the checkpoint, the map's archive is flushed on both sides
  of it (`flush_every` 4), and C's pose graph, made at capacity 4, grows
  twice to take the saved one.
* A mismatch outside the graph raises at once, with no growth; noise
  sources load only on the device type they were saved on.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from lmono_tpu_torch.fused import FusedState
from lmono_tpu_torch.io import synthetic as syn
from lmono_tpu_torch.loop.keyframe_db import KeyframeDB
from lmono_tpu_torch.loop.posegraph import PoseGraph
from lmono_tpu_torch.mapping.builder import ColorMap
from lmono_tpu_torch.pipeline import SlamSystem
from lmono_tpu_torch.utils.checkpoint import (CheckpointMismatch, load_extras,
                                              load_state, save_state, tree_leaves)
from test_torch_system import TCFG, _drive
from torch_estimator_cases import one_torch_thread  # noqa: F401

CFG = TCFG.replace(mapping=dataclasses.replace(TCFG.mapping, flush_every=4))
K = 14              # the checkpoint is taken after frame K - 1
END = 16            # frames run: a closure and a map flush at frame 15
GRAPH_START = 4     # the pose graph's first capacity: grown twice by frame K


def _randomize(tree, seed: int):
    """The tree with every tensor leaf filled with random values in place."""
    g = torch.Generator().manual_seed(seed)
    for leaf in tree_leaves(tree).values():
        if leaf.dtype == torch.bool:
            leaf.copy_(torch.rand(leaf.shape, generator=g) > 0.5)
        elif leaf.dtype.is_floating_point:
            leaf.copy_(torch.randn(leaf.shape, generator=g))
        else:
            leaf.copy_(torch.randint(-1000, 1000, leaf.shape, generator=g))
    return tree


def _states():
    return {
        "fused": FusedState.init(CFG, syn.synthetic_T_CL(), "cpu"),
        "db": KeyframeDB.empty(CFG.loop, "cpu"),
        "graph": PoseGraph.empty(16, 8, "cpu"),
        "map": ColorMap.empty(64, "cpu"),
    }


def _assert_trees_equal(a, b) -> None:
    la, lb = tree_leaves(a), tree_leaves(b)
    assert list(la) == list(lb)
    for p in la:
        if isinstance(la[p], torch.Tensor):
            assert la[p].dtype == lb[p].dtype and la[p].device == lb[p].device, p
            assert torch.equal(la[p], lb[p]), p
        else:
            assert type(la[p]) is type(lb[p]) and la[p] == lb[p], p


@pytest.mark.parametrize("name", ["fused", "db", "graph", "map"])
def test_state_round_trips_bit_for_bit(tmp_path, name):
    state = _randomize(_states()[name], seed=len(name))
    path = str(tmp_path / "s.npz")
    n = save_state(path, state, extra={"hist": np.arange(5)})
    template = _states()[name]
    back = load_state(path, template)
    assert type(back) is type(state)
    _assert_trees_equal(back, state)
    assert all(a is not b for a, b in zip(tree_leaves(back).values(),
                                          tree_leaves(template).values()))
    with np.load(path) as z:
        keys = set(z.files)
    assert keys == set(tree_leaves(state)) | {"__extra__/hist"} and n == len(keys) - 1
    np.testing.assert_array_equal(load_extras(path)["hist"], np.arange(5))


def test_keys_are_tree_paths(tmp_path):
    fused = FusedState.init(CFG, syn.synthetic_T_CL(), "cpu")
    path = str(tmp_path / "s.npz")
    save_state(path, {"front": fused, "graph": PoseGraph.empty(4, 8, "cpu"),
                      "count": {"frame": 3}})
    with np.load(path) as z:
        keys = set(z.files)
    for k in ("front/est/window/ex_q", "front/odo/pose/t", "front/trk/pyramid/2",
              "front/trk/grads/0/1", "graph/t", "graph/loop_w", "count/frame"):
        assert k in keys, k


def test_mismatch_lists_every_path(tmp_path):
    small = FusedState.init(CFG, syn.synthetic_T_CL(), "cpu")
    other = CFG.replace(
        tracker=dataclasses.replace(CFG.tracker, max_features=24),
        estimator=dataclasses.replace(CFG.estimator, window_size=3))
    big = FusedState.init(other, syn.synthetic_T_CL(), "cpu")
    path = str(tmp_path / "s.npz")
    save_state(path, {"front": small, "a": torch.zeros(3), "gone": torch.zeros(2)})
    with pytest.raises(CheckpointMismatch) as e:
        load_state(path, {"front": big, "a": torch.zeros(3), "new": torch.ones(4, 2)})
    assert isinstance(e.value, ValueError)
    ls, lb = tree_leaves(small), tree_leaves(big)
    want = {(f"front/{p}", tuple(ls[p].shape), tuple(lb[p].shape))
            for p in ls if ls[p].shape != lb[p].shape}
    assert len(want) > 10
    want |= {("gone", (2,), None), ("new", None, (4, 2))}
    assert set(e.value.paths) == want and len(e.value.paths) == len(want)
    assert "front/est/window/t" in str(e.value)


def _make_system(cfg=CFG) -> SlamSystem:
    s = SlamSystem(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    s._graph_cap = GRAPH_START
    s.graph = PoseGraph.empty(GRAPH_START, s.graph.loop_mask.shape[0], "cpu")
    return s


def _outputs(o: dict) -> dict:
    return {k: (v.t, v.q) if hasattr(v, "q") else v for k, v in o.items()}


@functools.lru_cache(maxsize=None)
def _resume(ckpt: str) -> dict:
    """Runs A (checkpoint after frame K - 1 into `ckpt`) and C (loaded from
    it): the systems, their per-frame outputs, A's counts at the
    checkpoint and C's graph capacity before loading."""
    chunks, _ = _drive()
    frames = [{k: v[i] for k, v in c.items()} for c in chunks
              for i in range(c["points"].shape[0])][:END]
    at_ckpt = {}

    def run(s, i0, save=False):
        outs = []
        for i in range(i0, END):
            f = frames[i]
            outs.append(_outputs(s.process({k: f[k] for k in ("points", "ranges", "valid")},
                                           f["image"], time=i * 0.1)))
            if save and i == K - 1:
                s.save_checkpoint(ckpt)
                at_ckpt.update(n_loops=s.n_loops, archived=s.mapper._archived_n,
                               graph=s.graph.t.shape[0])
        return outs

    a = _make_system()
    out_a = run(a, 0, save=True)
    c = _make_system()
    cap0 = c.graph.t.shape[0]
    c.load_checkpoint(ckpt)
    out_c = run(c, K)
    return dict(a=a, c=c, out_a=out_a, out_c=out_c, at_ckpt=at_ckpt, cap0=cap0,
                ckpt=ckpt)


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    # one torch thread here too: a module fixture is set up before the
    # autouse `one_torch_thread`
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _resume(str(tmp_path_factory.mktemp("ckpt") / "state.npz"))
    finally:
        torch.set_num_threads(n)


def test_resume_equals_the_uninterrupted_run(resumed, tmp_path):
    a, c, at_ckpt = resumed["a"], resumed["c"], resumed["at_ckpt"]
    out_a, out_c = resumed["out_a"], resumed["out_c"]
    assert len(out_c) == END - K
    for i, (oa, oc) in enumerate(zip(out_a[K:], out_c), start=K):
        assert oa.keys() == oc.keys()
        for k in oa:
            if isinstance(oa[k], tuple):
                assert all(torch.equal(x, y) for x, y in zip(oa[k], oc[k])), (i, k)
            else:
                assert oa[k] == oc[k], (i, k)
    ta, tc = a.final_trajectory(), c.final_trajectory()
    assert ta.t.shape[0] == END
    assert torch.equal(ta.t, tc.t) and torch.equal(ta.q, tc.q)
    assert c.n_loops == a.n_loops > at_ckpt["n_loops"]      # closures after K
    assert c.keyframes_processed == a.keyframes_processed
    assert c.loop.count == a.loop.count == int(a.loop.db.count) == int(c.loop.db.count)
    assert c.frame_idx == a.frame_idx == END
    # the map's archive was flushed before the checkpoint and after it
    assert 0 < at_ckpt["archived"] < a.mapper._archived_n == c.mapper._archived_n
    assert c.mapper.n_points == a.mapper.n_points > 1000
    pa, pc = str(tmp_path / "a.ply"), str(tmp_path / "c.ply")
    assert a.save_map(pa) == c.save_map(pc)
    assert open(pa, "rb").read() == open(pc, "rb").read()
    # C's graph was made at capacity 4 and grew twice to the saved 16
    assert resumed["cap0"] == GRAPH_START and at_ckpt["graph"] == 4 * GRAPH_START
    for x, y in zip(a.graph, c.graph):
        assert torch.equal(x, y)


def test_a_grown_graph_reloads_into_a_fresh_system(resumed):
    fresh = _make_system()
    fresh.load_checkpoint(resumed["ckpt"])
    assert fresh.graph.t.shape[0] == fresh._graph_cap == 4 * GRAPH_START
    n = fresh._n_nodes
    assert 0 < n == len(fresh._node_raw_cam) == len(fresh._node_frames)
    assert fresh._node_frames == resumed["a"]._node_frames[:n]
    assert len(fresh._raw_poses) == fresh.frame_idx == K
    assert fresh.loop._last_pos is not None and fresh.loop._last_pos.dtype == np.float32


def test_a_mismatch_outside_the_graph_raises_at_once(resumed):
    other = CFG.replace(loop=dataclasses.replace(CFG.loop, db_capacity=32))
    s = _make_system(other)
    with pytest.raises(CheckpointMismatch) as e:
        s.load_checkpoint(resumed["ckpt"])
    paths = {p for p, _, _ in e.value.paths}
    assert "loop/db/gdesc" in paths and "graph/t" in paths
    assert s._graph_cap == s.graph.t.shape[0] == GRAPH_START      # no growth
    assert s.frame_idx == 0


def test_noise_sources_load_only_on_their_device_type(resumed, tmp_path):
    """A CUDA generator's state (seed and offset, 16 bytes) in place of the
    CPU ones: loading into a CPU system names the `rng/` entries."""
    with np.load(resumed["ckpt"]) as z:
        data = {k: z[k] for k in z.files}
    cpu_shape = data["rng/front"].shape
    for k in ("rng/front", "rng/loop"):
        data[k] = np.zeros(16, np.uint8)
    path = str(tmp_path / "cuda_rng.npz")
    np.savez(path, **data)
    s = _make_system()
    s._grow_graph()
    s._grow_graph()           # the saved capacity: only the noise sources differ
    with pytest.raises(CheckpointMismatch) as e:
        s.load_checkpoint(path)
    assert sorted(e.value.paths) == [("rng/front", (16,), cpu_shape),
                                     ("rng/loop", (16,), cpu_shape)]


def test_queued_map_occupancy_is_kept(tmp_path):
    s = SlamSystem(CFG, enable_loop=False, device="cpu")
    s.mapper._occ = (torch.tensor(1234), None)
    s.mapper.frames = 31
    path = str(tmp_path / "s.npz")
    s.save_checkpoint(path)
    t = SlamSystem(CFG, enable_loop=False, device="cpu")
    t.load_checkpoint(path)
    assert int(t.mapper._occ[0]) == 1234 and t.mapper.frames == 31
    s.mapper._occ = None
    s.save_checkpoint(path)
    t.load_checkpoint(path)
    assert t.mapper._occ is None


@pytest.mark.gpu
def test_a_cuda_checkpoint_raises_in_a_cpu_system(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    path = str(tmp_path / "s.npz")
    SlamSystem(CFG, device="cuda").save_checkpoint(path)
    with pytest.raises(CheckpointMismatch) as e:
        SlamSystem(CFG, device="cpu").load_checkpoint(path)
    assert sorted(p for p, _, _ in e.value.paths) == ["rng/front", "rng/loop"]
    back = SlamSystem(CFG, device="cuda")
    back.load_checkpoint(path)
    assert back.graph.t.device.type == "cuda"
