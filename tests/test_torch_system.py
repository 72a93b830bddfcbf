"""The port's whole system (`lmono_tpu_torch.pipeline.SlamSystem`) on the
CPU, at a small width, on an out-and-back drive along the circuit (12
frames out, 12 back) that the port's simulator makes, so that the way back
revisits the way out: `process_chunk` with loop and map on, in chunks of
5 frames.

* The run: the loop lane reaps and closes at least one loop, the pose graph
  grows (it starts at 8 nodes here), `final_trajectory` has one finite
  pose per frame, `save_map` writes the map's points to a PLY file.
* Against the JAX package's loop lane: `lmono_tpu.pipeline.SlamSystem`'s
  keyframe lane (`_loop_lane_chunk`, `_reap_loops`) is fed the port's own
  chunk outputs, in the same order, with the same PnP draws (the Gumbel
  noise behind the reference detector's keys): each processed keyframe's
  result agrees (`found`, `old_seq`, `refined` equal, the relative pose
  within 1 mm and 1e-4, 1 cm and 1e-3 where LiDAR-refined), the same
  keyframes become the same nodes, the same closures the same loop edges
  with the same weights and switches, and the optimized node positions
  agree within 2 cm.  Where the reference's jitted keyframe program parts
  from the port (three keyframes of this drive), the port's PnP is held,
  candidate by candidate, to the reference's `ransac_pnp` compiled alone on
  the same inputs and draws (inliers and `ok` equal, pose within 1e-4), or,
  where the two part, the cause is shown to be a minimal sample with a
  repeated point (the draws are with replacement; its DLT is
  rank-deficient, so rounding picks the hypothesis, ROADMAP Queue 3): such
  a sample wins in one package, and the best sample of distinct points
  scores the same in both.  The reference lane goes on from the port's
  result.
* `process_pending` on pushed streams equals `process_chunk` on the same
  frames (the front's noise is drawn in the same order), and makes the
  same keyframes pose-graph nodes at the same frames.
* `SlamSystem(cfg)` without `device` takes the card, and raises without one.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmono_tpu.config import synthetic_config
from lmono_tpu.loop import detector as jdet
from lmono_tpu.loop.posegraph import PoseGraph as JPoseGraph
from lmono_tpu.ops import ransac as jransac
from lmono_tpu.utils import lie as jl
from lmono_tpu.utils.lie import Pose as JPose
from lmono_tpu.pipeline import SlamSystem as JSlamSystem
from lmono_tpu_torch.config import SystemConfig
from lmono_tpu_torch.io import synthetic as syn
from lmono_tpu_torch.loop import detector as tdet
from lmono_tpu_torch.loop.detector import TOP_K
from lmono_tpu_torch.loop.posegraph import PoseGraph, graph_poses
from lmono_tpu_torch.ops import ransac as transac
from lmono_tpu_torch.pipeline import SlamSystem
from lmono_tpu_torch.utils import lie as tlie
from lmono_tpu_torch.utils.lie import Pose

K_OUT = 12                 # frames out; the drive has 2·K_OUT + 1
CHUNK = 5
GRAPH_START = 8            # the pose graph's first capacity here
POS_ATOL_M = 2e-2
_BASE = synthetic_config()
_T_CL = syn.synthetic_T_CL()
CFG = _BASE.replace(
    laser_to_camera=tuple(_T_CL.to_mat4().reshape(-1).tolist()),
    lidar=dataclasses.replace(_BASE.lidar, max_edge_features=256, max_planar_features=512,
                              map_edge_capacity=2048, map_planar_capacity=4096),
    camera=dataclasses.replace(_BASE.camera, width=256, height=128, fx=128.0, fy=128.0,
                               cx=128.0, cy=64.0),
    tracker=dataclasses.replace(_BASE.tracker, max_features=40, min_dist=16,
                                pyramid_levels=3, lk_patch=15),
    estimator=dataclasses.replace(_BASE.estimator, window_size=4, max_tracks=48),
    loop=dataclasses.replace(_BASE.loop, db_capacity=64, max_keypoints=96, window_points=40,
                             pnp_ransac_iters=32, kf_edge_points=128, kf_planar_points=256,
                             search_gap=3, search_time=0.9, skip_time=0.1, skip_dis=0.3,
                             min_brief_matches=10, refine_min_inliers=50, posegraph_iters=8),
    mapping=dataclasses.replace(_BASE.mapping, map_capacity=1 << 15))
TCFG = SystemConfig.from_json(CFG.to_json())


@functools.lru_cache(maxsize=None)
def _drive():
    """The out-and-back drive: stacked chunks of frames and the truth."""
    n = 2 * K_OUT + 1
    c = syn.circuit_trajectory(K_OUT + 1)
    idx = torch.tensor([i if i <= K_OUT else 2 * K_OUT - i for i in range(n)])
    traj = Pose(c.t[idx], c.q[idx])
    scene = syn.make_city_scene()
    g = torch.Generator().manual_seed(1)
    frames = []
    for i in range(n):
        p = Pose(traj.t[i], traj.q[i])
        s = syn.simulate_lidar(scene, p, TCFG.lidar, 0.01, generator=g)
        frames.append({**{k: s[k] for k in ("points", "ranges", "valid")},
                       "image": syn.render_camera(scene, p.compose(_T_CL.inverse()),
                                                  TCFG.camera)})
    chunks = [{k: torch.stack([f[k] for f in frames[c:c + CHUNK]]) for k in frames[0]}
              for c in range(0, n, CHUNK)]
    return chunks, traj


def _reference_keys():
    """The PnP keys of the reference detector's processed keyframes, in
    order: its key splits once per keyframe and once per candidate."""
    key = jax.random.PRNGKey(7)
    while True:
        k, key = jax.random.split(key)
        yield jax.random.split(k, TOP_K)


def _reference_noise():
    """The Gumbel noise behind those keys' PnP draws."""
    shape = (CFG.loop.pnp_ransac_iters, 6, CFG.loop.window_points)
    for keys in _reference_keys():
        yield torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(k, shape))
                                         for k in keys]))


@functools.lru_cache(maxsize=None)
def _port_run():
    """The port's run: (system, each chunk's outputs as numpy and its first
    frame, the trajectory, each processed keyframe's result and PnP
    inputs)."""
    chunks, _ = _drive()
    torch.set_num_threads(1)
    s = SlamSystem(TCFG, device="cpu", generator=torch.Generator().manual_seed(3))
    s._graph_cap = GRAPH_START
    s.graph = PoseGraph.empty(GRAPH_START, s.graph.loop_mask.shape[0], "cpu")
    noise = _reference_noise()
    s.loop.gumbel = lambda: next(noise)
    results, pnp = [], []
    detect_add = s.loop.detect_add
    s.loop.detect_add = lambda *a, **k: results.append(detect_add(*a, **k)) or results[-1]
    ransac_pnp = tdet.ransac_pnp
    tdet.ransac_pnp = lambda *a, **k: pnp.append((a, k)) or ransac_pnp(*a, **k)
    record = []
    try:
        for chunk in chunks:
            n0 = s.frame_idx
            outs = s.process_chunk(chunk, t0=n0 * 0.1)
            record.append(({k: v.numpy() for k, v in outs.items() if torch.is_tensor(v)},
                           n0))
    finally:
        tdet.ransac_pnp = ransac_pnp
    traj = s.final_trajectory()
    return s, record, traj, results, pnp


@pytest.fixture(scope="module")
def port_run():
    n = torch.get_num_threads()
    try:
        yield _port_run()
    finally:
        torch.set_num_threads(n)


def test_process_chunk_closes_the_lap(port_run, tmp_path):
    s, record, traj, _, _ = port_run
    chunks, truth = _drive()
    n = truth.t.shape[0]
    assert s.frame_idx == n and len(s._raw_poses) == n
    assert s.reaps >= 2 and s.n_loops >= 1 and s.graph_solves >= 1
    assert s.keyframes_processed == s._n_nodes >= GRAPH_START
    assert s.graph.t.shape[0] == 2 * GRAPH_START          # grew once
    assert int(s.graph.n_nodes) == s._n_nodes
    assert traj.t.shape == (n, 3) and traj.q.shape == (n, 4)
    assert bool(torch.isfinite(traj.t).all() and torch.isfinite(traj.q).all())
    # one read per chunk for the lane flags and one per reap (two where the
    # reap switched off a loop edge): nothing per keyframe
    assert s.readbacks <= len(chunks) + 2 * s.reaps
    path = tmp_path / "map.ply"
    n_pts = s.save_map(str(path))
    assert n_pts == s.mapper.n_points > 1000
    head = path.read_bytes()[:200].decode("ascii", "replace")
    assert head.startswith("ply") and f"element vertex {n_pts}" in head


def _agrees(res_t, res_j) -> bool:
    if any(int(getattr(res_t, f)) != int(getattr(res_j, f))
           for f in ("found", "old_seq", "refined")):
        return False
    if not bool(res_j.found):           # the pose of no closure is not used
        return True
    t_tol, q_tol = (1e-2, 1e-3) if bool(res_j.refined) else (1e-3, 1e-4)
    return (np.abs(res_t.rel_t.numpy() - np.asarray(res_j.rel_t)).max() <= t_tol
            and np.abs(res_t.rel_q.numpy() - np.asarray(res_j.rel_q)).max() <= q_tol)


@jax.jit
def _reference_scores(X, x, mask, samp, thresh):
    """The reference's sampled PnP hypotheses' inlier counts (its helpers,
    vectorized over the samples)."""
    def hyp(idx):
        R, t = jransac._dlt_pnp(X[idx], x[idx])
        w = jnp.zeros((X.shape[0],), X.dtype).at[idx].set(1.0)
        pose = jransac._pnp_gn_refine(R, t, X, x, w, iters=8)
        e2 = jransac._reproj_err2(jl.quat_to_mat(pose.q), pose.t, X, x)
        return jnp.sum((e2 < thresh) & mask)

    return jax.vmap(hyp)(samp)


def _hypothesis_scores(X, x, mask, samp, thresh):
    """Each sampled PnP hypothesis's inlier count in both packages:
    (reference, port)."""
    ref = np.asarray(_reference_scores(*[jnp.asarray(a.numpy()) for a in (X, x, mask, samp)],
                                       np.float32(thresh)))
    R, t = transac._dlt_pnp(X[samp], x[samp])
    w = torch.zeros(samp.shape[:-1] + (X.shape[0],)).scatter(-1, samp, 1.0)
    pose = transac._pnp_gn_refine(R, t, X[None], x[None], w, iters=8)
    e2 = transac._reproj_err2(tlie.quat_to_mat(pose.q), pose.t, X[None], x[None])
    return ref, torch.sum((e2 < thresh) & mask[None], -1).numpy()


@functools.lru_cache(maxsize=None)
def _jit_pnp(iters, thresh, min_inliers):
    """The reference's `ransac_pnp` compiled alone (not inside the keyframe
    program, whose fusions move it on near-degenerate sets)."""
    return jax.jit(lambda X, x, m, key, prior: jransac.ransac_pnp(
        X, x, m, key, iters=iters, thresh=thresh, min_inliers=min_inliers,
        prior_pose=prior))


def _pnp_matches_op_by_op(inputs, keys) -> None:
    """The port's PnP on one keyframe's candidates against the reference's
    `ransac_pnp` run op by op on the same inputs and draws.  Where the two
    part, the cause must be a degenerate minimal sample: the draws are with
    replacement, and a sample with a repeated point leaves the 12×12 DLT
    rank-deficient, so rounding picks its null vector and the hypothesis is
    arbitrary in both packages.  Such a sample must win in at least one of
    them, and the best hypothesis from six distinct points must score the
    same in both."""
    (X, x, mask, gumbel), kw = inputs
    for c in range(TOP_K):
        prior = kw["prior_pose"]
        pose, inl, ok = tdet.ransac_pnp(
            X, x[c], mask[c], gumbel[c], thresh=kw["thresh"],
            min_inliers=kw["min_inliers"], prior_pose=type(prior)(prior.t[c], prior.q[c]))
        jpose, jinl, jok = _jit_pnp(gumbel.shape[1], kw["thresh"], kw["min_inliers"])(
            *[jnp.asarray(a.numpy()) for a in (X, x[c], mask[c])], keys[c],
            JPose(jnp.asarray(prior.t[c].numpy()), jnp.asarray(prior.q[c].numpy())))
        if (np.array_equal(inl.numpy(), np.asarray(jinl)) and bool(ok) == bool(jok)
                and np.abs(pose.t.numpy() - np.asarray(jpose.t)).max() <= 1e-4
                and np.abs(pose.q.numpy() - np.asarray(jpose.q)).max() <= 1e-4):
            continue
        samp = transac.masked_categorical(mask[c][None, None, :], gumbel[c])
        distinct = torch.tensor([len(set(r.tolist())) == r.numel() for r in samp])
        ref, port = _hypothesis_scores(X, x[c], mask[c], samp, kw["thresh"])
        assert not (distinct[int(np.argmax(ref))] and distinct[int(np.argmax(port))]), c
        d = distinct.numpy()
        assert port[d].max() == ref[d].max(), (c, port, ref, d)


def test_loop_lane_matches_the_reference(port_run):
    s, record, _, port_results, port_pnp = port_run
    ref = JSlamSystem(CFG, enable_loop=True, enable_mapping=False)
    ref._graph_cap = GRAPH_START
    ref.graph = JPoseGraph.empty(GRAPH_START, max_loops=s.graph.loop_mask.shape[0])
    jitted = ref.loop._process_fused
    keys = _reference_keys()
    op_by_op = []

    def keyframe(*args, **kwargs):
        # the n-th processed keyframe: where the jitted program parts from
        # the port, the port's PnP must be the reference's op-by-op PnP,
        # and the lane goes on from the port's result
        n = len(op_by_op)
        out = jitted(*args, **kwargs)
        kf_keys = next(keys)
        op_by_op.append(not _agrees(port_results[n], jax.device_get(out[0])))
        if op_by_op[-1]:
            _pnp_matches_op_by_op(port_pnp[n], kf_keys)
            res = jdet.LoopResult(**{f: np.asarray(getattr(port_results[n], f))
                                     for f in jdet.LoopResult._fields})
            out = (res, *out[1:])
        return out

    ref.loop._process_fused = keyframe
    chunks, _ = _drive()
    for (outs, n0), chunk in zip(record, chunks):
        ref._reap_loops()
        frames = {"image": chunk["image"].numpy()}
        for i in range(outs["pose_t"].shape[0]):
            if outs["is_keyframe"][i] and outs["initialized"][i]:
                # the time as `process_chunk` computes it: the skip gate
                # compares differences of exactly 0.1 s with 0.1 s
                ref._loop_lane_chunk(outs, frames, i, n0 * 0.1 + i * 0.1, outs["ccam_t"][i],
                                     n0 + i)
        ref.frame_idx += outs["pose_t"].shape[0]
    ref._reap_loops()
    assert len(op_by_op) == len(port_results) == s.keyframes_processed
    assert ref._n_nodes == s._n_nodes and ref._node_frames == s._node_frames
    assert ref.n_loops == s.n_loops >= 1
    g, jg = s.graph, jax.device_get(ref.graph)
    L = s.n_loops
    for f in ("loop_i", "loop_j", "loop_mask", "loop_w"):
        np.testing.assert_array_equal(getattr(g, f)[:L].numpy(), np.asarray(getattr(jg, f))[:L],
                                      err_msg=f)
    n = s._n_nodes
    np.testing.assert_allclose(graph_poses(g).t[:n].numpy(), np.asarray(jg.t)[:n], rtol=0,
                               atol=POS_ATOL_M)


def test_process_pending_matches_process_chunk():
    chunks, _ = _drive()
    chunk = chunks[0]
    cfg = TCFG.replace(lidar=dataclasses.replace(TCFG.lidar, max_edge_features=128,
                                                 max_planar_features=256))
    a = SlamSystem(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    outs = a.process_chunk(chunk)
    b = SlamSystem(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    for i in range(CHUNK):
        b.push_image(0.1 * i, chunk["image"][i])
        b.push_scan(0.1 * i, {k: chunk[k][i] for k in ("points", "ranges", "valid")})
    res = b.process_pending()
    assert len(res) == CHUNK and b.frame_idx == a.frame_idx == CHUNK
    for i, r in enumerate(res):
        assert torch.equal(r["pose_raw"].t, outs["pose_t"][i])
        assert torch.equal(r["pose_raw"].q, outs["pose_q"][i])
        assert r["is_keyframe"] == bool(outs["is_keyframe"][i])
        assert r["initialized"] == bool(outs["initialized"][i])
    # the same keyframes become nodes, at the same frames
    assert a._node_frames == b._node_frames and a._node_frames


def test_runs_on_the_card_unless_asked_for_the_cpu():
    cfg = TCFG.replace(mapping=dataclasses.replace(TCFG.mapping, map_capacity=1024))
    if torch.cuda.is_available():
        s = SlamSystem(cfg)
        assert s.device.type == "cuda" and s.loop.device.type == "cuda"
        assert s.mapper.map.points.is_cuda and s.graph.t.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SlamSystem(cfg)
    s = SlamSystem(cfg, device="cpu")
    assert s.device == torch.device("cpu") and not s.graph.t.is_cuda
    assert s.loop.device == s.front.device == torch.device("cpu")
