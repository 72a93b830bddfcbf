"""Shared inputs of the estimator-slice parity tests (`test_torch_*.py`):
window problems and track sequences made from a seed with numpy, built as
JAX states and handed to the port as numpy through `lmono_tpu_torch.convert`.
Not a test module."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmono_tpu.config import EstimatorConfig
from lmono_tpu.estimator.tracker import TrackOutput as JTrack
from lmono_tpu.estimator.window import FeatureTable, MargPrior, WindowState
from lmono_tpu.io.synthetic import synthetic_T_CL
from lmono_tpu.utils import lie as jl
from lmono_tpu_torch.convert import window_state_from_numpy
from lmono_tpu_torch.estimator.tracker import TrackOutput as TTrack

CFG = EstimatorConfig(window_size=4, max_tracks=48, gn_iters=10,
                      estimate_laser=1, fine_times=1000)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test of a module that imports this fixture runs the port on one
    torch thread: the estimator's many small ops slow down manifold when
    the thread pools of parallel test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _project(T_CL, t, q, pts):
    p_c = T_CL.apply(jl.quat_rotate_inv(q, pts - t))
    return p_c[..., :2] / p_c[..., 2:3], p_c[..., 2]


def window_problem(seed=0, cfg=CFG, yaw_rate=0.02, count=None, prior=False):
    """A JAX `WindowState` of an exact window (smooth forward motion with a
    modulated twist, a landmark cloud ahead) and its true landmark depths.

    count: frames in the window (default: full).  prior: a random valid
    marginalization prior (random J, r0, a nearby linearization point).
    """
    rng = np.random.default_rng(seed)
    W1, M = cfg.window_size + 1, cfg.max_tracks
    ts = np.arange(W1, dtype=np.float32)
    t = np.stack([ts, 0.02 * ts ** 2, np.zeros_like(ts)], -1)
    th = np.stack([0.2 * yaw_rate * ts + 0.1 * yaw_rate * np.sin(1.7 * ts),
                   0.5 * yaw_rate * ts - 0.2 * yaw_rate * np.cos(1.3 * ts),
                   yaw_rate * ts + 0.3 * yaw_rate * np.sin(0.9 * ts)], -1)
    q = jl.so3_exp_quat(jnp.asarray(th, jnp.float32))
    T_CL = synthetic_T_CL()
    lm = np.stack([rng.uniform(5.0, 25.0, M), rng.uniform(-8.0, 8.0, M),
                   rng.uniform(-8.0, 8.0, M) * 0.3 + 1.0], -1).astype(np.float32)
    obs, z = _project(T_CL, jnp.asarray(t)[None], q[None], jnp.asarray(lm)[:, None])
    obs_mask = np.asarray(z) > 1.0
    anchor = np.argmax(obs_mask, axis=1).astype(np.int32)
    inv_depth = 1.0 / np.asarray(z)[np.arange(M), anchor]
    n = W1 if count is None else count
    state = WindowState.init(cfg, T_CL)._replace(
        t=jnp.asarray(t), q=q, lt=jnp.asarray(t), lq=q,
        feats=FeatureTable(
            ids=jnp.arange(M, dtype=jnp.int32), anchor=jnp.asarray(anchor),
            obs=obs, obs_mask=jnp.asarray(obs_mask),
            inv_depth=jnp.asarray(inv_depth, jnp.float32),
            depth_ok=jnp.ones(M, bool), alive=jnp.ones(M, bool)),
        count=jnp.asarray(n, jnp.int32), initialized=jnp.ones((), bool))
    if prior:
        D = 6 * W1 + 6
        dth = 0.01 * rng.normal(size=(W1, 3)).astype(np.float32)
        state = state._replace(prior=MargPrior(
            J=jnp.asarray(rng.normal(size=(D, D)).astype(np.float32)),
            r0=jnp.asarray(rng.normal(size=D).astype(np.float32)),
            lin_t=state.t + jnp.asarray(0.05 * rng.normal(size=(W1, 3)), jnp.float32),
            lin_q=jl.boxplus(state.q, jnp.asarray(dth)),
            lin_ex_t=state.ex_t + 0.01, lin_ex_q=jl.boxplus(
                state.ex_q, jnp.asarray([0.01, -0.02, 0.005], jnp.float32)),
            valid=jnp.ones((), bool)))
    return state, inv_depth


def perturb(state, seed=5, dp=0.1, dth=0.02, ddepth=0.2):
    """Poses (not slot 0: the gauge) and depths moved off the truth."""
    rng = np.random.default_rng(seed)
    W1 = state.t.shape[0]
    M = state.feats.inv_depth.shape[0]
    d_t = dp * rng.normal(size=(W1, 3)).astype(np.float32)
    d_th = dth * rng.normal(size=(W1, 3)).astype(np.float32)
    d_t[0] = d_th[0] = 0.0
    scale = 1.0 + ddepth * rng.normal(size=M).astype(np.float32)
    return state._replace(
        t=state.t + d_t, q=jl.boxplus(state.q, jnp.asarray(d_th)),
        feats=state.feats._replace(inv_depth=state.feats.inv_depth * scale))


def to_port(jstate):
    """A JAX `WindowState` → the port's, on the CPU."""
    return window_state_from_numpy(jax.device_get(jstate), device="cpu")


def track_sequence(n, n_slots=48, seed=0, n_landmarks=400, slow=(9, 10, 11),
                   norm_noise=1e-3, t_std=0.01, r_std=0.002):
    """Feature tracks and noisy laser poses along a forward drive past a
    landmark corridor.  Frames in `slow` barely move (non-keyframes).

    Returns (list of numpy track dicts {ids, norm, alive}, laser (t, q)
    numpy arrays (n,3)/(n,4), ground truth (t, q))."""
    rng = np.random.default_rng(seed)
    lm = np.stack([rng.uniform(2.0, 60.0, n_landmarks),
                   rng.uniform(-12.0, 12.0, n_landmarks),
                   rng.uniform(-1.5, 5.0, n_landmarks)], -1).astype(np.float32)
    speed = np.array([0.05 if i in slow else 0.9 for i in range(n)], np.float32)
    x = np.concatenate([[0.0], np.cumsum(speed[1:])]).astype(np.float32)
    i = np.arange(n, dtype=np.float32)
    gt_t = np.stack([x, 0.3 * np.sin(0.2 * i), 0.05 * np.sin(0.5 * i)], -1)
    th = np.stack([0.01 * np.sin(0.7 * i), 0.01 * np.cos(0.4 * i),
                   0.04 * i + 0.03 * np.sin(0.9 * i)], -1).astype(np.float32)
    gt_q = np.asarray(jl.so3_exp_quat(jnp.asarray(th)))
    T_CL = synthetic_T_CL()
    tracks = []
    for k in range(n):
        uv, z = _project(T_CL, jnp.asarray(gt_t[k]), jnp.asarray(gt_q[k]),
                         jnp.asarray(lm))
        uv, z = np.asarray(uv), np.asarray(z)
        vis = (z > 1.0) & (np.abs(uv[:, 0]) < 1.0) & (np.abs(uv[:, 1]) < 0.6)
        ids = np.flatnonzero(vis)[:n_slots]
        m = len(ids)
        out = {"ids": np.full(n_slots, -1, np.int32),
               "norm": np.zeros((n_slots, 2), np.float32),
               "alive": np.zeros(n_slots, bool)}
        out["ids"][:m] = ids
        out["norm"][:m] = uv[ids] + norm_noise * rng.normal(size=(m, 2))
        out["alive"][:m] = True
        tracks.append(out)
    # odometry: ground-truth relative motion integrated with per-step noise
    lt, lq = [gt_t[0]], [gt_q[0]]
    for k in range(1, n):
        rel = jl.Pose(gt_t[k - 1], gt_q[k - 1]).between(jl.Pose(gt_t[k], gt_q[k]))
        rel = jl.Pose(rel.t + t_std * rng.normal(size=3).astype(np.float32),
                      jl.boxplus(rel.q, jnp.asarray(
                          r_std * rng.normal(size=3).astype(np.float32))))
        p = jl.Pose(lt[-1], lq[-1]).compose(rel)
        lt.append(np.asarray(p.t))
        lq.append(np.asarray(p.q))
    return tracks, (np.stack(lt), np.stack(lq)), (gt_t, gt_q)


def jax_track(d):
    z2 = jnp.zeros(d["norm"].shape, jnp.float32)
    n = d["ids"].shape[0]
    return JTrack(ids=jnp.asarray(d["ids"]), uv=z2, norm=jnp.asarray(d["norm"]),
                  velocity=z2, track_cnt=jnp.zeros(n, jnp.int32),
                  alive=jnp.asarray(d["alive"]))


def port_track(d):
    z2 = torch.zeros(d["norm"].shape)
    n = d["ids"].shape[0]
    return TTrack(ids=torch.from_numpy(d["ids"]), uv=z2,
                  norm=torch.from_numpy(d["norm"]), velocity=z2,
                  track_cnt=torch.zeros(n, dtype=torch.int32),
                  alive=torch.from_numpy(d["alive"]))


@functools.lru_cache(maxsize=None)
def jitted(fn, cfg):
    """The JAX function `fn(*args, cfg)` jitted with `cfg` closed over, one
    compile per (fn, cfg) in a test process."""
    return jax.jit(lambda *args: fn(*args, cfg))
