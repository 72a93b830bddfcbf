"""The port's fusion estimator (`lmono_tpu_torch.estimator.estimator`)
against `lmono_tpu.estimator.estimator`, on feature tracks and noisy laser
poses made from a seed with numpy (a forward drive past a landmark
corridor, with three slow frames that make non-keyframes).

Teacher-forced: every frame of a 16-frame JAX run (window 4, 48 tracks)
starts the port from the JAX state before it (`estimator_state_from_numpy`)
and is fed the same tracks, laser pose and relative-pose noise
(`jax.random.gumbel(key, (96, 8, N))`).  estimate_laser 1, and 2 with a
hand-eye ring pre-filled to within a few pairs of adoption.  Tolerances:
pose within 1 mm and 1e-4 in q, `is_keyframe` and `initialized` equal, both
slide kinds reached; the read-backs counted as the design says.

Free-running: `FusionEstimator` over the same 16 frames, poses within 1 cm
and 1e-3 in q of the JAX run's (the odometry's bound).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmono_tpu.estimator import estimator as je
from lmono_tpu.estimator.initializer import HandEyeState as JHandEye
from lmono_tpu.io.synthetic import synthetic_T_CL
from lmono_tpu.utils import lie as jl
from lmono_tpu_torch.convert import estimator_state_from_numpy
from lmono_tpu_torch.estimator import estimator as te
from lmono_tpu_torch.estimator.initializer import RP_ITERS
from lmono_tpu_torch.utils.lie import Pose as TPose
from torch_estimator_cases import (
    CFG,
    jax_track,
    one_torch_thread,
    port_track,
    track_sequence,
)

N_FRAMES = 16
T_ATOL_M, Q_ATOL = 1e-3, 1e-4
FREE_T_ATOL_M, FREE_Q_ATOL = 1e-2, 1e-3


def _cfg(el):
    return dataclasses.replace(CFG, estimate_laser=el, fine_times=3)


def _t_cl():
    T = synthetic_T_CL()
    return T, TPose(torch.tensor(np.array(T.t)), torch.tensor(np.array(T.q)))


def _prefilled_handeye(n=56, stable=12, seed=3):
    """A ring of n consistent rotation pairs of the true extrinsic, the
    estimate on it and `stable` quiet updates: a few good pairs from
    adoption."""
    rng = np.random.default_rng(seed)
    X = synthetic_T_CL().q
    he = JHandEye.init()
    q_las = jl.so3_exp_quat(jnp.asarray(rng.normal(scale=0.08, size=(n, 3)), jnp.float32))
    q_cam = jl.quat_mul(jl.quat_mul(X[None], q_las), jl.quat_conj(X)[None])
    return he._replace(q_cam=he.q_cam.at[:n].set(q_cam), q_las=he.q_las.at[:n].set(q_las),
                       mask=he.mask.at[:n].set(True), n=jnp.asarray(n, jnp.int32),
                       q_ex=X, stable=jnp.asarray(stable, jnp.int32))


def _gumbel(i, n):
    return jax.random.PRNGKey(100 + i), jax.random.gumbel(
        jax.random.PRNGKey(100 + i), (RP_ITERS, 8, n))


@functools.lru_cache(maxsize=None)
def _jax_run(el):
    """The JAX run: (tracks, laser, states before each frame, outputs)."""
    cfg = _cfg(el)
    tracks, laser, _ = track_sequence(N_FRAMES)
    n = tracks[0]["ids"].shape[0]
    state = je.EstimatorState.init(cfg, synthetic_T_CL(), n)
    if el == 2:
        state = state._replace(handeye=_prefilled_handeye())
    step = jax.jit(lambda s, tr, t, q, k: je.fusion_step(s, tr, jl.Pose(t, q), cfg, k))
    states, outs = [], []
    for i in range(N_FRAMES):
        states.append(jax.device_get(state))
        state, out = step(state, jax_track(tracks[i]), laser[0][i], laser[1][i],
                          _gumbel(i, n)[0])
        outs.append(jax.device_get(out))
    return tracks, laser, states, outs


@pytest.mark.parametrize("el", [1, 2])
def test_teacher_forced_steps_match(el):
    cfg = _cfg(el)
    tracks, (lt, lq), states, outs = _jax_run(el)
    kinds, solved = set(), 0
    for i in range(N_FRAMES):
        ts, count = estimator_state_from_numpy(states[i], device="cpu")
        assert count == min(i, cfg.window_size)
        g = torch.from_numpy(np.array(_gumbel(i, 48)[1])) if el == 2 else None
        _, out = te.fusion_step(ts, port_track(tracks[i]),
                                TPose(torch.from_numpy(lt[i]), torch.from_numpy(lq[i])),
                                cfg, count, g)
        ref = outs[i]
        np.testing.assert_allclose(out.pose.t.numpy(), ref.pose.t, rtol=0, atol=T_ATOL_M)
        np.testing.assert_allclose(out.pose.q.numpy(), ref.pose.q, rtol=0, atol=Q_ATOL)
        np.testing.assert_allclose(out.extrinsic.q.numpy(), ref.extrinsic.q, rtol=0,
                                   atol=Q_ATOL)
        assert bool(out.is_keyframe) == bool(ref.is_keyframe), i
        assert bool(out.initialized) == bool(ref.initialized), i
        assert out.keyframe_slot == int(ref.keyframe_slot)
        full = count + 1 > cfg.window_size
        if full:
            kinds.add(bool(ref.is_keyframe))
        # one read for the slide (and readiness), one per LM attempt but the last
        want = 0 if not full else 1 + min(out.lm_attempts, cfg.gn_iters - 1)
        assert out.readbacks == want
        assert out.lm_replayed == 0
        solved += out.lm_attempts > 0
    assert kinds == {True, False}, "both slide kinds"
    # estimate_laser 2 adopts the hand-eye rotation mid-run, then solves
    assert solved >= (N_FRAMES - cfg.window_size if el == 1 else 3)
    assert bool(outs[-1].initialized)


def test_free_running_estimator_matches():
    tracks, (lt, lq), _, outs = _jax_run(1)
    est = te.FusionEstimator(_cfg(1), _t_cl()[1], n_tracks=48, device="cpu")
    for i in range(N_FRAMES):
        out = est.process(port_track(tracks[i]),
                          TPose(torch.from_numpy(lt[i]), torch.from_numpy(lq[i])))
        np.testing.assert_allclose(out.pose.t.numpy(), outs[i].pose.t, rtol=0,
                                   atol=FREE_T_ATOL_M)
        np.testing.assert_allclose(out.pose.q.numpy(), outs[i].pose.q, rtol=0,
                                   atol=FREE_Q_ATOL)
    assert est.count == CFG.window_size and bool(out.initialized)


def test_state_from_numpy_matches_init():
    cfg = _cfg(2)
    j = jax.device_get(je.EstimatorState.init(cfg, synthetic_T_CL(), 48))
    t, count = estimator_state_from_numpy(j)
    ref = te.EstimatorState.init(cfg, _t_cl()[1], 48)
    assert count == 0

    def leaves(nt):
        for x in nt:
            yield from ([x] if isinstance(x, torch.Tensor) else leaves(x))

    for a, b in zip(leaves(t), leaves(ref), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_runs_on_the_card_unless_asked_for_the_cpu():
    from lmono_tpu_torch.estimator import FusionEstimator

    if torch.cuda.is_available():
        est = FusionEstimator(CFG)
        assert est.device.type == "cuda" and est.state.window.t.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FusionEstimator(CFG)
    est = FusionEstimator(CFG, device="cpu")
    assert est.device == torch.device("cpu") and not est.state.window.t.is_cuda
    assert est.gumbel().shape == (RP_ITERS, 8, CFG.max_tracks)
