"""The port's trajectory files, RPE, the remaining Lie helpers and the
input log, against the JAX package's.

* `rpe` within 1e-5 of `lmono_tpu.eval.ate.rpe`.
* `save_tum` / `save_kitti_poses` write the same bytes as the reference's
  writers on the same poses; `load_tum` / `load_kitti_poses` read them back
  as the reference's loaders do (within 1e-6).
* `so3_exp_mat`, `so3_log_mat` and `pose_slerp` within 1e-6.
* `InputLog` round-trips bitwise, and a log written by either package loads
  in the other.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmono_tpu.eval import ate as jate
from lmono_tpu.eval import kitti_metrics as jkm
from lmono_tpu.io.replay import InputLog as JInputLog
from lmono_tpu.utils import lie as jl
from lmono_tpu_torch.eval import (load_kitti_poses, load_tum, rpe,
                                  save_kitti_poses, save_tum)
from lmono_tpu_torch.io import InputLog
from lmono_tpu_torch.utils import lie as tl


def _poses(n: int, seed: int, noise: float = 0.0, base=None):
    """n poses along a wobbly path (numpy f32 t, unit w-first q)."""
    rng = np.random.RandomState(seed)
    s = np.arange(n, dtype=np.float64)
    t = np.stack([3 * np.cos(0.1 * s), 3 * np.sin(0.1 * s), 0.05 * s], -1)
    th = np.stack([0.02 * np.sin(s), 0.03 * np.cos(0.5 * s), 0.1 * s], -1)
    if base is not None:
        t, th = base
    t = t + noise * rng.randn(*t.shape)
    th = th + noise * rng.randn(*th.shape)
    q = np.array(jl.so3_exp_quat(jnp.asarray(th, jnp.float32)))
    return t.astype(np.float32), q, (t, th)


def _both(t, q):
    return (jl.Pose(jnp.asarray(t), jnp.asarray(q)),
            tl.Pose(torch.from_numpy(t), torch.from_numpy(q)))


@pytest.mark.parametrize("delta", [1, 10, 40])
def test_rpe_matches_reference(delta):
    t, q, base = _poses(60, seed=0)
    t2, q2, _ = _poses(60, seed=1, noise=0.02, base=base)
    (gj, gt), (ej, et) = _both(t, q), _both(t2, q2)
    a, b = jate.rpe(ej, gj, delta), rpe(et, gt, delta)
    assert set(a) == set(b)
    for k in a:
        assert abs(a[k] - b[k]) <= 1e-5, (k, a[k], b[k])


def test_trajectory_files_equal_the_reference_writers(tmp_path):
    t, q, _ = _poses(25, seed=2, noise=0.01)
    pj, pt = _both(t, q)
    times = np.arange(25) * 0.1 + 1234.5
    for name, jsave, tsave, args in [
            ("tum", jate.save_tum, save_tum, ()),
            ("tum_t", jate.save_tum, save_tum, (times,)),
            ("kitti", jkm.save_kitti_poses, save_kitti_poses, ())]:
        jsave(str(tmp_path / f"{name}_j.txt"), pj, *args)
        tsave(str(tmp_path / f"{name}_t.txt"), pt, *args)
        assert ((tmp_path / f"{name}_j.txt").read_bytes()
                == (tmp_path / f"{name}_t.txt").read_bytes()), name
    # the loaders read them back as the reference's do
    tj, lj = jate.load_tum(str(tmp_path / "tum_t_t.txt"))
    tt, lt = load_tum(str(tmp_path / "tum_t_t.txt"))
    np.testing.assert_array_equal(tt, tj)
    for a, b in ((lt, lj), (load_kitti_poses(str(tmp_path / "kitti_t.txt")),
                            jkm.load_kitti_poses(str(tmp_path / "kitti_t.txt")))):
        assert a.t.dtype == a.q.dtype == torch.float32
        np.testing.assert_allclose(a.t.numpy(), np.asarray(b.t), atol=1e-6)
        np.testing.assert_allclose(a.q.numpy(), np.asarray(b.q), atol=1e-6)
        np.testing.assert_allclose(a.t.numpy(), t, atol=1e-5)


def test_lie_leftovers_match_reference():
    rng = np.random.RandomState(4)
    th = (rng.randn(64, 3) * np.array([[1.0], [1e-5], [3.0], [0.0]]).repeat(16, 0)
          ).astype(np.float32)
    mj = np.asarray(jl.so3_exp_mat(jnp.asarray(th)))
    mt = tl.so3_exp_mat(torch.from_numpy(th)).numpy()
    np.testing.assert_allclose(mt, mj, atol=1e-6)
    np.testing.assert_allclose(tl.so3_log_mat(torch.from_numpy(mj)).numpy(),
                               np.asarray(jl.so3_log_mat(jnp.asarray(mj))), atol=1e-6)
    t0, q0, _ = _poses(8, seed=5, noise=0.3)
    t1, q1, _ = _poses(8, seed=6, noise=0.3)
    alpha = np.linspace(-0.25, 1.25, 8).astype(np.float32)
    (a0, b0), (a1, b1) = _both(t0, q0), _both(t1, q1)
    pj = jl.pose_slerp(a0, a1, jnp.asarray(alpha))
    pt = tl.pose_slerp(b0, b1, torch.from_numpy(alpha))
    np.testing.assert_allclose(pt.t.numpy(), np.asarray(pj.t), atol=1e-6)
    np.testing.assert_allclose(pt.q.numpy(), np.asarray(pj.q), atol=1e-6)
    # a scalar alpha between two single poses
    one = tl.pose_slerp(tl.Pose(b0.t[0], b0.q[0]), tl.Pose(b1.t[0], b1.q[0]), 0.5)
    ref = jl.pose_slerp(jl.Pose(a0.t[0], a0.q[0]), jl.Pose(a1.t[0], a1.q[0]), 0.5)
    np.testing.assert_allclose(one.q.numpy(), np.asarray(ref.q), atol=1e-6)


def _frames(seed: int):
    rng = np.random.RandomState(seed)
    return [{"points": rng.randn(4, 8, 3).astype(np.float32),
             "valid": rng.rand(4, 8) > 0.5,
             "image": rng.rand(6, 10).astype(np.float32),
             "time": np.float64(0.1 * i), "index": i, "skip": None}
            for i in range(3)]


def test_input_log_round_trips_across_packages(tmp_path):
    frames = _frames(7)
    tlog = InputLog()
    for f in frames:
        tlog.append({**f, "points": torch.from_numpy(f["points"])})
    tlog.save(str(tmp_path / "t.npz"))
    jlog = JInputLog()
    for f in frames:
        jlog.append(f)
    jlog.save(str(tmp_path / "j.npz"))
    for path in ("t.npz", "j.npz"):
        for loaded in (InputLog.load(str(tmp_path / path)),
                       JInputLog.load(str(tmp_path / path))):
            assert len(loaded) == len(frames)
            for got, f in zip(loaded, frames):
                assert set(got) == {k for k, v in f.items() if v is not None}
                for k in got:
                    assert got[k].dtype == np.asarray(f[k]).dtype, k
                    np.testing.assert_array_equal(got[k], f[k])
