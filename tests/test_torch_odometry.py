"""The odometry slice as a whole: the port's `LidarOdometry` against
`lmono_tpu.lidar.odometry` on the same noisy frames.

Frames are made once by the JAX simulator and handed to both packages as
numpy.  Tolerances: per-frame translation within 1 cm and quaternion within
1e-3, and ATE within 5 mm of the reference's.  The reference itself moves
by that much when its input moves by one ulp: scaling the scan points by
(1 + 2⁻²³) shifts its 6-frame synthetic trajectory by up to 5 mm and 3.7e-4
in q (CPU).  The cause is its plane fit: neighbours taken along one scan
ring are nearly collinear, the smallest-eigenvalue normal of such a set is
ill-conditioned, and `plane_ok` still accepts it.  f32 sums in another
order change those normals, so no tighter bound holds for an
implementation that does not reproduce XLA's rounding bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmono_tpu.config import synthetic_config
from lmono_tpu.io import synthetic as jsyn
from lmono_tpu.lidar import odometry as jo
from lmono_tpu.utils.lie import Pose as JPose
from lmono_tpu_torch.convert import odometry_state_from_numpy
from lmono_tpu_torch.eval.ate import ate_rmse
from lmono_tpu_torch.lidar import odometry as to
from lmono_tpu_torch.ops import knn as tknn
from lmono_tpu_torch.utils.lie import Pose as TPose

T_ATOL_M = 1e-2
Q_ATOL = 1e-3
ATE_ATOL_M = 5e-3
N_FRAMES = 6


@pytest.fixture(scope="module")
def frames():
    cfg = synthetic_config().lidar
    scene = jsyn.make_city_scene()
    traj = jsyn.circuit_trajectory(N_FRAMES + 1)
    sim = jax.jit(lambda p, k: jsyn.simulate_lidar(scene, p, cfg, noise_std=0.01, key=k))
    scans = [sim(JPose(traj.t[i], traj.q[i]), jax.random.PRNGKey(100 + i))
             for i in range(N_FRAMES + 1)]
    stacked = {k: np.stack([np.asarray(s[k]) for s in scans])
               for k in ("points", "ranges", "valid")}
    return cfg, stacked, np.array(traj.t[:N_FRAMES]), np.array(traj.q[:N_FRAMES])


def _jax_run(cfg, scans, state=None):
    state = jo.OdometryState.init(cfg) if state is None else state
    return jax.jit(lambda s, sc: jo.odometry_scan(s, sc, cfg))(
        state, {k: jnp.asarray(v) for k, v in scans.items()})


def test_slice_matches_jax_frame_by_frame(frames):
    cfg, stacked, gt_t, gt_q = frames
    scans = {k: v[:N_FRAMES] for k, v in stacked.items()}
    _, jout = _jax_run(cfg, scans)
    odo = to.LidarOdometry(cfg, device="cpu")
    tout = odo.process_chunk(scans)
    assert odo.frame == N_FRAMES and int(odo.state.frame) == N_FRAMES
    np.testing.assert_allclose(tout["pose"].t.numpy(), np.asarray(jout["pose"].t),
                               rtol=0, atol=T_ATOL_M)
    np.testing.assert_allclose(tout["pose"].q.numpy(), np.asarray(jout["pose"].q),
                               rtol=0, atol=Q_ATOL)
    np.testing.assert_array_equal(tout["n_edge"].numpy(), np.asarray(jout["n_edge"]))
    np.testing.assert_array_equal(tout["n_planar"].numpy(), np.asarray(jout["n_planar"]))
    ate = ate_rmse(tout["pose"], TPose(torch.from_numpy(gt_t), torch.from_numpy(gt_q)))
    ate_ref = ate_rmse(tout["pose"]._replace(t=torch.from_numpy(np.array(jout["pose"].t))),
                       TPose(torch.from_numpy(gt_t), torch.from_numpy(gt_q)))
    assert abs(ate - ate_ref) < ATE_ATOL_M
    # frame 0 keeps the prior (identity); later frames moved
    assert float(tout["pose"].t[0].abs().max()) == 0.0
    assert float(tout["pose"].t[-1].norm()) > 1.0


def test_process_matches_process_chunk(frames):
    cfg, stacked = frames[:2]
    a = to.LidarOdometry(cfg, device="cpu")
    chunk = a.process_chunk({k: v[:3] for k, v in stacked.items()})
    b = to.LidarOdometry(cfg, device="cpu")
    for i in range(3):
        out = b.process({k: v[i] for k, v in stacked.items()})
        assert torch.equal(out["pose"].t, chunk["pose"].t[i])
    assert torch.equal(a.state.edge_map.points, b.state.edge_map.points)


def test_state_carried_over_from_jax(frames):
    cfg, stacked = frames[:2]
    first = {k: v[:3] for k, v in stacked.items()}
    jstate, _ = _jax_run(cfg, first)
    host = jax.device_get(jstate)
    nxt = {k: v[3:4] for k, v in stacked.items()}
    _, jout = _jax_run(cfg, nxt, jstate)

    odo = to.LidarOdometry(cfg, device="cpu")
    odo.state, odo.frame = odometry_state_from_numpy(host, device="cpu")
    assert odo.frame == 3
    np.testing.assert_array_equal(odo.state.plane_map.points.numpy(),
                                  np.asarray(host.plane_map.points))
    calls = tknn.knn_plain_calls
    tout = odo.process({k: v[0] for k, v in nxt.items()})
    # 2 KNN searches per outer re-association
    assert tknn.knn_plain_calls - calls == 2 * ((cfg.scan_to_map_iters + 1) // 2)
    np.testing.assert_allclose(tout["pose"].t.numpy(), np.asarray(jout["pose"].t[0]),
                               rtol=0, atol=T_ATOL_M)
    np.testing.assert_allclose(tout["pose"].q.numpy(), np.asarray(jout["pose"].q[0]),
                               rtol=0, atol=Q_ATOL)


def test_runs_on_the_card_unless_asked_for_the_cpu():
    # no quiet CPU default: the card, or an error naming the way to the CPU
    cfg = synthetic_config().lidar
    if torch.cuda.is_available():
        assert to.LidarOdometry(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            to.LidarOdometry(cfg)
    assert to.LidarOdometry(cfg, device="cpu").device == torch.device("cpu")
