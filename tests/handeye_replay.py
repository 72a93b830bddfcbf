"""Replay the hand-eye rotation pairs of calib-online runs on the CPU.

    python tests/handeye_replay.py RINGS.npz
    python tests/handeye_replay.py --reference

RINGS.npz is what `python3 chip_perf.py --calib-seeds ...` saves from the
card: each seed's pair ring (`q_cam_<g>`, `q_las_<g>`, `mask_<g>`, in the
order the pairs were accepted) and its final estimate `q_ex_<g>`.  Each
ring goes through both packages' `handeye_update` pair by pair; printed per
seed: the pair at which each converges, the largest angle between their
estimates, each one's final error against the rig's rotation (and the
card's), and the pairs' residual under the rig's true rotation (the
angle of q_las⁻¹ ⊗ X⁻¹ q_cam X: how well the pairs agree with the truth,
whatever the solver makes of them).

`--teacher FILE` runs both packages' fusion estimators on the per-frame
inputs that `python3 chip_perf.py --calib-capture FILE` records on the
card (the tracks and the laser pose), with the same relative-pose draws,
and prints where each adopts the hand-eye estimate and how the window
extrinsic goes on (minutes: the port's window solve on the CPU).

`--reference` instead runs the JAX package's own seq-2 preset
(`examples/eval_sweep.py:run_preset`) on the CPU, with the LiDAR cut to
`synthetic_config()`'s 32×512 (KITTI widths take hours here), and prints
its adoption frame and errors and its pairs' residuals (~4 minutes).

Not a test module.
"""

from __future__ import annotations

import argparse
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

from lmono_tpu.estimator import initializer as ji  # noqa: E402
from lmono_tpu.io.synthetic import synthetic_T_CL  # noqa: E402
from lmono_tpu.utils import lie as jl  # noqa: E402
from lmono_tpu_torch.estimator import initializer as ti  # noqa: E402


def angle_deg(a, b) -> float:
    """Angle between two unit quaternions, in degrees."""
    return float(np.rad2deg(2 * np.arccos(min(1.0, abs(float(np.dot(a, b)))))))


def pair_residuals_deg(q_cam, q_las, X) -> np.ndarray:
    """Each pair's angle q_las⁻¹ ⊗ (X⁻¹ q_cam X)."""
    pred = jl.quat_mul(jl.quat_mul(jl.quat_conj(X), jnp.asarray(q_cam)), X)
    d = np.asarray(jl.quat_mul(jl.quat_conj(jnp.asarray(q_las)), pred))
    return np.rad2deg(2 * np.arccos(np.clip(np.abs(d[:, 0]), 0.0, 1.0)))


def _stats(res: np.ndarray) -> str:
    if res.size == 0:
        return "no pairs"
    return (f"residual under the truth: median {np.median(res):.3f} deg, "
            f"p90 {np.percentile(res, 90):.3f}, max {res.max():.3f}")


def replay(path: str) -> None:
    X = np.asarray(synthetic_T_CL().q)
    d = np.load(path)
    step = jax.jit(ji.handeye_update)
    for g in d["seeds"]:
        q_cam, q_las, mask = d[f"q_cam_{g}"], d[f"q_las_{g}"], d[f"mask_{g}"]
        n = int(mask.sum())
        js, ts = ji.HandEyeState.init(), ti.HandEyeState.init()
        conv_j = conv_t = None
        worst = 0.0
        for i in range(n):
            js = step(js, jnp.asarray(q_cam[i]), jnp.asarray(q_las[i]), jnp.asarray(True))
            ts = ti.handeye_update(ts, torch.from_numpy(q_cam[i]),
                                   torch.from_numpy(q_las[i]), torch.tensor(True))
            worst = max(worst, angle_deg(np.asarray(js.q_ex), ts.q_ex.numpy()))
            if conv_j is None and bool(js.converged):
                conv_j = i
            if conv_t is None and bool(ts.converged):
                conv_t = i
        print(f"seed {g}: {n} pairs; converged at pair {conv_j} (JAX) / {conv_t} "
              f"(port); estimates within {worst:.4f} deg; final error "
              f"{angle_deg(np.asarray(js.q_ex), X):.4f} (JAX), "
              f"{angle_deg(ts.q_ex.numpy(), X):.4f} (port on the CPU), "
              f"{angle_deg(d[f'q_ex_{g}'], X):.4f} deg (the card); "
              + _stats(pair_residuals_deg(q_cam[:n], q_las[:n], X)), flush=True)


def reference_run() -> None:
    """The JAX package's seq-2 preset at synthetic LiDAR widths."""
    import dataclasses

    sys.path.insert(0, os.path.join(_ROOT, "examples"))
    import eval_sweep as es

    import lmono_tpu.config as C
    from lmono_tpu.io import synthetic as syn

    full = C.kitti_config
    lidar = C.synthetic_config().lidar
    es.kitti_config = lambda seq=0: full(seq).replace(lidar=dataclasses.replace(lidar))
    made = []
    base = es.FusedPipeline

    class Kept(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

        def process_chunk(self, frames):
            out = super().process_chunk(frames)
            ex_q.append(np.asarray(out["ex_q"]))
            return out

    ex_q = []
    es.FusedPipeline = Kept
    traj8 = syn.figure8_trajectory(320)
    row = es.run_preset(2, 300, syn.make_city_scene(), traj8, traj_excite=traj8)
    he = made[-1].state.est.handeye
    X = np.asarray(synthetic_T_CL().q)
    n = int(np.asarray(he.mask).sum())
    ex_q = np.concatenate(ex_q)
    first = int(np.argmax(np.any(np.abs(ex_q - ex_q[0]) > 1e-6, axis=1)))
    print(f"reference: the extrinsic leaves identity at frame {first} "
          f"({angle_deg(ex_q[first], X):.4f} deg after that frame's solve); the "
          f"window extrinsic at the end {row['handeye_rot_err_deg']} deg; the hand-eye "
          f"estimate {angle_deg(np.asarray(he.q_ex), X):.4f} deg from {n} pairs; "
          + _stats(pair_residuals_deg(np.asarray(he.q_cam)[:n], np.asarray(he.q_las)[:n], X)))


def teacher(path: str) -> None:
    """Both packages' `fusion_step` (KITTI 02's estimator, fine_times 1000,
    from the identity extrinsic) on the card's per-frame estimator inputs,
    with the same relative-pose draws (the JAX key's Gumbel noise)."""
    import dataclasses

    from lmono_tpu.config import kitti_config as jkitti
    from lmono_tpu.estimator import estimator as je
    from lmono_tpu.estimator.tracker import TrackOutput as JTrack
    from lmono_tpu_torch.config import kitti_config as tkitti
    from lmono_tpu_torch.estimator import estimator as te
    from lmono_tpu_torch.estimator.tracker import TrackOutput as TTrack
    from lmono_tpu_torch.utils.lie import Pose as TPose

    d = np.load(path)
    jcfg = dataclasses.replace(jkitti(2).estimator, fine_times=1000)
    tcfg = dataclasses.replace(tkitti(2).estimator, fine_times=1000)
    n_tracks = d["ids"].shape[1]
    js = je.EstimatorState.init(jcfg, None, n_tracks)
    ts = te.EstimatorState.init(tcfg, None, n_tracks, "cpu")
    step = jax.jit(lambda s, tr, lt, lq, k: je.fusion_step(s, tr, jl.Pose(lt, lq), jcfg, k))
    X = np.asarray(synthetic_T_CL().q)
    key = jax.random.PRNGKey(42)
    first = {"JAX": None, "port": None}
    names = ("ids", "uv", "norm", "velocity", "track_cnt", "alive")
    torch.set_num_threads(4)
    for i in range(d["ids"].shape[0]):
        key, k = jax.random.split(key)
        g = torch.from_numpy(np.asarray(jax.random.gumbel(k, (96, 8, n_tracks))))
        js, jo = step(js, JTrack(*(jnp.asarray(d[n][i]) for n in names)),
                      jnp.asarray(d["laser_t"][i]), jnp.asarray(d["laser_q"][i]), k)
        ts, to = te.fusion_step(ts, TTrack(*(torch.from_numpy(d[n][i]) for n in names)),
                                TPose(torch.from_numpy(d["laser_t"][i]),
                                      torch.from_numpy(d["laser_q"][i])),
                                tcfg, min(i, tcfg.window_size), g)
        for who, he, ex in (("JAX", js.handeye, np.asarray(jo.extrinsic.q)),
                            ("port", ts.handeye, to.extrinsic.q.numpy())):
            if first[who] is None and bool(np.asarray(he.converged)):
                first[who] = i
                print(f"{who}: adopted at frame {i}, {int(np.asarray(he.n))} pairs, the "
                      f"hand-eye {angle_deg(np.asarray(he.q_ex), X):.4f} deg, the window "
                      f"extrinsic after the frame's solve {angle_deg(ex, X):.4f} deg", flush=True)
        if i % 20 == 19:
            print(f"frame {i}: window extrinsic {angle_deg(np.asarray(jo.extrinsic.q), X):.4f} "
                  f"(JAX) / {angle_deg(to.extrinsic.q.numpy(), X):.4f} deg (port)", flush=True)
    print(f"card's adoption frame: {int(d['adoption_frame'])}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rings", nargs="?", help="the .npz of chip_perf.py --calib-seeds")
    ap.add_argument("--reference", action="store_true",
                    help="run the JAX package's seq-2 preset at synthetic widths instead")
    ap.add_argument("--teacher", metavar="FILE",
                    help="both estimators on the inputs of chip_perf.py --calib-capture")
    a = ap.parse_args()
    if a.reference:
        reference_run()
    elif a.teacher:
        teacher(a.teacher)
    elif a.rings:
        replay(a.rings)
    else:
        ap.error("give RINGS.npz or --reference")


if __name__ == "__main__":
    main()
