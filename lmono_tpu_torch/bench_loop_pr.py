"""Loop-closure precision/recall on a long synthetic circuit.

Port of `examples/bench_loop_pr.py`: drives `LoopDetector.process_keyframe`
over laps of the ray-cast city (default 78 keyframes, ~2.5 laps, one every
8 frames) and scores its detections against the ground-truth revisits.  A
detection is true when the matched keyframe lies within the geometric gate
(TRANS_THRESHOLD); the reference tunes its gates for zero false loops
(`LoopDetector.cc:167-260`), so the headline is a false-loop count of 0.
Every missed revisit is attributed to the stage that dropped it.

The keyframe images are rendered on the device and their window landmarks
come from ray casts (the simulator's depth).  `--perturb` perturbs every
keyframe after the first lap (brightness 0.7-1.3 and gamma, ±2 m lateral
offset, ±10° yaw; draws from numpy's RandomState(11), as the reference).
Writes the result as JSON to `--out` (default `loop_pr.json` in the
current directory).  Runs on the CUDA card unless `--device` names another
device.

Usage:
    python -m lmono_tpu_torch.bench_loop_pr [--kf 156] [--perturb]
        [--out FILE] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from lmono_tpu_torch import default_device
from lmono_tpu_torch.camera import pinhole_camera
from lmono_tpu_torch.config import synthetic_config
from lmono_tpu_torch.io import synthetic as syn
from lmono_tpu_torch.loop import LoopDetector
from lmono_tpu_torch.ops.corners import detect_grid
from lmono_tpu_torch.utils.lie import Pose, quat_mul, quat_rotate, so3_exp_quat

STRIDE = 8              # frames between keyframes
KF_PER_LAP = 32         # ≈ 2π·32 m / (0.8 m · STRIDE)
REVISIT_M = 8.0         # a keyframe within this of an older one is a revisit


def _perturb(pose_wc: Pose, rng: np.random.RandomState) -> tuple[Pose, float, float]:
    """A revisit keyframe's camera moved ±2 m sideways (camera x = right)
    and yawed ±10° (camera y = down is the yaw axis), with a brightness
    scale and a gamma; the draws in the reference's order."""
    dev = pose_wc.t.device
    lat = torch.tensor([rng.uniform(-2.0, 2.0), 0.0, 0.0], dtype=torch.float32,
                       device=dev)
    yaw = torch.tensor([0.0, rng.uniform(-0.1745, 0.1745), 0.0],
                       dtype=torch.float32, device=dev)
    pose = Pose(pose_wc.t + quat_rotate(pose_wc.q[None], lat[None])[0],
                quat_mul(pose_wc.q, so3_exp_quat(yaw)))
    return pose, rng.uniform(0.7, 1.3), rng.uniform(0.8, 1.25)


def run(n_kf: int = 78, perturb: bool = False, device=None,
        codebook: torch.Tensor | None = None) -> dict:
    """The benchmark; returns the result that `main` writes.  `codebook`
    (bits, vocab_dim) replaces the detector's vocabulary, e.g. one fresh
    from `train_vocab`."""
    dev = default_device(device)
    rng = np.random.RandomState(11)
    CFG = synthetic_config()
    scene = syn.make_city_scene(device=dev)
    T_LC = syn.synthetic_T_CL(device=dev).inverse()
    lcfg = dataclasses.replace(
        CFG.loop, db_capacity=max(128, n_kf + 2), search_gap=8,
        search_time=0.5, max_keypoints=128, window_points=64,
        min_brief_matches=12, min_pnp_inliers=8, skip_time=0.0, skip_dis=0.0)
    cc = CFG.camera
    cam = pinhole_camera(cc.width, cc.height, cc.fx, cc.fy, cc.cx, cc.cy)
    det = LoopDetector(lcfg, (cc.height, cc.width), device=dev)
    if codebook is not None:
        if tuple(codebook.shape) != tuple(det.codebook.shape):
            raise ValueError(f"codebook shape {tuple(codebook.shape)}, expected "
                             f"{tuple(det.codebook.shape)}")
        det.codebook = codebook.to(device=dev, dtype=torch.float32)
    no_uv = torch.zeros((1, 2), device=dev)
    no_mask = torch.zeros((1,), dtype=torch.bool, device=dev)

    traj = syn.circuit_trajectory(STRIDE * n_kf + 4, device=dev)
    kf_pos, fired, diag = [], {}, {}
    t0 = time.perf_counter()
    for k in range(n_kf):
        i = STRIDE * k
        pose_wc = Pose(traj.t[i], traj.q[i]).compose(T_LC)
        bright, gamma = 1.0, 1.0
        if perturb and k >= KF_PER_LAP:
            pose_wc, bright, gamma = _perturb(pose_wc, rng)
        img = syn.render_camera(scene, pose_wc, cc)
        if bright != 1.0:
            img = torch.clamp(torch.clamp(img * bright, 0.0, 1.0) ** gamma, 0.0, 1.0)
        uv, ok = detect_grid(img, 16, lcfg.window_points, no_uv, no_mask)
        rays_w = quat_rotate(pose_wc.q[None], cam.lift_projective(uv))
        dist = syn.ray_cast(scene, pose_wc.t.expand(rays_w.shape), rays_w)
        pts_w = pose_wc.t + rays_w * dist[:, None]
        res = det.process_keyframe(img, cam, uv, cam.lift_to_normalized(uv),
                                   pts_w, ok & (dist < 1e8), pose_wc,
                                   time=float(i) * 0.1)
        kf_pos.append(pose_wc.t.cpu().numpy())
        if res is not None:
            d = torch.stack([v.to(torch.float32) for v in (
                res.score, res.n_matches, res.n_inliers, res.found,
                res.old_seq)]).cpu().tolist()
            diag[k] = {"score": d[0], "matches": int(d[1]), "inliers": int(d[2]),
                       "found": bool(d[3])}
            if d[3]:
                fired[k] = int(d[4])
        if k % 20 == 0:
            print(f"kf {k}/{n_kf} fired={len(fired)}", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    kf_pos = np.stack(kf_pos)
    gap = lcfg.search_gap
    tp = sum(1 for k, old in fired.items()
             if np.linalg.norm(kf_pos[old] - kf_pos[k]) < CFG.loop.trans_threshold)
    revisit = [k for k in range(n_kf)
               if k > gap and np.linalg.norm(
                   kf_pos[: k - gap] - kf_pos[k], axis=-1).min() < REVISIT_M]
    # attribute every missed revisit to the stage that dropped it
    miss = {"score_gate": 0, "brief_matches": 0, "pnp_inliers": 0,
            "geom_gate": 0, "skip_gated": 0}
    for k in revisit:
        if k in fired:
            continue
        d = diag.get(k)
        if d is None:
            miss["skip_gated"] += 1
        elif d["score"] < lcfg.score_best_min:
            miss["score_gate"] += 1
        elif d["matches"] < lcfg.min_brief_matches:
            miss["brief_matches"] += 1
        elif d["inliers"] < lcfg.min_pnp_inliers:
            miss["pnp_inliers"] += 1
        else:
            miss["geom_gate"] += 1
    return {
        "keyframes": n_kf,
        "perturbed": bool(perturb),
        "miss_stages": miss,
        "vocab_dim": int(det.codebook.shape[1]),
        "underlying_frames": STRIDE * n_kf + 4,
        "detections": len(fired),
        "true_positives": tp,
        "false_positives": len(fired) - tp,
        "precision": tp / max(len(fired), 1),
        "recall": (sum(1 for k in revisit if k in fired) / max(len(revisit), 1)),
        "revisit_keyframes": len(revisit),
        "sec_per_keyframe": dt / n_kf,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kf", type=int, default=78,
                    help="number of keyframes (one every 8 frames; ~31 a lap)")
    ap.add_argument("--perturb", action="store_true",
                    help="perturb every revisit-lap keyframe: brightness "
                         "0.7-1.3 and gamma, ±2 m lateral offset, ±10° yaw")
    ap.add_argument("--out", type=str, default="loop_pr.json")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = run(args.kf, args.perturb, args.device)
    print(json.dumps(out, indent=1))
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
