"""The plain reference that decides `correct`.

Imports torch, the standard library and the benchmark's frozen simulator,
and nothing of the program.  Each number is a gap between an answer the
timed path gave and what the reference works out for the same question
from the drive's truth, which the benchmark makes itself from the seed:

* `laser_rpe_m` / `pose_rpe_m`: the widest gap, over the window's frames,
  between the frame-to-frame translation of the odometry's laser pose / the
  estimator's pose and the truth's (the odometry with K1's neighbour lists;
  the window solve and marginalization, or the hand-eye's propagation);
* `track_px`: the 90th percentile, over the window's frames, of the median
  gap between where a carried track landed and where the truth puts the
  scene point its slot held a frame before (the KLT tracker with K2's
  tracks; a few frames of a lap track worse, and the same on every seed:
  the images carry no noise);
* `handeye_deg`: the median gap between the camera rotation the hand-eye's
  relative pose gives a frame pair and the truth's (printed, not compared:
  no bfloat16 reference of a 1.4° turn fails it);
* `extrinsic_deg`: the angle between the window's camera-from-laser
  rotation at the window's last frame and the rig's (`extrinsic_gap`;
  printed, not compared: where the rig calibrates itself, what it found is
  the drive's history's, the same on every seed);
* `handeye_steps`: the window frames on which the hand-eye's update of its
  own state differs from the reference's: the rotation pair admitted or
  refused by the angle gate, its slot in the ring, the count, and an
  adoption while the reference's σ₂ of the stacked AX = XB refuses one;
* `map_depth_rel`: the widest, over the checked frames, of the median
  relative gap between the map's completed depth and the truth's depth of
  the same pixel (projection and completion);
* `map_points_m`: the widest gap between the world points the map merges
  and the same pixels back-projected by the reference from the map's depth
  and camera pose (1e9 where the two keep different pixels);
* `map_slots`: the bank slots that differ after the frame's merge from the
  reference's voxel-hash merge of the same points into the same bank;
* `closure_m`, `closure_deg`: the median gap between an applied loop
  edge's relative translation / rotation and the truth's between the two
  keyframes' cameras (1e9 with no closure: the revisit must close loops);
* `graph_m`, `graph_deg`: the same medians after the pose-graph solve,
  between the optimized nodes (printed: the registration's own minimum
  sits a decimetre off on this scene);
* `graph_excess`: the largest, over the window's pose-graph solves, of the
  share of the cost reduction that the program's optimum leaves unmade
  against the reference's dense solve of the same graph (`steps`; 1e9 with
  no solve: the revisit must reap its closures);
* `relpose_deg`: the median, over the window's frames, of the angle
  between the hand-eye's relative rotation and the nearest of the best
  accepting hypotheses of the reference's RANSAC over the same tracks and
  draws, 0 where both refuse the pair, 180 where one side refuses it and
  the other accepts it (`steps`).  The
  median: where the program's best sample repeats a row (its draws are
  with replacement), its null vector is one of a plane's, fixed by its
  rounding, which no other arithmetic reproduces; that is a fifth to two
  fifths of the frames;
* `marg_prior_rel`: the largest, over a few marginalizations drawn from the
  seed, of the relative gap between the prior the program made and the
  reference's Schur complement of the same rows (`steps`).

The map checks follow the program's own bank and depth image one frame at
a time; `map_depth_rel` checks that depth image against the truth by
itself.  `judge` takes plain tensors (`Answers`) and returns the readings.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import torch

from slambench import steps
from slambench.traffic import lens, sim

NONE_READING = 1e9       # a number whose question the run never answered
_HP = (73856093, 19349663, 83492791)   # the voxel hash's primes


@dataclass
class Answers:
    """What the timed path answered, as plain tensors.  Window frames are
    positions 0..n-1; row 0 of each per-frame array is the frame before
    the window (position -1)."""

    idx: list                                  # drive index per row
    laser: tuple                               # (t (n+1,3), q (n+1,4))
    pose: tuple                                # the estimator's, same shapes
    tracks: Optional[tuple] = None             # (uv, alive, cnt) (n+1, N, ...)
    handeye: Optional[tuple] = None            # (q (n+1,4), ok (n+1,))
    handeye_steps: list = field(default_factory=list)   # see handeye_step_gaps
    maps: list = field(default_factory=list)   # per checked frame, see judge_map
    loops: list = field(default_factory=list)  # (i, j, rel_t (3,), fi, fj, rel_q (4,))
    graph: Optional[tuple] = None              # node (t (K,3), ypr (K,3))
    relpose: list = field(default_factory=list)   # see steps.relpose_gaps
    margs: list = field(default_factory=list)     # see steps.marg_schur
    solves: list = field(default_factory=list)    # see steps.graph_excess
    loops_expected: bool = False


def _angle_deg(q):
    """Rotation angle of a quaternion, whatever its norm (a product of
    unnormalized bfloat16 quaternions is one)."""
    return 2.0 * torch.rad2deg(torch.atan2(torch.linalg.vector_norm(q[..., 1:], dim=-1),
                                           torch.abs(q[..., 0])))


def _ypr_quat(ypr):
    zero = torch.zeros_like(ypr[..., 0])
    qz = sim.quat_from_axis_angle(torch.stack([zero, zero, ypr[..., 0]], -1))
    qy = sim.quat_from_axis_angle(torch.stack([zero, ypr[..., 1], zero], -1))
    qx = sim.quat_from_axis_angle(torch.stack([ypr[..., 2], zero, zero], -1))
    return sim.quat_mul(qz, sim.quat_mul(qy, qx))


def _f32(pose):
    return pose[0].float(), pose[1].float()


def rpe_max(est, truth) -> float:
    """Widest gap of frame-to-frame translation (m), rows 1.. against the
    row before."""
    re = sim.relative((est[0][:-1], est[1][:-1]), (est[0][1:], est[1][1:]))
    rt = sim.relative((truth[0][:-1], truth[1][:-1]), (truth[0][1:], truth[1][1:]))
    return float(torch.linalg.vector_norm(re[0] - rt[0], dim=-1).max())


def percentile(xs: list, q: float) -> float:
    """The q-th percentile of xs, interpolated linearly between ranks."""
    s = sorted(xs)
    if not s:
        return float("nan")
    k = (len(s) - 1) * q / 100.0
    lo = int(k)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (k - lo)


def track_gap(drive, tracks, cam_true, series=None) -> float:
    uv, alive, cnt = tracks
    meds = []
    for w in range(1, uv.shape[0]):
        carried = alive[w] & (cnt[w] >= 2)
        prev = (cam_true[0][w - 1], cam_true[1][w - 1])
        cur = (cam_true[0][w], cam_true[1][w])
        truth, hit = drive.reproject(prev, cur, uv[w - 1].float())
        m = carried & hit
        if int(m.sum()) < 5:
            continue
        err = torch.linalg.vector_norm(uv[w][m].float() - truth[m].float(), dim=-1)
        meds.append(float(err.median()))
    if series is not None:
        series += meds
    return percentile(meds, 90.0) if meds else NONE_READING


def _angle(q):
    """‖log(q)‖ as the port's hand-eye gate forms it, operation for
    operation (sign fixed to w ≥ 0, the rotation vector, then its norm), so
    that the gate's comparisons round alike on both sides."""
    q = torch.where(q[..., :1] < 0.0, -q, q)
    w, v = q[..., :1], q[..., 1:]
    vn2 = torch.sum(v * v, dim=-1, keepdim=True)
    vn = torch.sqrt(vn2 + 1e-16)
    angle = 2.0 * torch.atan2(vn, w)
    k = torch.where(vn2 < 1e-10, 2.0 / torch.clamp(w, min=1e-8), angle / vn)
    r = k * v
    return torch.sqrt(torch.sum(r * r, dim=-1))


def _left(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([torch.stack([w, -x, -y, -z], -1), torch.stack([x, w, -z, y], -1),
                        torch.stack([y, z, w, -x], -1), torch.stack([z, -y, x, w], -1)], -2)


def _right(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([torch.stack([w, -x, -y, -z], -1), torch.stack([x, w, z, -y], -1),
                        torch.stack([y, -z, w, x], -1), torch.stack([z, y, -x, w], -1)], -2)


def handeye_step_gaps(steps: list, dtype=torch.float32) -> float:
    """Frames whose hand-eye update differs from the reference's, from the
    program's state before each.  A step holds `before` and `after` (ring
    `q_cam`, `q_las`, `mask`, count `n`, `q_ex`, `converged`) and the
    frame's pair `q_cam`, `q_las`, `ok`.  The reference admits a pair whose
    two rotation angles agree within 15% (at least 0.01 rad), writes it at
    slot n mod K, and allows no adoption while σ₂ of the stacked
    Σ w (L(q_cam) − R(q_las)), with Huber weights under the estimate
    before, is 0.1 or less; `dtype` is its arithmetic (the control's
    bfloat16)."""
    bad = 0
    for st in steps:
        b, a = st["before"], st["after"]
        qc, ql = st["q_cam"].to(dtype), st["q_las"].to(dtype)
        th_c, th_l = _angle(qc), _angle(ql)
        ok = st["ok"] & (torch.abs(th_c - th_l) < torch.clamp(0.15 * th_l, min=0.01))
        K = b["mask"].shape[0]
        put = (torch.arange(K, device=b["n"].device) == b["n"] % K) & ok
        ring_c = torch.where(put[:, None], qc.float(), b["q_cam"])
        ring_l = torch.where(put[:, None], ql.float(), b["q_las"])
        mask = b["mask"] | put
        n = b["n"] + ok.to(b["n"].dtype)
        pred = sim.quat_mul(sim.quat_mul(sim.quat_conj(b["q_ex"]), ring_c), b["q_ex"])
        deg = torch.rad2deg(_angle(sim.quat_mul(sim.quat_conj(ring_l), pred)))
        w = torch.where(deg > 5.0, 5.0 / torch.clamp(deg, min=1e-6),
                        torch.ones_like(deg)) * mask.float()
        A = (w[:, None, None] * (_left(ring_c) - _right(ring_l))).reshape(-1, 4)
        sigma2 = torch.linalg.svdvals(A.double())[-2]
        differs = not (torch.equal(ring_c, a["q_cam"]) and torch.equal(ring_l, a["q_las"])
                       and torch.equal(mask, a["mask"]) and torch.equal(n, a["n"]))
        adopted = bool(a["converged"]) and not bool(b["converged"])
        bad += int(differs or (adopted and float(sigma2) <= 0.1))
    return float(bad)


def handeye_gap(handeye, cam_true, series=None) -> float:
    q, ok = handeye
    rel = sim.relative((cam_true[0][:-1], cam_true[1][:-1]),
                       (cam_true[0][1:], cam_true[1][1:]))[1]
    err = _angle_deg(sim.quat_mul(sim.quat_conj(q[1:].float()), rel))
    err = err[ok[1:]]
    if series is not None:
        series += err.tolist()
    return float(err.median()) if err.numel() else NONE_READING


def extrinsic_gap(q_ex, q_true) -> float:
    """Angle (degrees) between a camera-from-laser rotation and the rig's."""
    return float(_angle_deg(sim.quat_mul(sim.quat_conj(q_ex.float()), q_true.float())))


def hash_merge(bank, new, voxel: float, dtype=torch.float32):
    """The voxel-hash merge, written out: each point's voxel hashes to one
    slot; occupied slots keep their point; of several new points for one
    free slot the lowest index wins.  `dtype` is the arithmetic of the
    voxel coordinates."""
    points, colors, mask = bank
    pts, cols, keep = new
    C = points.shape[0]
    ijk = torch.floor(pts.to(dtype) / voxel).to(torch.int64)
    h = (ijk[:, 0] * _HP[0]) ^ (ijk[:, 1] * _HP[1]) ^ (ijk[:, 2] * _HP[2])
    slots = (h & 0x7FFFFFFF) % C
    write = keep & ~mask[slots]
    n = pts.shape[0]
    first = torch.full((C,), n, dtype=torch.int64, device=pts.device)
    idx = torch.arange(n, device=pts.device)
    first = first.scatter_reduce(0, slots[write], idx[write], reduce="amin")
    won = first < n
    src = torch.clamp(first, max=n - 1)
    out_p = torch.where(won[:, None], pts.to(dtype)[src].float(), points)
    out_c = torch.where(won[:, None], cols[src], colors)
    return out_p, out_c, mask | won


def backproject(depth, cam: dict, T_WC, dtype=torch.float32, lens_k=None):
    """The map's pixels (every second row and column, at their centres, as
    the port's `backproject_colored`) lifted at their depth and moved to the
    world: (points (P, 3), camera-frame y (P,)).  lens_k: the camera's
    distortion, which the lift inverts (`lens.lift`), or None."""
    H, W = depth.shape
    dev = depth.device
    vv, uu = torch.meshgrid(torch.arange(0, H, 2, device=dev),
                            torch.arange(0, W, 2, device=dev), indexing="ij")
    z = depth[vv, uu].reshape(-1).to(dtype)
    if lens_k is None:
        x = ((uu.reshape(-1).to(dtype) + 0.5) - cam["cx"]) / cam["fx"]
        y = ((vv.reshape(-1).to(dtype) + 0.5) - cam["cy"]) / cam["fy"]
    else:
        x, y = (c.to(dtype) for c in lens.lift(cam, lens_k, uu.reshape(-1) + 0.5,
                                               vv.reshape(-1) + 0.5))
    pc = torch.stack([x * z, y * z, z], -1)
    return sim.apply((T_WC[0].to(dtype), T_WC[1].to(dtype)), pc).float(), pc[:, 1].float()


def judge_map(drive, m: dict, cfg_map: dict, control_dtype=None) -> dict:
    """One checked frame: m holds the program's `depth`, `dmask` (completed
    depth and its mask), `pts_w`, `keep`, `T_WC`, the bank before
    (`bank_in`), the merged points (`new`) and the bank after (`bank_out`).
    With `control_dtype` the reference, computed in that dtype, stands in
    for the program's answers (the control)."""
    dev = m["depth"].device
    cam_true = drive.cam_pose(torch.tensor([m["idx"]]))
    cam_true = (cam_true[0][0].float(), cam_true[1][0].float())
    _, z_true = sim.render_camera(drive.scene, cam_true, drive.ray_dirs(dev))
    if control_dtype is None:
        depth, pts_w, bank_out = m["depth"], m["pts_w"], m["bank_out"]
    else:
        lo = control_dtype
        scene = {k: (v.to(lo) if v.is_floating_point() else v)
                 for k, v in drive.scene.items()}
        cam_lo = drive.cam_pose(torch.tensor([m["idx"]]), lo)
        _, depth = sim.render_camera(scene, (cam_lo[0][0], cam_lo[1][0]),
                                     drive.ray_dirs(dev, lo))
        depth = depth.float()
        pts_w, _ = backproject(m["depth"], drive.cam, m["T_WC"], dtype=lo, lens_k=drive.lens)
        bank_out = hash_merge(m["bank_in"], m["new"], cfg_map["map_voxel"], lo)
    out = {}
    ok = m["dmask"] & (z_true > 0)
    rel = torch.abs(depth - z_true)[ok] / z_true[ok]
    out["map_depth_rel"] = float(rel.median()) if rel.numel() else NONE_READING
    ref_pts, y_c = backproject(m["depth"], drive.cam, m["T_WC"], lens_k=drive.lens)
    z = m["depth"][::2, ::2].reshape(-1)
    keep = (m["dmask"][::2, ::2].reshape(-1) & (z > cfg_map["depth_min"])
            & (z < cfg_map["depth_max"]) & (y_c > -cfg_map["crop_height"]))
    if bool(torch.equal(keep, m["keep"])):
        gap = torch.abs(pts_w - ref_pts)[keep]
        out["map_points_m"] = float(gap.max()) if gap.numel() else 0.0
    else:
        out["map_points_m"] = NONE_READING
    ref_out = hash_merge(m["bank_in"], m["new"], cfg_map["map_voxel"])
    differ = ((bank_out[2] != ref_out[2])
              | (ref_out[2] & ((bank_out[0] != ref_out[0]).any(-1)
                               | (bank_out[1] != ref_out[1]).any(-1))))
    out["map_slots"] = float(differ.sum())
    return out


def closure_gaps(cam_pose_of, loops, graph) -> dict:
    """Median gaps of the window's loop edges against the truth's relative
    pose of the two keyframes' cameras, in translation (`closure_m`) and
    rotation (`closure_deg`), and the same of the optimized nodes they join
    (`graph_m`, `graph_deg`)."""
    if not loops:
        return {k: NONE_READING for k in ("closure_m", "closure_deg", "graph_m", "graph_deg")}
    fi = torch.tensor([lp[3] for lp in loops])
    fj = torch.tensor([lp[4] for lp in loops])
    rel_t, rel_q = sim.relative(cam_pose_of(fi), cam_pose_of(fj))
    rel_t, rel_q = rel_t.float(), rel_q.float()
    dev = rel_t.device
    t = torch.stack([lp[2].float() for lp in loops]).to(dev)
    q = torch.stack([lp[5].float() for lp in loops]).to(dev)
    out = {"closure_m": float(torch.linalg.vector_norm(t - rel_t, dim=-1).median()),
           "closure_deg": float(_angle_deg(sim.quat_mul(sim.quat_conj(q), rel_q)).median())}
    if graph is not None:
        gt, ypr = graph
        i = torch.tensor([lp[0] for lp in loops], device=gt.device)
        j = torch.tensor([lp[1] for lp in loops], device=gt.device)
        gq = _ypr_quat(ypr.float())
        ot, oq = sim.relative((gt[i].float(), gq[i]), (gt[j].float(), gq[j]))
        out["graph_m"] = float(torch.linalg.vector_norm(ot.to(dev) - rel_t, dim=-1).median())
        out["graph_deg"] = float(_angle_deg(
            sim.quat_mul(sim.quat_conj(oq.to(dev)), rel_q)).median())
    return out


def judge(drive, ans: Answers, cfg_map: dict, control_dtype=None,
          series: dict | None = None) -> dict:
    """Every reading the answers allow, by name.  control_dtype: the map's
    answers are the reference's in that dtype (the control; the other
    answers the caller has replaced already).  series: filled with the
    per-frame gaps behind the widest ones, for a look at their spread."""
    series = {} if series is None else series
    idx = torch.tensor(ans.idx)
    truth = _f32(drive.laser_pose(idx))
    cam_true = _f32(drive.cam_pose(idx))
    out = {"laser_rpe_m": rpe_max(_f32(ans.laser), truth),
           "pose_rpe_m": rpe_max(_f32(ans.pose), truth)}
    if ans.tracks is not None:
        out["track_px"] = track_gap(drive, ans.tracks, cam_true,
                                    series=series.setdefault("track_px", []))
    if ans.handeye is not None:
        out["handeye_deg"] = handeye_gap(ans.handeye, cam_true,
                                         series=series.setdefault("handeye_deg", []))
    if ans.handeye_steps:
        out["handeye_steps"] = handeye_step_gaps(
            ans.handeye_steps, torch.float32 if control_dtype is None else control_dtype)
    for m in ans.maps:
        for k, v in judge_map(drive, m, cfg_map, control_dtype).items():
            out[k] = max(out.get(k, 0.0), v)
    lo = control_dtype or torch.float64
    ctrl = control_dtype is not None
    if ans.relpose:
        gaps = steps.relpose_gaps(ans.relpose, lo, control=ctrl)
        series.setdefault("relpose_deg", []).extend(gaps)
        out["relpose_deg"] = percentile(gaps, 50.0)
    if ans.margs:
        out["marg_prior_rel"] = max(steps.marg_gap(m, lo, control=ctrl) for m in ans.margs)
    if ans.loops_expected:
        out.update(closure_gaps(lambda f: _f32(drive.cam_pose(f)), ans.loops, ans.graph))
        out["graph_excess"] = (max(steps.graph_excess(s, control=ctrl, dtype=lo)
                                   for s in ans.solves) if ans.solves else NONE_READING)
    return out


def compare(readings: dict, limits: dict) -> tuple[bool, dict]:
    """Each limited number beside its limit; correct when every reading is
    finite and at most its limit (a missing reading fails)."""
    rows = {}
    ok = True
    for name, limit in limits.items():
        v = readings.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok &= good
        rows[name] = {"value": v, "limit": limit}
    return ok, rows
