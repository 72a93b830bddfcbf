"""Readings of a cell's numbers on many seeds, with the control beside them.

    python3 -m slambench.control --workload <cell> --seeds 1,2,3 --seconds <s> [--out FILE]

Runs the cell once per seed in one process (on the card, as `run.py`
does) and prints, per seed, the readings of the program and of the
control: the reference put in the program's place and computed in
bfloat16, the precision below the configurations' float32 that acts on
every operation (module `reference`; TF32, the step below float32 with
TF32 off, rounds only matmul inputs, and the reference's geometry has no
matmul).  The limits in `limits/<cell>.json` sit between the two: above
the program's largest reading, below the control's smallest.  The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from slambench import harness, reference
from slambench.manifest import Cell
from slambench.traffic import sim

LOW = torch.bfloat16


def _quat_ypr(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z)),
                        torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0)),
                        torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))], -1)


def control_answers(drive, ans: reference.Answers) -> reference.Answers:
    """The program's answers replaced by the reference's in bfloat16; the
    questions (which frames, slots, pixels and node pairs) stay the
    program's.  The map's and the hand-eye's steps are recomputed in
    bfloat16 by `reference.judge` itself (its `control_dtype`), and so are
    the hand-eye's relative poses, the marginalizations and the pose-graph
    solves (`steps`)."""
    idx = torch.tensor(ans.idx)
    lo = lambda p: (p[0].float(), p[1].float())   # noqa: E731
    laser = lo(drive.laser_pose(idx, LOW))
    cam = drive.cam_pose(idx, LOW)
    scene = {k: (v.to(LOW) if v.is_floating_point() else v) for k, v in drive.scene.items()}
    out = reference.Answers(idx=ans.idx, laser=laser, pose=laser, maps=ans.maps,
                            handeye_steps=ans.handeye_steps, relpose=ans.relpose,
                            margs=ans.margs, solves=ans.solves,
                            loops_expected=ans.loops_expected)
    if ans.tracks is not None:
        uv, alive, cnt = ans.tracks
        rows = [uv[0].float()]
        for w in range(1, uv.shape[0]):
            u1, _ = drive.reproject((cam[0][w - 1], cam[1][w - 1]), (cam[0][w], cam[1][w]),
                                    uv[w - 1].to(LOW), scene=scene)
            rows.append(u1.float())
        out.tracks = (torch.stack(rows), alive, cnt)
    if ans.handeye is not None:
        rel = sim.relative((cam[0][:-1], cam[1][:-1]), (cam[0][1:], cam[1][1:]))[1]
        q = torch.cat([ans.handeye[0][:1].float(), rel.float()])
        out.handeye = (q, ans.handeye[1])
    if ans.loops:
        loops, nodes = [], {}
        for i, j, _, fi, fj, _ in ans.loops:
            ci, cj = drive.cam_pose(torch.tensor([fi]), LOW), drive.cam_pose(torch.tensor([fj]), LOW)
            rel_t, rel_q = sim.relative((ci[0][0], ci[1][0]), (cj[0][0], cj[1][0]))
            loops.append((i, j, rel_t.float(), fi, fj, rel_q.float()))
            nodes[i], nodes[j] = (ci[0][0], ci[1][0]), (cj[0][0], cj[1][0])
        K = max(nodes) + 1
        t = torch.zeros(K, 3, device=laser[0].device)
        ypr = torch.zeros(K, 3, device=laser[0].device)
        for k, (tk, qk) in nodes.items():
            t[k], ypr[k] = tk.float(), _quat_ypr(qk.float())
        out.loops, out.graph = loops, (t, ypr)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda", help="cpu for a rehearsal")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)   # as run.py runs the cell
    root = Path.cwd()
    cfg_map = Cell(root, args.workload, root / "slambench").config["system"]["mapping"]
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        run = harness.run_cell(root, args.workload, seed, args.seconds, False,
                               device=args.device, bench_dir=root / "slambench",
                               t_start=t0)
        ctrl = reference.judge(run["drive"], control_answers(run["drive"], run["answers"]),
                               cfg_map, control_dtype=LOW)
        row = {"seed": seed, "correct": run["result"]["correct"], "e2e": run["e2e"],
               "program": run["readings"], "control": ctrl,
               "loops": len(run["answers"].loops),
               "series": run["series"],
               "device": run["result"]["device"]}
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "series"}), flush=True)
        for k, xs in row["series"].items():
            if xs:
                xs = sorted(xs)
                print(f"series {seed} {k}: n {len(xs)} median {xs[len(xs) // 2]:.4f} "
                      f"p90 {xs[int(0.9 * (len(xs) - 1))]:.4f} top5 {[round(x, 3) for x in xs[-5:]]}",
                      flush=True)
        del run
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    names = sorted({k for r in rows for k in r["program"]})
    for k in names:
        prog = [r["program"][k] for r in rows if k in r["program"]]
        ctrl = [r["control"][k] for r in rows if k in r["control"]]
        print(f"summary {k}: program max {max(prog)!r} control min "
              f"{min(ctrl) if ctrl else 'none'!r}", flush=True)
    if args.out:
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
