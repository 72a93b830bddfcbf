"""Intrinsic calibration from chessboard images: fx, fy, cx, cy and radtan
distortion (camodocal's `Calibrations` executable).

Port of `examples/intrinsic_calib.py`: each image is read by the port's PNG
decoder, its inner corners are found by `find_chessboard_corners`, and
`calibrate_pinhole` solves over every view.  `--demo` projects a known
camera through 8 board poses and calibrates it back.  Runs on the CUDA card
unless `--device` names another device.

Usage:
    python -m lmono_tpu_torch.intrinsic_calib --images 'calib/*.png' \\
        --rows 6 --cols 9 --square 0.03 [--device cpu]
    python -m lmono_tpu_torch.intrinsic_calib --demo
"""

from __future__ import annotations

import argparse
import glob

import numpy as np
import torch

from lmono_tpu_torch import default_device
from lmono_tpu_torch.camera.calibration import (
    CalibResult,
    calibrate_pinhole,
    find_chessboard_corners,
)
from lmono_tpu_torch.camera.models import _radtan_distort
from lmono_tpu_torch.io.png import read_png
from lmono_tpu_torch.utils.lie import Pose, so3_exp_quat

DEMO_TRUTH = dict(fx=500.0, fy=505.0, cx=320.0, cy=240.0, k1=-0.12)


def board_points(rows: int, cols: int, square: float) -> np.ndarray:
    """Inner-corner board coordinates (rows·cols, 2), row-major, centred."""
    xx, yy = np.meshgrid(np.arange(cols) * square, np.arange(rows) * square)
    obj = np.stack([xx.ravel(), yy.ravel()], -1).astype(np.float32)
    return obj - obj.mean(0)


def demo_views(obj: np.ndarray, dev, n_views: int = 8) -> torch.Tensor:
    """The board seen by DEMO_TRUTH's camera from n_views poses drawn by
    numpy's RandomState(1): exact corner pixels (n_views, N, 2)."""
    t = DEMO_TRUTH
    obj3 = torch.cat([torch.as_tensor(obj, device=dev),
                      torch.zeros(len(obj), 1, device=dev)], -1)
    rng = np.random.RandomState(1)
    views = []
    for _ in range(n_views):
        pos = [rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05), rng.uniform(0.4, 0.6)]
        rot = 0.3 * rng.uniform(-1, 1, 3)
        pose = Pose(torch.tensor(pos, dtype=torch.float32, device=dev),
                    so3_exp_quat(torch.tensor(rot, dtype=torch.float32, device=dev)))
        P = pose.apply(obj3)
        xy = P[:, :2] / P[:, 2:3]
        xy_d = xy + _radtan_distort(t["k1"], 0.0, 0.0, 0.0, xy)
        views.append(torch.stack([t["fx"] * xy_d[:, 0] + t["cx"],
                                  t["fy"] * xy_d[:, 1] + t["cy"]], -1))
    return torch.stack(views)


def _report(res: CalibResult, n_views: int) -> None:
    print(f"fx={res.fx:.2f} fy={res.fy:.2f} cx={res.cx:.2f} cy={res.cy:.2f}")
    print(f"dist: k1={res.dist[0]:.5f} k2={res.dist[1]:.5f} "
          f"p1={res.dist[2]:.5f} p2={res.dist[3]:.5f}")
    print(f"reproj rmse: {res.reproj_rmse:.4f} px over {n_views} views")


def main(argv=None) -> CalibResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=str, default=None,
                    help="glob of chessboard images")
    ap.add_argument("--rows", type=int, default=6)
    ap.add_argument("--cols", type=int, default=9)
    ap.add_argument("--square", type=float, default=0.03,
                    help="square size in meters")
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    obj = board_points(args.rows, args.cols, args.square)

    if args.demo:
        views = demo_views(obj, dev)
        res = calibrate_pinhole(obj, views)
        t = DEMO_TRUTH
        print(f"true   : fx={t['fx']} fy={t['fy']} cx={t['cx']} cy={t['cy']} "
              f"k1={t['k1']:.3f}")
        _report(res, len(views))
        return res

    if not args.images:
        raise SystemExit("give --images GLOB or --demo")
    paths = sorted(glob.glob(args.images))
    if not paths:
        raise SystemExit(f"no images match {args.images}")
    views = []
    for p in paths:
        img = read_png(p)
        if img.ndim == 3:
            img = img[..., :3].mean(-1)
        corners, ok = find_chessboard_corners(torch.as_tensor(img, device=dev),
                                              args.rows, args.cols)
        if not ok:
            print(f"skip {p}: chessboard not found")
            continue
        views.append(corners)
        print(f"{p}: {len(corners)} corners")
    if len(views) < 3:
        raise SystemExit("need >= 3 good views")
    res = calibrate_pinhole(obj, torch.stack(views))
    _report(res, len(views))
    return res


if __name__ == "__main__":
    main()
