"""Debug visualization: tracked-feature overlays, depth maps, loop mosaics,
trajectory plots — written as PNG files.

Port of `lmono_tpu/viz.py`, which replaces the reference's ROS/RViz visual
surface (`src/visualizer/Visualizer.cc` publishers, the per-frame debug
imagery of `FeatureTracker.cc:161-162` and `KeyFrame.cc:594-635`) with file
outputs.  Host code on numpy arrays.  The JAX package writes through PIL
and plots with matplotlib; here PNGs go through the port's own encoder
(`io/png.py:write_png`), and `plot_trajectories` rasterizes its polylines,
grid, frame and legend swatches onto a numpy canvas, with no text.
"""

from __future__ import annotations

import numpy as np

from lmono_tpu_torch.io.png import write_png

# matplotlib's default colour cycle ("tab10"), as the reference's plot
# colours its trajectories
PALETTE = np.array([[31, 119, 180], [255, 127, 14], [44, 160, 44],
                    [214, 39, 40], [148, 103, 189], [140, 86, 75],
                    [227, 119, 194], [127, 127, 127], [188, 189, 34],
                    [23, 190, 207]], np.uint8)


def _to_u8(img) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    return img


def save_png(path: str, img) -> None:
    """Write an image ((H,W) or (H,W,3), uint8 or floats in [0,1]) as RGB PNG."""
    write_png(path, _to_u8(img))


def draw_tracks(image, uv, alive, track_cnt=None, radius: int = 2) -> np.ndarray:
    """Overlay tracked features: green = long track, red = fresh
    (the reference's track image, FeatureTracker.cc:505-530)."""
    img = _to_u8(image).copy()
    H, W, _ = img.shape
    uv = np.asarray(uv)
    alive = np.asarray(alive)
    cnt = np.asarray(track_cnt) if track_cnt is not None else np.full(len(uv), 10)
    for i in range(len(uv)):
        if not alive[i]:
            continue
        x, y = int(round(uv[i, 0])), int(round(uv[i, 1]))
        if not (0 <= x < W and 0 <= y < H):
            continue
        frac = min(cnt[i] / 20.0, 1.0)
        color = np.array([255 * (1 - frac), 255 * frac, 0], np.uint8)
        y0, y1 = max(0, y - radius), min(H, y + radius + 1)
        x0, x1 = max(0, x - radius), min(W, x + radius + 1)
        img[y0:y1, x0:x1] = color
    return img


def depth_to_color(depth, mask, d_max: float = 80.0) -> np.ndarray:
    """Colorize a depth map (turbo-ish ramp) for inspection (the reference
    publishes depth/projection images, map_build_node.cc:294-297)."""
    d = np.asarray(depth)
    m = np.asarray(mask)
    x = np.clip(d / d_max, 0, 1)
    r = np.clip(1.5 - np.abs(2.0 * x - 1.0) * 2.0, 0, 1) + x * 0.3
    g = np.clip(1.2 - np.abs(2.0 * x - 0.6) * 2.0, 0, 1)
    b = np.clip(1.0 - x * 1.5, 0, 1)
    img = np.stack([np.clip(r, 0, 1), g, b], -1)
    img[~m] = 0.0
    return img


def loop_mosaic(img_cur, img_old, uv_cur, uv_old, matches_ok) -> np.ndarray:
    """Side-by-side loop match visualization (KeyFrame.cc:594-635)."""
    a = _to_u8(img_cur)
    b = _to_u8(img_old)
    H = max(a.shape[0], b.shape[0])
    canvas = np.zeros((H, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1]:] = b
    off = a.shape[1]
    uv_cur = np.asarray(uv_cur)
    uv_old = np.asarray(uv_old)
    ok = np.asarray(matches_ok)
    for i in range(len(uv_cur)):
        if not ok[i]:
            continue
        x0, y0 = int(uv_cur[i, 0]), int(uv_cur[i, 1])
        x1, y1 = int(uv_old[i, 0]) + off, int(uv_old[i, 1])
        _line(canvas, x0, y0, x1, y1, (0, 255, 255))
    return canvas


def _line(canvas: np.ndarray, x0, y0, x1, y1, color, width: int = 1) -> None:
    """Draw a segment: one pixel per step of its longer axis (the reference
    mosaic's `linspace` walk), thickened to `width` pixels, clipped to the
    canvas."""
    H, W = canvas.shape[:2]
    n = max(abs(x1 - x0), abs(y1 - y0), 1)
    xs = np.linspace(x0, x1, n).astype(int)
    ys = np.linspace(y0, y1, n).astype(int)
    for dy in range(width):
        for dx in range(width):
            x, y = xs + dx - width // 2, ys + dy - width // 2
            inb = (x >= 0) & (x < W) & (y >= 0) & (y < H)
            canvas[y[inb], x[inb]] = color


PLOT_PX = 960           # the reference's 8 in at 120 dpi


def plot_trajectories(path: str, trajs: dict, plane=("x", "y")) -> None:
    """Top-down trajectory comparison plot, written as a PLOT_PX² PNG:
    each trajectory a polyline in the order of `trajs`, coloured from
    PALETTE, on equal axes with a 10-line grid and a black frame, and a
    legend of colour swatches in the same order in the top-right corner."""
    ax_idx = {"x": 0, "y": 1, "z": 2}
    i, j = ax_idx[plane[0]], ax_idx[plane[1]]
    paths = [np.asarray(pose.t, np.float64)[:, [i, j]] for pose in trajs.values()]
    size = PLOT_PX
    canvas = np.full((size, size, 3), 255, np.uint8)
    margin = size // 16
    inner = size - 2 * margin
    allp = np.concatenate(paths) if paths else np.zeros((1, 2))
    lo, hi = allp.min(0), allp.max(0)
    centre = 0.5 * (lo + hi)
    span = max(float((hi - lo).max()), 1e-9) * 1.05    # equal axes

    def to_px(p):
        u = (p - centre) / span * inner + size / 2
        return u[:, 0], size - u[:, 1]                  # y up

    for k in range(11):
        c = margin + round(k * inner / 10)
        canvas[margin:size - margin, c] = 220
        canvas[c, margin:size - margin] = 220
    for a, b in ((margin, margin), (size - margin, size - margin)):
        canvas[margin:size - margin + 1, a] = 0
        canvas[b, margin:size - margin + 1] = 0
    for k, p in enumerate(paths):
        color = PALETTE[k % len(PALETTE)]
        u, v = to_px(p)
        for s in range(len(u) - 1):
            _line(canvas, int(u[s]), int(v[s]), int(u[s + 1]), int(v[s + 1]),
                  color, width=2)
        sw = size // 40
        y0 = margin + sw // 2 + k * (sw + sw // 2)
        x1 = size - margin - sw // 2
        canvas[y0:y0 + sw, x1 - 2 * sw:x1] = color
    write_png(path, canvas)
