"""Visualization of the port (`lmono_tpu_torch.viz`) against the JAX
package's (`lmono_tpu.viz`), mirroring `tests/test_viz_metrics.py`'s
drawing cases on the same numpy inputs: the track overlay, the depth
colouring and the loop mosaic equal the reference's pixel for pixel; the
PNGs, written by the port's own encoder (the card host has neither PIL nor
matplotlib), decode through `io/png.py:read_png` to the array written; the
trajectory plot (rasterized with numpy where the reference calls
matplotlib) holds each trajectory's colour and the grid."""

import os

import numpy as np

from lmono_tpu import viz as jviz
from lmono_tpu_torch import viz
from lmono_tpu_torch.io.png import read_png
from lmono_tpu_torch.utils.lie import Pose


def _decoded_u8(path):
    # read_png gives float32 in [0, 1], as the reference's PIL reader
    return np.round(read_png(path) * 255).astype(np.uint8)


def test_draw_tracks_and_save(tmp_path):
    img = np.random.RandomState(0).rand(60, 80)
    uv = np.array([[10.0, 10.0], [70.0, 50.0], [200.0, 10.0]])
    alive = np.array([True, True, True])
    cnt = np.array([1, 25, 5])
    out = viz.draw_tracks(img, uv, alive, track_cnt=cnt)
    np.testing.assert_array_equal(out, jviz.draw_tracks(img, uv, alive, track_cnt=cnt))
    assert out.shape == (60, 80, 3)
    assert (out[10, 10] != out[11, 20]).any()
    path = os.path.join(tmp_path, "t.png")
    viz.save_png(path, out)
    assert os.path.getsize(path) > 100
    np.testing.assert_array_equal(_decoded_u8(path), out)


def test_depth_color_and_mosaic(tmp_path):
    d = np.random.RandomState(1).rand(40, 50) * 60
    m = d > 10
    img = viz.depth_to_color(d, m)
    np.testing.assert_array_equal(img, jviz.depth_to_color(d, m))
    assert img.shape == (40, 50, 3)
    assert (img[~m] == 0).all()
    a = np.random.RandomState(2).rand(40, 50)
    uv_c, uv_o = [[5, 5], [30, 2]], [[10, 10], [45, 39]]
    mos = viz.loop_mosaic(a, a, uv_c, uv_o, [True, True])
    np.testing.assert_array_equal(mos, jviz.loop_mosaic(a, a, uv_c, uv_o, [True, True]))
    assert mos.shape == (40, 100, 3)
    assert (mos == [0, 255, 255]).all(-1).any()
    path = os.path.join(tmp_path, "depth.png")
    viz.save_png(path, img)
    np.testing.assert_array_equal(_decoded_u8(path), viz._to_u8(img))


def test_plot_trajectories(tmp_path):
    import torch

    t = torch.from_numpy(np.random.RandomState(3).rand(50, 3) * 10)
    q = torch.tensor([1.0, 0, 0, 0]).expand(50, 4)
    p = os.path.join(tmp_path, "traj.png")
    viz.plot_trajectories(p, {"est": Pose(t, q), "gt": Pose(t + 1, q)})
    assert os.path.getsize(p) > 1000
    img = _decoded_u8(p)
    assert img.shape == (960, 960, 3)
    for color in viz.PALETTE[:2]:                 # both lines and swatches
        assert (img == color).all(-1).sum() > 500
    assert (img == 220).all(-1).sum() > 1000      # the grid
    assert not (img == viz.PALETTE[2]).all(-1).any()
