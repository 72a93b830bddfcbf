"""The port's native host runtime (`lmono_tpu_torch.native`, built from
`lmono_tpu_torch/csrc/lmono_native.cpp` with `g++` at first use).

* `regrid` against the reference's numpy path
  (`lmono_tpu.io.kitti.scan_to_range_image`), with the reference tests'
  agreement criterion (`tests/test_native.py`, `tests/test_kitti_rings.py`):
  the C++ elevation math is f32, the numpy one f64, so a few boundary
  cells part; native=False is the numpy path itself, bit for bit.
* The prefetching loader hands out the frames in order, each equal to
  `regrid` of its file; with native=False, to the numpy path.
* `ply_write` writes the same bytes as `mapping/builder.py:write_ply`.
* A failed build (the compiler set to `false`) raises with the compiler's
  output, and nothing falls back: `regrid`, the loader and `ply_write`
  raise too.
"""

import numpy as np
import pytest

from lmono_tpu.io.kitti import scan_to_range_image
from lmono_tpu_torch import native
from lmono_tpu_torch.config import LidarConfig
from lmono_tpu_torch.mapping.builder import write_ply
from test_kitti_rings import simulate_hdl64_scan
from test_native import _fake_scan

CFG = LidarConfig(num_rings=16, horiz_res=256)
CFG64 = LidarConfig(num_rings=64, horiz_res=512)


def test_the_library_builds_from_the_port_source():
    so = native.build_native()
    assert so.parent == native.BUILD and so.exists()
    assert native.SOURCE.parent.name == "csrc"
    assert native.load_native() is native.load_native()


@pytest.mark.parametrize("seed", [0, 1])
def test_regrid_matches_the_reference_numpy_path(seed):
    scan = _fake_scan(seed=seed)
    out_c = native.regrid(scan, CFG)
    out_py = scan_to_range_image(scan[:, :3], CFG)
    assert (out_c["valid"] == out_py["valid"]).mean() > 0.999
    both = out_c["valid"] & out_py["valid"]
    np.testing.assert_allclose(out_c["ranges"][both], out_py["ranges"][both],
                               rtol=1e-4, atol=1e-3)
    plain = native.regrid(scan, CFG, native=False)
    for k in out_py:
        np.testing.assert_array_equal(plain[k], out_py[k])


def test_regrid_matches_the_reference_on_hdl64():
    xyz, _ = simulate_hdl64_scan()
    out_c = native.regrid(xyz, CFG64)
    out_py = scan_to_range_image(xyz[:, :3], CFG64, ring_mode="auto")
    assert (out_c["valid"] == out_py["valid"]).mean() > 0.995
    both = out_c["valid"] & out_py["valid"]
    close = np.abs(out_c["ranges"][both] - out_py["ranges"][both]) < 1e-3
    assert close.mean() > 0.995, close.mean()


@pytest.mark.parametrize("use_native", [True, False])
def test_loader_hands_out_regrid_of_each_file_in_order(tmp_path, use_native):
    scans = [_fake_scan(n=20000, seed=i) for i in range(5)]
    for i, s in enumerate(scans):
        s.tofile(tmp_path / f"{i:06d}.bin")
    before = native.native_frames_loaded
    ld = native.NativeScanLoader(str(tmp_path), 5, CFG, prefetch=2,
                                 native=use_native)
    seen = []
    while (f := ld.next()) is not None:
        want = native.regrid(scans[f["index"]], CFG, native=use_native)
        for k in ("ranges", "points", "valid"):
            np.testing.assert_array_equal(f[k], want[k], err_msg=k)
        seen.append(f["index"])
    ld.close()
    assert seen == [0, 1, 2, 3, 4]
    assert native.native_frames_loaded - before == (5 if use_native else 0)


def test_ply_write_equals_write_ply(tmp_path):
    rng = np.random.RandomState(0)
    pts = rng.randn(100, 3).astype(np.float32) * 20
    rgb = rng.uniform(-0.1, 1.1, (100, 3)).astype(np.float32)
    a, b, c = (str(tmp_path / f"{n}.ply") for n in "abc")
    assert native.ply_write(a, pts, rgb) == 100
    assert write_ply(b, pts, rgb) == 100
    assert native.ply_write(c, pts, rgb, native=False) == 100
    data = open(a, "rb").read()
    assert data == open(b, "rb").read() == open(c, "rb").read()
    assert b"element vertex 100" in data


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "CXX", "false")
    monkeypatch.setattr(native, "BUILD", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="failed"):
        native.build_native()
    scan = _fake_scan(n=1000)
    with pytest.raises(RuntimeError, match="failed"):
        native.regrid(scan, CFG)
    with pytest.raises(RuntimeError, match="failed"):
        native.NativeScanLoader(str(tmp_path), 1, CFG)
    with pytest.raises(RuntimeError, match="failed"):
        native.ply_write(str(tmp_path / "m.ply"), np.zeros((1, 3)), np.zeros((1, 3)))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        native.build_native()
    assert not list(tmp_path.glob("*.so"))
    assert native.regrid(scan, CFG, native=False)["valid"].any()
    with pytest.raises(ValueError, match="N, 4"):
        native.regrid(scan[:, :3], CFG, native=False)
