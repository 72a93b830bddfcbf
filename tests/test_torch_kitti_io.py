"""The port's KITTI readers (`lmono_tpu_torch.io.kitti`) and PNG codec
(`lmono_tpu_torch.io.png`) against the JAX package's readers and PIL.

* `scan_to_range_image` equals `lmono_tpu.io.kitti.scan_to_range_image` bit
  for bit: on the reference tests' fake 16×256 scans in all three ring
  modes, and on a simulated two-block HDL-64E scan in its native order, and
  shuffled (the recovered rings equal too).
* `read_calib`, `config_from_calib` and `read_poses` equal the reference's
  (poses within 1e-6).
* A `KittiSequence` over the reference tests' tree (`make_kitti_tree`, with
  PNGs added) gives the same frames, times, images and config as the
  reference's (PIL) reader.
* PNG: the decoder equals PIL on gray, gray+alpha, RGB and RGBA images with
  every row filter; PIL reads the encoder's files back equal; palette,
  16-bit and interlaced files raise `PngError`.
"""

import dataclasses
import io
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from lmono_tpu.io import kitti as jk
from lmono_tpu_torch.config import LidarConfig
from lmono_tpu_torch.io import kitti as tk
from lmono_tpu_torch.io import png
from test_kitti_io import make_kitti_tree
from test_kitti_rings import simulate_hdl64_scan
from test_native import _fake_scan

CFG16 = LidarConfig(num_rings=16, horiz_res=256)
CFG64 = LidarConfig(num_rings=64, horiz_res=512, min_range=1.0, max_range=80.0)
MODES = ("auto", "hdl64", "uniform")


def _assert_grids_equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [0, 1])
def test_range_image_equals_reference_on_fake_scans(mode, seed):
    xyz = _fake_scan(seed=seed)[:, :3]
    _assert_grids_equal(tk.scan_to_range_image(xyz, CFG16, mode),
                        jk.scan_to_range_image(xyz, CFG16, mode))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shuffle", [False, True])
def test_range_image_equals_reference_on_hdl64(mode, shuffle):
    xyz, _ = simulate_hdl64_scan()
    if shuffle:      # native order destroyed: scan-order recovery fails
        xyz = xyz[np.random.RandomState(1).permutation(len(xyz))]
    _assert_grids_equal(tk.scan_to_range_image(xyz[:, :3], CFG64, mode),
                        jk.scan_to_range_image(xyz[:, :3], CFG64, mode))


def test_ring_recovery_equals_reference():
    xyz, true_ring = simulate_hdl64_scan()
    ring = tk.recover_rings_scanorder(xyz, 64)
    np.testing.assert_array_equal(ring, jk.recover_rings_scanorder(xyz, 64))
    assert (ring == true_ring).mean() > 0.999
    perm = np.random.RandomState(1).permutation(len(xyz))
    assert tk.recover_rings_scanorder(xyz[perm], 64) is None
    elev = np.arcsin(xyz[:, 2] / np.linalg.norm(xyz[:, :3], axis=-1))
    np.testing.assert_array_equal(tk.hdl64_ring_from_elevation(elev),
                                  jk.hdl64_ring_from_elevation(elev))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The reference tests' KITTI tree with a PNG per frame (PIL-written,
    with PIL's own row filters)."""
    root = make_kitti_tree(str(tmp_path_factory.mktemp("kitti")))
    img_dir = os.path.join(root, "sequences", "00", "image_0")
    os.makedirs(img_dir)
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:48, 0:96]
    for i in range(3):
        img = (127 + 60 * np.sin(0.2 * xx + i) * np.cos(0.15 * yy)
               + rng.randint(0, 40, (48, 96))).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(img_dir, f"{i:06d}.png"))
    return root


def test_calib_and_config_equal_reference(tree):
    path = os.path.join(tree, "sequences", "00", "calib.txt")
    cj, ct = jk.read_calib(path), tk.read_calib(path)
    assert cj.keys() == ct.keys()
    for k in cj:
        np.testing.assert_array_equal(cj[k], ct[k])
    assert (dataclasses.asdict(tk.config_from_calib(ct))
            == dataclasses.asdict(jk.config_from_calib(cj)))


def test_read_poses_matches_reference(tree):
    path = os.path.join(tree, "poses", "00.txt")
    pj, pt = jk.read_poses(path), tk.read_poses(path)
    assert pt.t.dtype == pt.q.dtype == torch.float32 and pt.t.device.type == "cpu"
    np.testing.assert_allclose(pt.t.numpy(), np.asarray(pj.t), atol=1e-6)
    np.testing.assert_allclose(pt.q.numpy(), np.asarray(pj.q), atol=1e-6)


def test_kitti_sequence_equals_reference(tree):
    dj, dt = jk.KittiSequence(tree, 0, CFG16), tk.KittiSequence(tree, 0, CFG16)
    assert len(dj) == len(dt) == 3
    np.testing.assert_array_equal(dj.times, dt.times)
    for i in range(len(dj)):
        fj, ft = dj.frame(i), dt.frame(i)
        assert fj["index"] == ft["index"] and fj["time"] == ft["time"]
        assert ft["image"].dtype == np.float32
        np.testing.assert_array_equal(ft["image"], fj["image"])
        _assert_grids_equal(ft["scan"], fj["scan"])
        assert dt.time(i) == dj.time(i)
    assert (dataclasses.asdict(dt.system_config())
            == dataclasses.asdict(dj.system_config()))
    assert dt.image(7) is None


# ---------------------------------------------------------------- PNG codec

def _image(shape, seed):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, shape).astype(np.uint8)
    img[: shape[0] // 2] //= 3            # runs of small values and ties
    return img


SHAPES = [(37, 53), (37, 53, 2), (29, 41, 3), (17, 23, 4), (1, 1), (2, 1, 3)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
def test_decoder_and_encoder_agree_with_pil(shape, filt):
    img = _image(shape, seed=len(shape) * 7 + shape[0])
    ftype = (np.random.RandomState(3).randint(0, 5, shape[0])
             if filt == "mixed" else filt)
    data = png.encode_png(img, ftype)
    rows = zlib.decompress(data[data.index(b"IDAT") + 4:])
    stride = int(np.prod(shape[1:])) + 1
    np.testing.assert_array_equal(
        np.frombuffer(rows, np.uint8)[::stride][:shape[0]],
        np.broadcast_to(ftype, (shape[0],)))
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    np.testing.assert_array_equal(png.decode_png(data), img)


@pytest.mark.parametrize("mode,shape", [("L", (61, 87)), ("RGB", (33, 45, 3)),
                                        ("RGBA", (21, 19, 4)), ("LA", (9, 13, 2))])
def test_read_png_equals_pil_reader(tmp_path, mode, shape):
    img = _image(shape, seed=5)
    path = str(tmp_path / "a.png")
    Image.fromarray(img, mode).save(path)
    ref = np.asarray(Image.open(path), dtype=np.float32) / 255.0
    got = png.read_png(path)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def _with_ihdr(data: bytes, **fields) -> bytes:
    """The PNG with IHDR fields replaced (and its CRC recomputed)."""
    i = data.index(b"IHDR")
    W, H, depth, ctype, comp, filt, inter = struct.unpack(">IIBBBBB", data[i + 4:i + 17])
    vals = dict(W=W, H=H, depth=depth, ctype=ctype, comp=comp, filt=filt, inter=inter)
    vals.update(fields)
    body = struct.pack(">IIBBBBB", *vals.values())
    return (data[:i + 4] + body + struct.pack(">I", zlib.crc32(b"IHDR" + body))
            + data[i + 21:])


def test_unsupported_pngs_raise(tmp_path):
    img = _image((8, 8), seed=1)
    bio = io.BytesIO()
    Image.fromarray(img).convert("P").save(bio, format="PNG")
    with pytest.raises(png.PngError, match="palette"):
        png.decode_png(bio.getvalue())
    bio = io.BytesIO()
    Image.fromarray(img.astype(np.uint16) * 257).save(bio, format="PNG")
    with pytest.raises(png.PngError, match="bit depth 16"):
        png.decode_png(bio.getvalue())
    with pytest.raises(png.PngError, match="interlaced"):
        png.decode_png(_with_ihdr(png.encode_png(img), inter=1))
    bad = bytearray(png.encode_png(img))
    bad[-20] ^= 1                      # inside IDAT's data: its CRC fails
    with pytest.raises(png.PngError, match="CRC"):
        png.decode_png(bytes(bad))
    with pytest.raises(png.PngError, match="signature"):
        png.decode_png(b"GIF89a" + bytes(20))
    path = str(tmp_path / "p.png")
    Image.fromarray(img).convert("P").save(path)
    os.makedirs(tmp_path / "sequences" / "00" / "image_0")
    with open(tmp_path / "sequences" / "00" / "calib.txt", "w") as f:
        f.write("P0: 1 0 1 0 0 1 1 0 0 0 1 0\n")
    os.replace(path, tmp_path / "sequences" / "00" / "image_0" / "000000.png")
    with pytest.raises(png.PngError, match="palette"):
        tk.KittiSequence(str(tmp_path), 0, CFG16).image(0)
