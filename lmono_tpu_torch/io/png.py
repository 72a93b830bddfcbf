"""PNG codec on the standard library's `zlib` (8-bit gray, gray+alpha, RGB,
RGBA; non-interlaced).

The JAX package reads KITTI's `image_0/*.png` through PIL or torchvision
(`lmono_tpu/io/kitti.py:27-40`).  The card's host has neither, so the port
decodes PNGs itself: `read_png` returns what the reference's reader returns,
`np.asarray(img, float32) / 255`.  Palette, 16-bit, sub-byte and interlaced
images raise `PngError` naming the reason.  `write_png` encodes 8-bit gray
and RGB(A) images, each row with the filter type asked for (0 by default).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type → channels (0 gray, 2 RGB, 4 gray+alpha, 6 RGBA); 3 (palette)
# is not supported
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


class PngError(ValueError):
    """A file this codec cannot decode, with the reason."""


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise PngError("not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if zlib.crc32(kind + body) != crc:
            raise PngError(f"CRC mismatch in chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise PngError("truncated PNG (no IEND chunk)")


def _unfilter_sequential(ftype: int, row: bytes, prior: bytes,
                         bpp: int) -> list:
    """Average (3) and Paeth (4): each byte depends on the reconstructed
    byte `bpp` to its left, so the row is walked byte by byte."""
    out = list(row)
    if ftype == 3:
        for i in range(bpp):
            out[i] = (out[i] + (prior[i] >> 1)) & 255
        for i in range(bpp, len(out)):
            out[i] = (out[i] + ((out[i - bpp] + prior[i]) >> 1)) & 255
        return out
    for i in range(bpp):            # a = c = 0: the predictor is b
        out[i] = (out[i] + prior[i]) & 255
    for i in range(bpp, len(out)):
        a, b, c = out[i - bpp], prior[i], prior[i - bpp]
        # |p − a|, |p − b|, |p − c| for p = a + b − c; ties go a, b, c
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - c - c)
        if pa <= pb and pa <= pc:
            out[i] = (out[i] + a) & 255
        elif pb <= pc:
            out[i] = (out[i] + b) & 255
        else:
            out[i] = (out[i] + c) & 255
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → uint8 array (H, W) for gray, (H, W, C) otherwise."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise PngError("no IHDR chunk")
    W, H, depth, ctype, _, _, interlace = header
    if ctype == 3:
        raise PngError("palette PNGs are not supported")
    if ctype not in _CHANNELS:
        raise PngError(f"unknown colour type {ctype}")
    if depth != 8:
        raise PngError(f"bit depth {depth} is not supported (8-bit only)")
    if interlace:
        raise PngError("interlaced (Adam7) PNGs are not supported")
    bpp = _CHANNELS[ctype]
    stride = W * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != H * (stride + 1):
        raise PngError(f"image data holds {len(raw)} bytes, expected "
                       f"{H * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(H, stride + 1)
    ftypes, out = rows[:, 0], rows[:, 1:].copy()
    if ftypes.max(initial=0) > 4:
        raise PngError(f"unknown row filter {int(ftypes.max())}")
    prior = np.zeros(stride, np.uint8)
    for y in range(H):
        f = int(ftypes[y])
        if f == 1:      # Sub: running sum per channel, modulo 256
            out[y] = np.cumsum(out[y].reshape(W, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif f == 2:    # Up
            out[y] += prior
        elif f in (3, 4):
            out[y] = np.frombuffer(bytes(_unfilter_sequential(
                f, out[y].tobytes(), prior.tobytes(), bpp)), np.uint8)
        prior = out[y]
    return out.reshape(H, W) if bpp == 1 else out.reshape(H, W, bpp)


def read_png(path: str) -> np.ndarray:
    """A PNG file as float32 in [0, 1], as the reference's PIL reader gives
    it: (H, W) for gray, (H, W, C) otherwise."""
    with open(path, "rb") as f:
        img = decode_png(f.read())
    return np.asarray(img, dtype=np.float32) / 255.0


def _filter_rows(img: np.ndarray, ftypes: np.ndarray, bpp: int) -> np.ndarray:
    """Filtered scanlines, each prefixed with its filter type byte."""
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])
    pred = preds[ftypes, np.arange(x.shape[0])]
    out = ((x - pred) & 0xFF).astype(np.uint8)
    return np.concatenate([ftypes[:, None].astype(np.uint8), out], axis=1)


def encode_png(img: np.ndarray, filter_type=0) -> bytes:
    """uint8 (H, W) gray or (H, W, C) with C in 1..4 → PNG bytes.
    filter_type: one filter type (0-4) for every row, or one per row."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise PngError(f"encode_png takes uint8 images, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}.get(C)
    if ctype is None:
        raise PngError(f"{C} channels: expected 1 to 4")
    ftypes = np.broadcast_to(np.asarray(filter_type, np.int64), (H,))
    if ftypes.min(initial=0) < 0 or ftypes.max(initial=0) > 4:
        raise PngError("filter types are 0 to 4")
    scan = _filter_rows(img.reshape(H, W * C), ftypes, C)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(scan.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, filter_type=0) -> None:
    """Write a uint8 image as PNG (see `encode_png`)."""
    with open(path, "wb") as f:
        f.write(encode_png(img, filter_type))
