"""ctypes bindings for the native C++ host runtime: the threaded KITTI scan
loader, range-image regridding and binary PLY export.

Port of `lmono_tpu/native.py`.  The library is built from the port's own
copy of the source, `csrc/lmono_native.cpp`, with `g++` at first use into
`lmono_tpu_torch/build/` (git-ignored), named by a hash of the source, the
flags and the host's name (`-march=native` code is the building CPU's), so
an edited source, or a checkout copied to another machine, is rebuilt.  A failed build raises with the
compiler's output: nothing falls back on its own.  The numpy paths
(`io/kitti.py:scan_to_range_image`, `mapping/builder.py:write_ply`) run
only where the caller asks for them with `native=False`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from lmono_tpu_torch.config import LidarConfig

PKG = Path(__file__).resolve().parent
SOURCE = PKG / "csrc" / "lmono_native.cpp"
BUILD = PKG / "build"
CXX = os.environ.get("CXX", "g++")
# native/Makefile's flags
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LDFLAGS = ("-shared", "-lpthread")

_lib: Optional[ctypes.CDLL] = None
# frames the native loader has handed out in this process
native_frames_loaded = 0


def build_native() -> Path:
    """Compile the library with `CXX` into `BUILD` (once per source and
    flags) and return its path.  Raises RuntimeError with the compiler's
    output if it fails."""
    cxx, build = CXX, Path(BUILD)
    flags = (*CXXFLAGS, *LDFLAGS)
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(flags).encode()
                         + platform.node().encode()).hexdigest()[:16]
    so = build / f"liblmono_native_{tag}.so"
    if so.exists():
        return so
    build.mkdir(parents=True, exist_ok=True)
    tmp = build / f"liblmono_native_{tag}.{os.getpid()}.tmp.so"
    cmd = [cxx, *CXXFLAGS, str(SOURCE), "-o", str(tmp), *LDFLAGS]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {cxx!r} to build {SOURCE.name}: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, so)
    return so


def load_native() -> ctypes.CDLL:
    """The native library, built at first use; raises if it cannot be."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_native()))
    lib.lmono_regrid.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)]
    lib.lmono_loader_create.restype = ctypes.c_void_p
    lib.lmono_loader_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int]
    lib.lmono_loader_next.restype = ctypes.c_int
    lib.lmono_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)]
    lib.lmono_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.lmono_ply_write.restype = ctypes.c_int64
    lib.lmono_ply_write.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    _lib = lib
    return lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


_RING_MODES = {"uniform": 0, "hdl64": 1, "auto": 2}


def _grid_args(cfg: LidarConfig) -> tuple:
    return (cfg.num_rings, cfg.horiz_res, cfg.vertical_fov_deg[0],
            cfg.vertical_fov_deg[1], cfg.min_range, cfg.max_range,
            _RING_MODES[cfg.ring_mode])


def _grids(cfg: LidarConfig):
    R, W = cfg.num_rings, cfg.horiz_res
    return (np.empty((R, W), np.float32), np.empty((R, W, 3), np.float32),
            np.empty((R, W), np.uint8))


def regrid(xyz4: np.ndarray, cfg: LidarConfig, native: bool = True) -> dict:
    """(N,4) velodyne buffer → {ranges, points, valid} fixed grids, by the
    native regridder, or by `io/kitti.py:scan_to_range_image` when
    native=False."""
    if xyz4.ndim != 2 or xyz4.shape[1] != 4:
        raise ValueError(f"expected (N, 4) x, y, z, intensity rows, not {xyz4.shape}")
    if not native:
        from lmono_tpu_torch.io.kitti import scan_to_range_image
        return scan_to_range_image(np.ascontiguousarray(xyz4), cfg,
                                   ring_mode=cfg.ring_mode)
    lib = load_native()
    xyz4 = np.ascontiguousarray(xyz4, np.float32)
    ranges, points, valid = _grids(cfg)
    lib.lmono_regrid(_fp(xyz4), len(xyz4), *_grid_args(cfg),
                     _fp(ranges), _fp(points), _u8p(valid))
    return {"ranges": ranges, "points": points, "valid": valid.astype(bool)}


class NativeScanLoader:
    """Prefetching velodyne loader: a C++ thread reads and regrids up to
    `prefetch` frames ahead.  native=False reads and regrids each frame on
    the calling thread with numpy instead."""

    def __init__(self, velo_dir: str, n_frames: int, cfg: LidarConfig,
                 prefetch: int = 4, native: bool = True):
        self.cfg = cfg
        self.n_frames = n_frames
        self._dir = velo_dir
        self._i = 0
        self._h = None
        self._lib = load_native() if native else None
        if native:
            self._h = self._lib.lmono_loader_create(
                velo_dir.encode(), n_frames, *_grid_args(cfg), prefetch)

    def next(self) -> Optional[dict]:
        global native_frames_loaded
        if self._i >= self.n_frames:
            return None
        if self._lib is not None:
            if self._h is None:
                raise RuntimeError("the loader is closed")
            ranges, points, valid = _grids(self.cfg)
            idx = self._lib.lmono_loader_next(
                self._h, _fp(ranges), _fp(points), _u8p(valid))
            if idx < 0:
                return None
            self._i += 1
            native_frames_loaded += 1
            return {"index": idx, "ranges": ranges, "points": points,
                    "valid": valid.astype(bool)}
        path = os.path.join(self._dir, f"{self._i:06d}.bin")
        xyz4 = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
        out = regrid(xyz4, self.cfg, native=False)
        out["index"] = self._i
        self._i += 1
        return out

    def close(self):
        if self._h is not None:
            self._lib.lmono_loader_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def ply_write(path: str, xyz: np.ndarray, rgb01: np.ndarray,
              native: bool = True) -> int:
    """Binary PLY export, by the native writer or, when native=False, by
    `mapping/builder.py:write_ply` (the same bytes)."""
    if not native:
        from lmono_tpu_torch.mapping.builder import write_ply
        return write_ply(path, xyz, rgb01)
    lib = load_native()
    xyz = np.ascontiguousarray(xyz, np.float32)
    rgb = np.ascontiguousarray(
        (np.clip(rgb01, 0, 1) * 255).astype(np.uint8))
    if xyz.ndim != 2 or xyz.shape[1] != 3 or rgb.shape != xyz.shape:
        raise ValueError(f"expected (n, 3) points and colours, not {xyz.shape}, "
                         f"{rgb.shape}")
    return int(lib.lmono_ply_write(path.encode(), _fp(xyz), _u8p(rgb),
                                   len(xyz)))
