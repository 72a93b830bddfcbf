"""Build a kernel source under `csrc/` into a shared library and load it.

Each source is compiled with `nvcc` for sm_90a into a library with a plain
C entry point, at first use, into `lmono_tpu_torch/build/` (git-ignored).
The file is named by a hash of the source, so an edited source is rebuilt
and an unchanged one is loaded as it is.  Nothing here runs when a module
is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD = PKG / "build"


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build_library(source: str, defines: tuple[str, ...] = ()
                  ) -> tuple[ctypes.CDLL, str]:
    """Compile `csrc/<source>` (once per source version and set of
    `defines`, NAME=VALUE strings passed to nvcc as -D flags) and load it.

    Returns the library and the compiler's report (`-Xptxas -v`:
    registers, shared memory and spills per kernel), empty when the library
    was already built.  Raises if `nvcc` fails.
    """
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(defines).encode())
    tag = digest.hexdigest()[:16]
    so = BUILD / f"lib{src.stem}_{tag}.so"
    report = ""
    if not so.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = BUILD / f"lib{src.stem}_{tag}.{os.getpid()}.tmp.so"
        cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", *(f"-D{d}" for d in defines),
               "-o", str(tmp), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, so)
        report = res.stdout + res.stderr
    return ctypes.CDLL(str(so)), report
