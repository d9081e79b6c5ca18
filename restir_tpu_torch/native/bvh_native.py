"""ctypes bindings for the native C++ SAH / MTBVH builder (`bvh.cpp`, a
copy of `restir_tpu/native/bvh.cpp`).

The shared library is compiled with g++ on first use into
`restir_tpu_torch/_build/`, named after the SHA-256 of the source, the
flags and the host's machine type, so a changed source or flag builds a
new library and a stale one is never loaded. Concurrent builds (test
workers) each write a private temporary file and rename it into place.

The flags hold the numpy builder's arithmetic: `-ffp-contract=off` keeps
g++ from fusing the SAH products into FMAs, and there is no
`-march=native`, so the library is the same on every x86-64 host and
its trees equal `scene.bvh._build_bvh_numpy`'s bit for bit (tested on
the CPU here and on the card's host by `chip_smoke.py`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().with_name("bvh.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O3", "-ffp-contract=off", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None


class ToolchainMissing(RuntimeError):
    """No g++ on this host: the native builder cannot be compiled."""


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(platform.machine().encode())
    return BUILD_DIR / f"libbvh_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise ToolchainMissing("g++ not found: the native BVH builder "
                               "cannot be compiled")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SRC)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}) on {SRC}:\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int32)
        lib.build_bvh_native.restype = ctypes.c_int
        lib.build_bvh_native.argtypes = [
            fp,  # vertices [3N, 3]
            ctypes.c_int64,  # N
            fp, fp,  # bounds_lo, bounds_hi [2N - 1, 3]
            ip, ip, ip,  # mt_prim, mt_box, mt_miss [6, 2N - 1]
        ]
        _lib = lib
        return lib


def build_bvh_native(vertices: np.ndarray):
    """vertices: [3N, 3] float32 -> `scene.bvh.BVH`, the numpy builder's
    layout."""
    from ..scene.bvh import BVH

    verts = np.ascontiguousarray(
        np.asarray(vertices, np.float32).reshape(-1, 3))
    if verts.shape[0] == 0 or verts.shape[0] % 3:
        raise ValueError(f"BVH of {verts.shape[0]} vertices: need 3N > 0")
    lib = _load()
    n = verts.shape[0] // 3
    size = 2 * n - 1
    bounds_lo = np.empty((size, 3), np.float32)
    bounds_hi = np.empty((size, 3), np.float32)
    mt_prim = np.empty((6, size), np.int32)
    mt_box = np.empty((6, size), np.int32)
    mt_miss = np.empty((6, size), np.int32)

    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    rc = lib.build_bvh_native(
        verts.ctypes.data_as(fp), n,
        bounds_lo.ctypes.data_as(fp), bounds_hi.ctypes.data_as(fp),
        mt_prim.ctypes.data_as(ip), mt_box.ctypes.data_as(ip),
        mt_miss.ctypes.data_as(ip))
    if rc != 0:
        raise RuntimeError(f"build_bvh_native failed with code {rc}")
    return BVH(bounds_lo=bounds_lo, bounds_hi=bounds_hi, prim_id=mt_prim,
               box_id=mt_box, miss=mt_miss, size=size)
