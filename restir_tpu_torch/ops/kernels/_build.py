"""Build and load the port's CUDA kernels.

All `*.cu` sources in `restir_tpu_torch/csrc/` compile, on first use, with
nvcc into one shared library with a plain C interface, which `ctypes`
loads: one nvcc per source, all started together, then one link. Nothing
includes PyTorch's headers, so the build takes seconds.
The library is cached under `restir_tpu_torch/_build/`, keyed by a hash
of the sources and flags; a changed source builds a new library.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` raises on a non-zero code. Outputs are
allocated by the Python wrappers with `torch.empty`.

Named variants (`VARIANTS`, `variant_library`) build for the stage
probes of `restir_tpu_torch.prof`: a source of this directory with
`-DPROBE_...` flags (B6 `gbuffer_bvh.cu`, B7 `reuse_bvh.cu`, B10
`ris_cdf.cu`, each stubbed where its `#if PROBE_*` blocks say; with no
flag, the source as the main library has it), or the probe kernels of
`csrc/prof/`, each into a library of its own under a digest of its own.
The ray-order kernels the probes share with B13 (`csrc/sort.cu`) are in
the main library.
The main library's glob does not recurse into `csrc/prof/`, and no
variant flag enters its digest.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# sm_90a: Hopper. No --use_fast_math: the kernels hold the reference's
# float32 numerics (IEEE division and sqrt, accurate expf).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas=-v"]
# Sources that round as their plain twins do on the card: no product is
# contracted into an FMA unless the code says fmaf (csrc/gi_core.cuh,
# which B8, B9, B11 and B12 inline; B13 and B14's Moller-Trumbore test).
SOURCE_FLAGS = {"gi_trace.cu": ["-fmad=false"],
                "gi_resolve.cu": ["-fmad=false"],
                "intersect.cu": ["-fmad=false"]}

_lib = None
_lock = threading.Lock()
build_seconds = None  # wall time of the last build in this process
build_log = None  # nvcc / ptxas output of that build (registers, spills)


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found (CUDA toolkit needed to build "
                           "restir_tpu_torch/csrc)")
    return cand


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256()
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    return h.hexdigest()[:16]


PROBE_DIR = SRC_DIR / "prof"
# name -> (sources relative to csrc/, extra nvcc flags): the stage probes'
# builds (restir_tpu_torch/prof). "*_full" is the source as the main
# library builds it (its packs must equal the main library's bit for bit).
VARIANTS = {
    "b6_full": (["gbuffer_bvh.cu"], []),
    "b6_const": (["gbuffer_bvh.cu"], ["-DPROBE_GBUF=1"]),
    "b6_raygen": (["gbuffer_bvh.cu"], ["-DPROBE_GBUF=2"]),
    "b6_hit": (["gbuffer_bvh.cu"], ["-DPROBE_GBUF=3"]),
    "b6_epi": (["gbuffer_bvh.cu"], ["-DPROBE_GBUF=4"]),
    "b7_full": (["reuse_bvh.cu"], []),
    "b7_search": (["reuse_bvh.cu"], ["-DPROBE_WALK=1"]),
    "b7_fixed_node": (["reuse_bvh.cu"], ["-DPROBE_WALK=2"]),
    "b7_no_leaf": (["reuse_bvh.cu"], ["-DPROBE_WALK=3"]),
    "b7_no_exit": (["reuse_bvh.cu"], ["-DPROBE_WALK=4"]),
    "b10_full": (["ris_cdf.cu"], []),
    "b10_search": (["ris_cdf.cu"], ["-DPROBE_WALK=1"]),
    "b10_fixed_node": (["ris_cdf.cu"], ["-DPROBE_WALK=2"]),
    "b10_no_leaf": (["ris_cdf.cu"], ["-DPROBE_WALK=3"]),
    "prof": (["prof/anyhit.cu", "prof/mem.cu"], []),
    # the FP32 any hit one ray a lane: the reference of the probe library's
    # several-rays-a-lane build (tests/test_torch_prof_cuda.py)
    "prof_ray1": (["prof/anyhit.cu"], ["-DPROBE_ANYHIT_RAYS=1"]),
}
_variant_libs = {}


def variant_digest(name: str) -> str:
    """Digest of a named variant: its sources, every header of csrc/ and
    csrc/prof/, and its flags."""
    srcs, flags = VARIANTS[name]
    h = hashlib.sha256(name.encode())
    files = ([SRC_DIR / s for s in srcs] + sorted(SRC_DIR.glob("*.cuh"))
             + sorted(PROBE_DIR.glob("*.cuh")))
    for f in files:
        h.update(str(f.relative_to(SRC_DIR)).encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS + flags).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    return h.hexdigest()[:16]


def _variant_path(name: str) -> Path:
    return BUILD_DIR / f"librestir_{name}_{variant_digest(name)}.so"


def _compile_and_link(libs, tmp):
    """libs: [(out path, [(source path, extra flags)], log label)]. One
    nvcc per source, all started together, then one link per library.
    Returns the compiler's log (a `--- <label><source>` line before each
    source's output); raises on any failure."""
    nvcc = _nvcc()
    procs = []
    for k, (_, srcs, label) in enumerate(libs):
        for src, flags in srcs:
            obj = os.path.join(tmp, f"{k}_{src.stem}.o")
            cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src.name, []),
                   *flags, "-I", str(SRC_DIR), "-c", "-o", obj, str(src)]
            procs.append((k, label + src.name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    logs, failed = [], []
    for k, name, _, proc in procs:
        log = proc.communicate()[0]
        logs.append(f"--- {name}\n{log}")
        if proc.returncode != 0:
            failed.append(f"{libs[k][0].name}: {name}")
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "".join(logs))
    for k, (out, _, _) in enumerate(libs):
        fd, lib = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", lib, *(o for j, _, o, _ in procs if j == k)],
            capture_output=True, text=True)
        if link.returncode != 0:
            os.unlink(lib)
            raise RuntimeError(f"nvcc link of {out.name} failed "
                               f"({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(lib, out)
    return "".join(logs)


def build(variants=()) -> Path:
    """Compile the kernels if the cached library is missing; return its
    path. The compiler's output (ptxas's registers and spills per kernel)
    lands in `build_log`. Named `variants` missing from the cache compile
    in the same round (one nvcc per source, all started together)."""
    global build_seconds, build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"librestir_kernels_{_digest()}.so"
    libs = []
    if not out.exists():
        libs.append((out, [(src, []) for src in sorted(SRC_DIR.glob("*.cu"))],
                     ""))
    for name in variants:
        path = _variant_path(name)
        if not path.exists():
            srcs, flags = VARIANTS[name]
            libs.append((path, [(SRC_DIR / s, flags) for s in srcs],
                         f"{name}/"))
    if not libs:
        return out
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        log = _compile_and_link(libs, tmp)
    build_seconds = time.perf_counter() - t0
    build_log = log
    return out


_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32
_L = ctypes.c_int64

_SIGNATURES = {
    "restir_di_resident_gbuffer_ris": [
        _VP, _VP, _U, _VP, _I, _VP, _VP, _VP, _I, _VP, _VP, _I, _I,
        _VP, _VP, _VP, _I, _I, _I, _VP, _VP,
        _I, _I, _F, _I, _I, _I, _I, _VP],
    "restir_di_resident_temporal": [
        _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _U, _I, _I, _F, _VP],
    "restir_spatial_shade": [
        _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _U, _I, _I, _I, _VP],
    "restir_atrous_eaw": [
        _VP, _VP, _VP, _I, _I, _I, _F, _F, _F, _VP],
    "restir_atrous_svgf": [
        _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _F, _F, _F, _VP],
    "restir_atrous_div_check": [_F, _VP, _VP],
    "restir_gbuffer_bvh": [
        _VP, _VP, _U, _VP, _I, _VP, _VP, _VP, _I,
        _VP, _VP, _VP, _I, _I, _I, _VP, _VP, _I, _I, _I, _I,
        _F, _I, _I, _VP],
    "restir_reuse_bvh": [
        _VP, _U, _VP, _VP, _I, _I, _I, _I, _VP, _I, _VP, _VP, _VP, _I, _I,
        _I, _I, _I, _I, _VP],
    "restir_reuse_bvh_seg": [_I, _I],
    "restir_svgf_temporal": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP],
    "restir_svgf_variance": [_VP, _L, _L, _VP, _VP, _I, _I, _VP],
    "restir_svgf_filter_variance": [_VP, _VP, _I, _I, _VP],
    "restir_closest_hit": [
        _VP, _VP, _VP, _I, _VP, _VP, _VP, _VP, _VP, _I, _VP],
    "restir_any_hit": [_VP, _VP, _VP, _VP, _I, _VP, _VP, _VP, _I, _VP],
    "restir_primary_hit": [
        _VP, _VP, _VP, _VP, _I, _VP, _VP, _VP, _I, _VP, _VP, _I, _VP],
    "restir_mt_closest_hit": [
        _VP, _VP, _VP, _VP, _VP, _I, _VP, _VP, _VP, _VP, _VP, _I, _VP],
    "restir_mt_any_hit": [
        _VP, _VP, _VP, _VP, _I, _VP, _VP, _VP, _I, _I, _I, _VP],
    "restir_mt_primary_hit": [
        _VP, _VP, _VP, _VP, _I, _VP, _VP, _VP, _I, _VP, _VP, _I, _I, _I,
        _VP],
    "restir_bvh_heatmap": [
        _VP, _VP, _VP, _I, _VP, _VP, _VP, _I, _I, _I, _VP],
    "restir_ris_cdf": [
        _VP, _U, _U, _VP, _VP, _I, _I, _I, _VP, _I, _VP, _VP, _VP, _I, _I,
        _I, _I, _VP],
    "restir_gi_trace": [
        _VP, _I, _U, _U, _VP, _I, _VP, _VP, _VP, _I, _VP, _I, _F, _I, _I,
        _I, _I, _I, _VP, _VP, _VP],
    "restir_gi_resolve": [
        _VP, _VP, _VP, _VP, _I, _I, _I, _I, _U, _U, _I, _I, _I, _VP, _VP,
        _VP],
    # csrc/sort.cu: ray order (B13's closest hit and the stage probes)
    "restir_ray_key": [_VP, _VP, _VP, _VP, _I, _VP, _VP],
    "restir_prof_key": [_VP, _VP, _VP, _I, _F, _F, _F, _F, _F, _F, _I, _VP,
                        _VP],
    "restir_prof_sort_scratch": [_I],
    "restir_prof_radix_sort": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _VP],
    "restir_prof_sort_launches": [],
    "restir_prof_permute": [_VP, _VP, _VP, _VP, _VP, _I, _I, _VP, _I, _I,
                            _VP],
    "restir_prof_copy": [_VP, _VP, _L, _VP],
}


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call; thread-safe: the
    viewer's render thread may be the first to launch a kernel)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            lib.restir_error_string.argtypes = [ctypes.c_int]
            lib.restir_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


_PROF_SIGNATURES = {
    "restir_prof_anyhit": [_VP, _VP, _I, _I, _I, _VP, _VP],
    "restir_prof_table_gather": [_VP, _I, _VP, _I, _I, ctypes.c_uint64, _VP,
                                 _VP],
    "restir_prof_tex": [_VP, _I, _I, ctypes.POINTER(ctypes.c_uint64)],
    "restir_prof_chain": [_VP, _VP, _VP, _I, _I, _VP, _VP],
    "restir_prof_mark": [_VP],
}


def variant_library(name: str) -> ctypes.CDLL:
    """The loaded library of a named variant (`VARIANTS`), built on first
    call; its C entry points carry the main library's signatures (or the
    probe kernels')."""
    if name in _variant_libs:
        return _variant_libs[name]
    with _lock:
        if name not in _variant_libs:
            build([name])
            lib = ctypes.CDLL(str(_variant_path(name)))
            for fn_name, args in {**_SIGNATURES, **_PROF_SIGNATURES}.items():
                fn = getattr(lib, fn_name, None)
                if fn is not None:
                    fn.argtypes = args
                    fn.restype = ctypes.c_int
            _variant_libs[name] = lib
        return _variant_libs[name]


def check(err: int, what: str) -> None:
    if err != 0:
        msg = library().restir_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def ptr(t) -> int:
    """Device pointer of a tensor; None -> a null pointer."""
    return None if t is None else t.data_ptr()


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def on_device(device: torch.device):
    """Context for a launch on `device`: a C entry point launches on the
    calling thread's current CUDA device, which a tensor on another card
    of the host (a row band of `restir_tpu_torch.parallel`) does not
    set."""
    return torch.cuda.device(device)
