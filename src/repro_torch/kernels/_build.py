"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` source is compiled on its own by `nvcc` for `sm_90a`
into a shared library with a plain C interface, at first use, into the
repository's git-ignored `build/kernels/`, and loaded with `ctypes`.
A library's file name carries a hash of its source, its own headers and
the flags, so an edited source is never served a stale build. Missing
libraries are built concurrently, one `nvcc` each. Nothing here runs at
import time, so the CPU tests import the package without `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, List

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
# library -> the csrc headers its source includes (hashed into its name)
HEADERS = {"iss_segment": ("rv32e_step.cuh", "flexifault.cuh"),
           "iss_refill": (),
           "carbon_sweep": ("carbon_sweep.cuh", "sweep_draws.cuh"),
           "flash_attention": ("lm_mma.cuh", "lm_tiles.cuh"),
           "ssd_scan": ("lm_mma.cuh", "lm_tiles.cuh"),
           "bitplane_matmul": ("lm_mma.cuh", "lm_tiles.cuh")}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_U = ctypes.c_uint32
_F = ctypes.c_float
# library -> {C symbol: argument types}; every pointer and the stream are
# c_void_p, so ctypes never narrows one to a 32-bit int
SIGNATURES = {
    "iss_segment": {"iss_segment_banked_launch":
                    [_P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I,
                     _P, _P, _P, _P, _P, _I, _I,
                     _I, _P, _P, _U, _I, _I, _I, _I, _I, _P]},
    "iss_refill": {"iss_refill_launch":
                   [_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P,
                    _P, _P, _P, _I, _P]},
    "carbon_sweep": {
        "carbon_sweep_launch": [_I] + [_P] * 26 + [_I] * 5 + [_D] * 4 + [_P],
        "carbon_sweep_drawn_launch": [_I, _U, _U] + [_P] * 4 + [_I, _I, _D]
        + [_P] * 26 + [_I] * 5 + [_D] * 4 + [_P]},
    "flash_attention": {
        "flash_attention_launch": [_I] + [_P] * 5 + [_I] * 7 + [_F, _P],
        "flash_attention_bwd_launch": [_I] + [_P] * 10 + [_I] * 7
        + [_F, _P]},
    "ssd_scan": {"ssd_scan_launch": [_I] + [_P] * 8 + [_I] * 6 + [_P],
                 "ssd_scan_bwd_launch": [_P] * 13 + [_I] * 7 + [_P],
                 "ssd_scan_bwd_wgmma_launch": [_P] * 15 + [_I] * 9 + [_P],
                 "ssd_scan_bwd_wgmma_info": [_I] * 4 + [_P]},
    "bitplane_matmul": {
        "bitplane_matmul_launch": [_I] + [_P] * 5 + [_I] * 4 + [_P],
        "bitplane_repack_launch": [_P, _P, _I, _I, _I, _P],
        "bitplane_gemm_launch": [_P] * 4 + [_I] * 3 + [_P]},
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_logs: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked at $NVCC, PATH and "
                       "/usr/local/cuda/bin): the CUDA kernels are built "
                       "from source at first use")


def lib_path(name: str) -> pathlib.Path:
    """Where library `name` is (or will be) built."""
    h = hashlib.sha256()
    for f in (f"{name}.cu",) + HEADERS[name]:
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: List[str] = None) -> Dict[str, float]:
    """Build every missing library, all `nvcc` runs started together.
    Returns {name: build seconds} (0.0 for one already built); raises
    with the compiler's output if a build fails."""
    names = list(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: lib_path(n) for n in names if not lib_path(n).exists()}
    secs = {n: 0.0 for n in names}
    procs = {}
    t0 = time.perf_counter()
    for n, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    errors = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[n] = time.perf_counter() - t0
        _logs[n] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)          # atomic: concurrent builds agree
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def build_log(name: str) -> str:
    """The compiler's output (ptxas register and spill report) for a
    library this process built, or '' if it found one already built."""
    return _logs.get(name, "")


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, building it first if it is missing."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            for sym, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded[name] = lib
        return lib
