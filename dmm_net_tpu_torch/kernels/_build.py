"""Build the package's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` for ``sm_90a`` into ``dmm_net_tpu_torch/_build/`` (git-ignored):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded. ``build_all`` starts
one ``nvcc`` per source at once and waits for all of them.

Every C entry point returns ``cudaGetLastError()``; ``check`` raises when it
is not 0. The launch counters live here too: a wrapper calls ``count(name)``
where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("matcher", "resolve", "roi_align")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_LAUNCHES: Dict[str, int] = {"fused_pool_cost_match": 0,
                             "fused_resolve_upsample": 0,
                             "fused_cost_match": 0,
                             "roi_align": 0}
# Calls of B1's and B4's backwards on CUDA (kernels/matcher.py,
# kernels/roi_align.py): autograd through the plain version, with no kernel
# of their own, so counted apart from launches.
_BACKWARD_CALLS: Dict[str, int] = {"fused_pool_cost_match": 0, "roi_align": 0}

# C signatures: every pointer and the stream are c_void_p (a bare Python int
# would be passed as a 32-bit int and cut the pointer). Every function
# returns a cudaError_t as int, except those in _RESTYPES.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "matcher": {
        "dmm_fused_pool_cost_match":
            [_P] * 9 + [_I] * 6 + [_F, _I, _F, _I, _F, _F, _P],
        "dmm_fused_cost_match": [_P] * 8 + [_I] * 5 + [_F, _I, _F, _P],
        "dmm_matcher_scratch_floats": [_I] * 6,
    },
    "resolve": {
        "dmm_resolve_upsample_f32": [_P] * 9 + [_I] * 8 + [_F, _P],
        "dmm_resolve_upsample_bf16": [_P] * 9 + [_I] * 8 + [_F, _P],
        "dmm_resolve_smem_bytes": [_I] * 3,
        "dmm_resolve_band_rows": [],
        "dmm_resolve_tile_cols": [],
    },
    "roi_align": {
        "dmm_roi_align":
            [_P] * 4 + [_I] * 8 + [_F] * 4 + [_I] + [_P] * 3 + [_I] * 5 + [_P],
    },
}


_RESTYPES = {"dmm_matcher_scratch_floats": ctypes.c_longlong,
             "dmm_resolve_smem_bytes": ctypes.c_longlong}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, then PATH, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "(the CUDA kernels are built at first use)")


def _library_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start_build(name: str):
    """Start nvcc for one source unless its library exists; returns the
    process (or None) and the library path."""
    lib = _library_path(name)
    if lib.exists():
        return None, lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return (proc, tmp), lib


def _finish_build(name: str, job, lib: Path) -> None:
    if job is None:
        return
    proc, tmp = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)       # atomic: a concurrent loader never sees half a file


def _bind(name: str, lib: Path) -> ctypes.CDLL:
    handle = ctypes.CDLL(str(lib))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(handle, fn)
        f.argtypes = argtypes
        f.restype = _RESTYPES.get(fn, ctypes.c_int)
    return handle


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, ctypes.CDLL]:
    """Compile every missing library in parallel (one nvcc per source) and
    load them all."""
    jobs = {n: _start_build(n) for n in names if n not in _libs}
    for n, (job, lib) in jobs.items():
        _finish_build(n, job, lib)
    for n, (_, lib) in jobs.items():
        _libs[n] = _bind(n, lib)
    return dict(_libs)


def library(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build_all([name])
    return _libs[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with cudaError {err}")


def count(name: str) -> None:
    _LAUNCHES[name] += 1


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def count_backward(name: str) -> None:
    _BACKWARD_CALLS[name] += 1


def backward_calls() -> Dict[str, int]:
    return dict(_BACKWARD_CALLS)


def reset_launch_counts() -> None:
    """Set every launch count and every backward-call count to 0."""
    for counts in (_LAUNCHES, _BACKWARD_CALLS):
        for k in counts:
            counts[k] = 0
