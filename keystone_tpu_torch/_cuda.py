"""Build, load and count the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), loaded with ``ctypes``. Builds run at first use, one
``nvcc`` per source, all started together, into ``_build/`` beside this
file; a library's file name carries a digest of its source, so an edited
source is rebuilt and a stale library is never loaded.

``LAUNCHES`` counts the kernel launches of each wrapper: a wrapper adds
one where it launches its kernel, and nowhere else (a call on CPU tensors
runs the plain version and counts nothing).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Optional

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

# library name -> source file under csrc/
SOURCES: Dict[str, str] = {
    "sift_bin": "sift_bin.cu",
    "sandwich": "sandwich.cu",
    "fv_stats": "fv_stats.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: Dict[str, int] = {
    "sift_bin_sample": 0,
    "plane_sandwich": 0,
    "fisher_vector_stats": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every exported function; each returns a cudaError_t
SIGNATURES = {
    "sift_bin": {
        # mag, orient, ayt, ax, ay_lo, ay_hi, ax_lo, ax_hi, row_order, out, B,
        # H, W, M, N, stream
        "ks_sift_bin_sample": [_P] * 10 + [_I] * 5 + [_P],
    },
    "sandwich": {
        # planes, at, b, out, B, P, H, W, M, N, stream
        "ks_plane_sandwich": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    },
    "fv_stats": {
        # x, means, variances, weights, thresh, terms, partial, out, B, d, m,
        # k, rows_per_block, stream
        "ks_fv_stats": [_P] * 4 + [_F] + [_P] * 3 + [_I] * 5 + [_P],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register / shared-memory report) per library
BUILD_LOGS: Dict[str, str] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and under $CUDA_HOME or "
            "/usr/local/cuda); the port's CUDA kernels are built at first use"
        )
    return path


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, SOURCES[name])


def _lib_path(name: str) -> str:
    with open(source_path(name), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libks_{name}_{digest}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named library that is not built yet, all ``nvcc``s in
    parallel, and wait for them. Returns name -> library path; raises with
    the compiler's output if any build fails."""
    names = list(SOURCES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    if todo:
        nvcc = _nvcc()
        procs = {}
        for n in todo:
            tmp = f"{paths[n]}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, source_path(n)]
            procs[n] = (
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                ),
                tmp,
            )
        failed = []
        for n, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            BUILD_LOGS[n] = out
            if proc.returncode != 0:
                failed.append(f"{SOURCES[n]}:\n{out}")
            else:
                os.replace(tmp, paths[n])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def lib(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        loaded = _libs.get(name)
        if loaded is None:
            loaded = ctypes.CDLL(build([name])[name])
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(loaded, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = loaded
        return loaded


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on one CUDA device, False when all are on
    the CPU; raises otherwise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on more than one device: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {dev}")


def check_arg(t: torch.Tensor, name: str, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-D float32 tensor."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream
