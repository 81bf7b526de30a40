"""Build, load and count the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), loaded with ``ctypes``. Builds run at first use, one
``nvcc`` per source, all started together, into ``_build/`` beside this
file; a library's file name carries a digest of its source and of the
headers (``csrc/*.cuh``), so an edited source is rebuilt and a stale
library is never loaded. ``$KEYSTONE_CUDA_BUILD_DIR`` names another build
directory (a fresh one measures a host's first start, nvcc included);
the AOT store (``serving/aot.py``) keeps built libraries by the same
digest and the toolchain (``nvcc_version``), so that a host with the
store skips ``nvcc``.

``LAUNCHES`` counts the kernel launches of each wrapper: a wrapper adds
one (``count``) where it launches its kernel, and nowhere else (a call on
CPU tensors runs the plain version and counts nothing). A call made
while its thread captures a CUDA graph launches nothing: it counts into
the capture's tally (``capture_tally``) instead, and the serving engine
adds that tally to ``LAUNCHES`` (``add_launches``) on every replay of the
graph, so the counts stay one per kernel that ran on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.environ.get("KEYSTONE_CUDA_BUILD_DIR") or os.path.join(_HERE, "_build")

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
        # planes, at, b, at_lo, at_hi, b_lo, b_hi, row_order, out, B, P, H, W,
        # M, N, stream
        "ks_plane_sandwich": [_P] * 9 + [_I] * 6 + [_P],
    },
    "fv_stats": {
        # x, means, variances, weights, thresh, terms, norms, partial, out, B,
        # d, m, k, rows_per_block, stream
        "ks_fv_stats": [_P] * 4 + [_F] + [_P] * 4 + [_I] * 5 + [_P],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register / shared-memory report) per library
BUILD_LOGS: Dict[str, str] = {}
# wall seconds of the last nvcc run of each library this process built
# (libraries built together share one run's seconds), and the wall
# seconds of every build this process ran nvcc in, summed
BUILD_SECONDS: Dict[str, float] = {}
BUILD_WALL_S = 0.0


_count_lock = threading.Lock()
_capture = threading.local()


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def count(name: str) -> None:
    """One launch of ``name``'s kernel, or, while this thread captures a
    CUDA graph, one launch into the capture's tally."""
    tally = getattr(_capture, "tally", None)
    if tally is not None:
        tally[name] = tally.get(name, 0) + 1
        return
    with _count_lock:
        LAUNCHES[name] += 1


def add_launches(counts: Dict[str, int]) -> None:
    """The launches of one replay of a captured graph."""
    with _count_lock:
        for name, n in counts.items():
            LAUNCHES[name] += n


@contextlib.contextmanager
def capture_tally(refs: Optional[list] = None):
    """Count this thread's launches into the yielded dict instead of
    ``LAUNCHES`` (around a CUDA graph capture), and collect into ``refs``
    what ``keep_alive`` is given meanwhile."""
    tally: Dict[str, int] = {}
    _capture.tally = tally
    _capture.refs = refs
    try:
        yield tally
    finally:
        _capture.tally = None
        _capture.refs = None


def keep_alive(obj) -> None:
    """Tensors that a kernel launched in this thread reads, kept by the CUDA
    graph being captured here (its holder owns ``capture_tally``'s
    ``refs``), so that a cache that drops them cannot free memory a replay
    reads. Outside a capture, nothing."""
    refs = getattr(_capture, "refs", None)
    if refs is not None:
        refs.append(obj)


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


def source_digest(name: str) -> str:
    """Digest of library ``name``'s source and of every header."""
    digest = hashlib.sha256()
    for path in (source_path(name), *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))):
        with open(path, "rb") as f:
            digest.update(f.read())
    return digest.hexdigest()


def sources_digest() -> str:
    """Digest of every kernel source and header under ``csrc/``: a kernel
    edit changes it."""
    digest = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*"))):
        digest.update(os.path.basename(path).encode() + b"\0")
        with open(path, "rb") as f:
            digest.update(f.read())
    return digest.hexdigest()


def library_path(name: str) -> str:
    """Where library ``name`` of the current sources is built."""
    return os.path.join(BUILD_DIR, f"libks_{name}_{source_digest(name)[:12]}.so")


_nvcc_version: Optional[str] = None


def nvcc_version() -> Optional[str]:
    """The last line of ``nvcc --version`` (its build), or None where no
    nvcc is found; read once a process."""
    global _nvcc_version
    if _nvcc_version is None:
        try:
            out = subprocess.run(
                [_nvcc(), "--version"], capture_output=True, text=True, timeout=60,
            ).stdout.strip().splitlines()
            _nvcc_version = out[-1] if out else ""
        except (OSError, RuntimeError, subprocess.SubprocessError):
            _nvcc_version = ""
    return _nvcc_version or None


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named library that is not built yet, all ``nvcc``s in
    parallel, and wait for them. Returns name -> library path; raises with
    the compiler's output if any build fails."""
    global BUILD_WALL_S
    names = list(SOURCES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    if todo:
        nvcc = _nvcc()
        t0 = time.perf_counter()
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
            BUILD_SECONDS[n] = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append(f"{SOURCES[n]}:\n{out}")
            else:
                os.replace(tmp, paths[n])
        BUILD_WALL_S += time.perf_counter() - t0
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
