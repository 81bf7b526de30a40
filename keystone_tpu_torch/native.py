"""ctypes bindings for the native JPEG decoder (counterpart of the JPEG part
of ``keystone_tpu/native.py``).

The streaming loaders decode at a fixed size through ``native/jpeg.cc``
(libjpeg's DCT-scaled draft decode, then a triangle-filter resize to the
target square, with the GIL released for the whole call, so a thread pool
of decoders scales across cores). The port builds its own copy of the
library at first use, with ``native/Makefile``'s flags, into
``keystone_tpu_torch/_build/`` (the file name carries a digest of the
source, so an edited source is rebuilt); it never writes into ``native/``.
When the library cannot be built or loaded (no compiler, no libjpeg), the
functions return ``None`` and the loaders decode with PIL, as the JAX
package does.

This module imports neither torch nor jax: spawned decode workers load it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
JPEG_SOURCE = os.path.join(os.path.dirname(_HERE), "native", "jpeg.cc")
BUILD_DIR = os.path.join(_HERE, "_build")
# native/Makefile's CXXFLAGS and LDFLAGS, and the jpeg target's -ljpeg
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _lib_path() -> str:
    with open(JPEG_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libkeystone_jpeg_{digest}.so")


def _build(path: str) -> None:
    """Compile ``native/jpeg.cc`` into ``path`` under an exclusive file
    lock (spawned decode workers reach their first decode together), into
    a temporary file that is renamed into place."""
    import fcntl

    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".jpeg.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):  # another process built it meanwhile
            return
        tmp = f"{path}.{os.getpid()}.tmp"
        cxx = os.environ.get("CXX", "g++")
        try:
            subprocess.run(
                [cxx, *CXX_FLAGS, JPEG_SOURCE, "-o", tmp, "-ljpeg"],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def _open() -> Optional[ctypes.CDLL]:
    """The library, built first if needed; None when that fails."""
    try:
        path = _lib_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
    except (OSError, subprocess.SubprocessError):
        return None
    lib.jpeg_decode_f32.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
    ]
    lib.jpeg_decode_f32.restype = ctypes.c_int
    lib.jpeg_decode_batch_f32.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
    ]
    lib.jpeg_decode_batch_f32.restype = ctypes.c_int64
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    # the unlocked check trusts _tried only once an attempt has finished:
    # it is set after _lib, never before
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is None and not _tried:
            try:
                _lib = _open()
            finally:
                _tried = True
        return _lib


def jpeg_native_available() -> bool:
    return _load() is not None


def jpeg_decode_f32(data: bytes, target: int) -> Optional[np.ndarray]:
    """One JPEG as a (target, target, 3) float32 RGB array (0..255), or
    None when the library is unavailable or declines the image (a corrupt
    stream, CMYK): the caller then decodes it with PIL."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((target, target, 3), np.float32)
    rc = lib.jpeg_decode_f32(
        data, len(data), target, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    )
    return out if rc == 0 else None


def jpeg_decode_batch_f32(
    blobs, target: int, num_threads: int = 0
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """JPEG byte strings decoded in one native call with its own thread
    pool: ``(images (n, target, target, 3) float32, ok (n,) bool)``, where
    a slot that failed has undefined pixels and ok False. None when the
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(blobs)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    out = np.empty((n, target, target, 3), np.float32)
    ok = np.zeros(n, np.uint8)
    lib.jpeg_decode_batch_f32(
        b"".join(blobs), offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
        target, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), num_threads,
    )
    return out, ok.astype(bool)
