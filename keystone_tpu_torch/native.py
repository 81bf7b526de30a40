"""ctypes bindings for the native host runtime (counterpart of
``keystone_tpu/native.py``): the JPEG decoder (``native/jpeg.cc``), the
CSV parser and CIFAR record decoder (``native/io.cc``) and the fused text
featurizer (``native/text.cc``).

The streaming loaders decode at a fixed size through ``native/jpeg.cc``
(libjpeg's DCT-scaled draft decode, then a triangle-filter resize to the
target square, with the GIL released for the whole call, so a thread pool
of decoders scales across cores). ``native/io.cc`` parses numeric CSVs on
several threads and decodes CIFAR binary records. ``native/text.cc`` runs
trim, ASCII lowercase, tokenization and rolling n-gram hashing of a batch
of documents on several threads and writes CSR triplets. The port builds its own
copy of each library at first use, with ``native/Makefile``'s flags, into
``keystone_tpu_torch/_build/`` (the file name carries a digest of the
source, so an edited source is rebuilt); it never writes into ``native/``.
When a library cannot be built or loaded (no compiler, no libjpeg), the
functions take the JAX package's own host routes: PIL for JPEGs (the
decoders return ``None``), numpy for CSVs and CIFAR records, the composed
Python text nodes for documents (``text_ngram_hash_tf`` returns ``None``).

This module imports neither torch nor jax: spawned decode workers load it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_NATIVE_DIR = os.path.join(os.path.dirname(_HERE), "native")
JPEG_SOURCE = os.path.join(_NATIVE_DIR, "jpeg.cc")
IO_SOURCE = os.path.join(_NATIVE_DIR, "io.cc")
TEXT_SOURCE = os.path.join(_NATIVE_DIR, "text.cc")
BUILD_DIR = os.path.join(_HERE, "_build")
# native/Makefile's CXXFLAGS and LDFLAGS
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread")

P = ctypes.POINTER


def _bind_jpeg(lib: ctypes.CDLL) -> None:
    lib.jpeg_decode_f32.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, P(ctypes.c_float),
    ]
    lib.jpeg_decode_f32.restype = ctypes.c_int
    lib.jpeg_decode_batch_f32.argtypes = [
        ctypes.c_char_p, P(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int, P(ctypes.c_float), P(ctypes.c_uint8), ctypes.c_int,
    ]
    lib.jpeg_decode_batch_f32.restype = ctypes.c_int64


def _bind_io(lib: ctypes.CDLL) -> None:
    lib.csv_dims.argtypes = [ctypes.c_char_p, P(ctypes.c_int64), P(ctypes.c_int64)]
    lib.csv_dims.restype = ctypes.c_int
    lib.csv_read_f32.argtypes = [
        ctypes.c_char_p, P(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int,
    ]
    lib.csv_read_f32.restype = ctypes.c_int
    lib.cifar_read.argtypes = [
        ctypes.c_char_p, P(ctypes.c_int32), P(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.cifar_read.restype = ctypes.c_int64


def _bind_text(lib: ctypes.CDLL) -> None:
    lib.text_ngram_hash_tf.argtypes = [
        ctypes.c_char_p, P(ctypes.c_int64), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int64, ctypes.c_int, P(ctypes.c_int64),
        P(ctypes.c_int32), P(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
    ]
    lib.text_ngram_hash_tf.restype = ctypes.c_int64


class _Library:
    """One native source, built into ``BUILD_DIR`` and loaded at first
    use; ``None`` when that fails."""

    def __init__(self, source: str, stem: str, link: Sequence[str],
                 bind: Callable[[ctypes.CDLL], None]):
        self.source, self.stem, self.link, self.bind = source, stem, tuple(link), bind
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._tried = False

    def _path(self) -> str:
        with open(self.source, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:12]
        return os.path.join(BUILD_DIR, f"lib{self.stem}_{digest}.so")

    def _build(self, path: str) -> None:
        """Compile the source into ``path`` under an exclusive file lock
        (spawned decode workers reach their first decode together), into
        a temporary file that is renamed into place."""
        import fcntl

        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, f".{self.stem}.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if os.path.exists(path):  # another process built it meanwhile
                return
            tmp = f"{path}.{os.getpid()}.tmp"
            cxx = os.environ.get("CXX", "g++")
            try:
                subprocess.run(
                    [cxx, *CXX_FLAGS, self.source, "-o", tmp, *self.link],
                    check=True, capture_output=True, timeout=120,
                )
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)

    def _open(self) -> Optional[ctypes.CDLL]:
        try:
            path = self._path()
            if not os.path.exists(path):
                self._build(path)
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.SubprocessError):
            return None
        self.bind(lib)
        return lib

    def load(self) -> Optional[ctypes.CDLL]:
        # the unlocked check trusts _tried only once an attempt has
        # finished: it is set after _lib, never before
        if self._lib is not None or self._tried:
            return self._lib
        with self._lock:
            if self._lib is None and not self._tried:
                try:
                    self._lib = self._open()
                finally:
                    self._tried = True
            return self._lib


_JPEG = _Library(JPEG_SOURCE, "keystone_jpeg", ("-ljpeg",), _bind_jpeg)
_IO = _Library(IO_SOURCE, "keystone_io", (), _bind_io)
_TEXT = _Library(TEXT_SOURCE, "keystone_text", (), _bind_text)


def jpeg_native_available() -> bool:
    return _JPEG.load() is not None


def io_native_available() -> bool:
    return _IO.load() is not None


def native_available() -> bool:
    """The IO library (CSV parsing, CIFAR records) built and loaded."""
    return io_native_available()


def text_native_available() -> bool:
    return _TEXT.load() is not None


def jpeg_decode_f32(data: bytes, target: int) -> Optional[np.ndarray]:
    """One JPEG as a (target, target, 3) float32 RGB array (0..255), or
    None when the library is unavailable or declines the image (a corrupt
    stream, CMYK): the caller then decodes it with PIL."""
    lib = _JPEG.load()
    if lib is None:
        return None
    out = np.empty((target, target, 3), np.float32)
    rc = lib.jpeg_decode_f32(
        data, len(data), target, out.ctypes.data_as(P(ctypes.c_float))
    )
    return out if rc == 0 else None


def jpeg_decode_batch_f32(
    blobs, target: int, num_threads: int = 0
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """JPEG byte strings decoded in one native call with its own thread
    pool: ``(images (n, target, target, 3) float32, ok (n,) bool)``, where
    a slot that failed has undefined pixels and ok False. None when the
    library is unavailable."""
    lib = _JPEG.load()
    if lib is None:
        return None
    n = len(blobs)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    out = np.empty((n, target, target, 3), np.float32)
    ok = np.zeros(n, np.uint8)
    lib.jpeg_decode_batch_f32(
        b"".join(blobs), offsets.ctypes.data_as(P(ctypes.c_int64)), n,
        target, out.ctypes.data_as(P(ctypes.c_float)),
        ok.ctypes.data_as(P(ctypes.c_uint8)), num_threads,
    )
    return out, ok.astype(bool)


def read_csv_f32(path: str, delimiter: str = ",", num_threads: int = 0) -> np.ndarray:
    """Numeric CSV -> (rows, cols) float32: the native multi-threaded
    parser when available, ``np.loadtxt`` otherwise (and for a ragged or
    malformed file, whose error numpy then reports)."""
    lib = _IO.load()
    if lib is None or delimiter not in (",", " ", "\t"):
        return np.loadtxt(path, delimiter=delimiter, dtype=np.float32, ndmin=2)
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    if lib.csv_dims(path.encode(), ctypes.byref(rows), ctypes.byref(cols)):
        raise OSError(f"cannot read {path}")
    out = np.empty((rows.value, cols.value), np.float32)
    rc = lib.csv_read_f32(
        path.encode(), out.ctypes.data_as(P(ctypes.c_float)), rows.value,
        cols.value, num_threads,
    )
    if rc != 0:
        return np.loadtxt(path, delimiter=delimiter, dtype=np.float32, ndmin=2)
    return out


def read_cifar(path: str, channels: int = 3, dim: int = 32
               ) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR binary -> (labels int32 (n,), images float32 (n, dim, dim, c)),
    whole records only."""
    lib = _IO.load()
    rec_len = 1 + channels * dim * dim
    n = os.path.getsize(path) // rec_len
    if lib is None:
        raw = np.fromfile(path, dtype=np.uint8)[: n * rec_len].reshape(n, rec_len)
        labels = raw[:, 0].astype(np.int32)
        images = (
            raw[:, 1:].reshape(n, channels, dim, dim).transpose(0, 2, 3, 1)
            .astype(np.float32)
        )
        return labels, images
    labels = np.empty(n, np.int32)
    images = np.empty((n, dim, dim, channels), np.float32)
    got = lib.cifar_read(
        path.encode(), labels.ctypes.data_as(P(ctypes.c_int32)),
        images.ctypes.data_as(P(ctypes.c_float)), n, channels, dim,
    )
    if got < 0:
        raise OSError(f"cannot read {path}")
    return labels[:got], images[:got]


def text_ngram_hash_tf(docs, min_order: int, max_order: int, num_features: int,
                       binarize: bool = False, num_threads: int = 0):
    """Fused trim / lowercase / tokenize / rolling n-gram hash TF over a
    list of ASCII documents: ``(row_ptr int64 (n+1,), cols int32 (nnz,),
    vals float32 (nnz,))``, each document's columns ascending, hash-identical
    to Trim -> LowerCase -> Tokenizer -> NGramsHashingTF, on one thread per
    CPU this process may run on (by default). ``None`` when the library is
    unavailable or a document is not ASCII (the C++ tokenizer is
    byte-level): the caller then runs the Python nodes."""
    if num_features <= 0:  # a modulo by zero in C++ would raise SIGFPE
        raise ValueError(f"num_features must be positive: {num_features}")
    lib = _TEXT.load()
    if lib is None:
        return None
    try:
        blobs = [d.encode("ascii") for d in docs]
    except UnicodeEncodeError:
        return None
    n = len(blobs)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    concat = b"".join(blobs)
    row_ptr = np.zeros(n + 1, np.int64)
    cap = max(2 * len(concat) + 16, 1024)
    for _ in range(2):
        cols = np.empty(cap, np.int32)
        vals = np.empty(cap, np.float32)
        nnz = lib.text_ngram_hash_tf(
            concat, offsets.ctypes.data_as(P(ctypes.c_int64)), n, min_order,
            max_order, num_features, int(binarize),
            row_ptr.ctypes.data_as(P(ctypes.c_int64)),
            cols.ctypes.data_as(P(ctypes.c_int32)),
            vals.ctypes.data_as(P(ctypes.c_float)), cap,
            num_threads or len(os.sched_getaffinity(0)),
        )
        if nnz >= 0:
            return row_ptr, cols[:nnz], vals[:nnz]
        cap = int(row_ptr[n])  # the exact need, written before the -1
    return None
