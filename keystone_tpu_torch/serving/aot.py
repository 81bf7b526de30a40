"""The AOT store: what a serving engine's start can take from disk
(counterpart of ``keystone_tpu/serving/aot.py``).

The JAX store serializes each bucket's compiled XLA executable. A CUDA
graph cannot be serialized, so the port's store keeps what a start
builds before its captures, in two parts:

- **kernel libraries** — each CUDA source under ``csrc/`` built by
  ``nvcc`` into ``_cuda.BUILD_DIR``, keyed by the digest of its source
  and headers, the ``nvcc`` build and its flags. ``install_libraries``
  copies what the store has into a build directory that lacks it, so a
  host with the store skips ``nvcc``; a library that fails to load is
  removed, counted as an error, and rebuilt by ``nvcc`` at first use.
- **bucket entries** — one per bucket of an engine: the operators its
  chain prepares for the bucket's input shape (the SIFT and LCS
  sampling matrices and their int32 ``operator_bands``, CPU copies in
  their dtype and layout) and the bucket's output on a probe batch
  derived from the warm-up example's spec. On a hit the engine puts
  the operators back on the card, runs its warm pass and captures the
  bucket's graph, then replays the probe batch: the output must equal
  the stored one bit for bit, or the load counts as an error and the
  engine drops the graph and the installed operators and builds the
  bucket cold.

Entries are keyed by a **fingerprint** of everything that could make
a stored entry wrong to reuse (``bucket_key``): the per-example input
spec, the engine's bucket list and the bucket, the donation and
sharding settings, the model's ``pipeline_token`` (the fused
featurize chain's as ``featurize_token``; two models of one shape
never share an entry), the ``sharding_token`` of a sharded engine, the
zoo namespace, and ``runtime_identity``: torch, the CUDA runtime and
``nvcc`` builds, the device's name, compute capability and count, and
the digest of every kernel source (a kernel edit misses).

The contract is JAX's **absent-not-broken**: a miss, a fingerprint
mismatch, a corrupt entry or a probe that disagrees is counted, never
raised, on the serving path, and the engine builds and captures cold
on the same device with the same kernels:

- ``keystone_aot_cache_hits_total`` / ``_misses_total`` /
  ``_errors_total`` counters and the ``keystone_aot_cache_load_seconds``
  histogram (load, install, warm pass, capture and probe of a hit);
- an ``aot_cache`` block in the admin endpoint's ``/varz``.

The directory resolves from the argument of ``setup_aot_cache``, then
``$KEYSTONE_AOT_CACHE``, then ``~/.cache/keystone_tpu_torch/aot`` (the
JAX package's store lives elsewhere); ``serve-aot-build`` fills it at
build time. Entries are read with ``torch.load(weights_only=True)``:
tensors and plain containers, no code.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import json
import logging
import os
import tempfile
import threading
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from keystone_tpu_torch import _cuda
from keystone_tpu_torch.serving.featurize import _hash_update, pipeline_token  # noqa: F401

logger = logging.getLogger(__name__)

# bump to invalidate every existing store entry on a format change
STORE_FORMAT = "keystone-torch-aot-v1"

ENTRY_SUFFIX = ".aotx"
LIBRARY_DIR = "lib"
LIBRARY_SUFFIX = ".aotlib"

LOAD_SECONDS_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 10.0,
)

# entry file layout: magic, 8-byte big-endian meta length, the meta as
# canonical JSON, then the payload (torch.save bytes of a bucket entry,
# or a library's bytes). The JSON preamble is checked against the
# requested fingerprint before the payload is read.
ENTRY_MAGIC = b"KAOT1\n"


# -- identity probes (module-level so tests can fake an upgrade) ----------

def runtime_versions() -> Dict[str, Any]:
    """The toolchain part of the fingerprint."""
    return {
        "torch": torch.__version__,
        "cuda_runtime": torch.version.cuda,
        "nvcc": _cuda.nvcc_version(),
        "kernel_sources": _cuda.sources_digest(),
    }


def device_identity(device=None) -> Dict[str, Any]:
    """The hardware part of the fingerprint: the backend, the device's
    name and compute capability, and the count of devices."""
    dev = torch.device("cuda" if device is None and torch.cuda.is_available()
                       else (device or "cpu"))
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        return {
            "backend": "cuda",
            "device_kind": props.name,
            "compute_capability": f"{props.major}.{props.minor}",
            "device_count": torch.cuda.device_count(),
        }
    return {"backend": "cpu", "device_kind": "cpu", "compute_capability": None,
            "device_count": 1}


def runtime_identity(device=None) -> Dict[str, Any]:
    """``runtime_versions() + device_identity()``: computed once per
    warmup and passed to every ``bucket_key``."""
    return {**runtime_versions(), **device_identity(device)}


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


def bucket_key(
    specs: Sequence[Tuple[Tuple[int, ...], Any]],
    buckets: Sequence[int],
    bucket: int,
    donate: bool,
    shard: bool,
    model_token: str,
    identity: Optional[Dict[str, Any]] = None,
    featurize_token: Optional[str] = None,
    sharding_token: Optional[str] = None,
    namespace: Optional[str] = None,
) -> Tuple[str, Dict[str, Any]]:
    """Fingerprint one bucket. Returns ``(key, meta)``: ``key`` is the
    entry's file stem and ``meta`` the full field dict, stored in the
    entry and checked again on load. ``featurize_token``,
    ``sharding_token`` and ``namespace`` are stamped only when set, so
    plain single-model keys do not change when they are added."""
    meta: Dict[str, Any] = {
        "format": STORE_FORMAT,
        "specs": [[list(shape), _dtype_name(dtype)] for shape, dtype in specs],
        "buckets": [int(b) for b in buckets],
        "bucket": int(bucket),
        "donate": bool(donate),
        "shard": bool(shard),
        "model_token": model_token,
        **({"featurize_token": featurize_token} if featurize_token is not None else {}),
        **({"sharding_token": sharding_token} if sharding_token is not None else {}),
        **({"namespace": namespace} if namespace is not None else {}),
        **(identity if identity is not None else runtime_identity()),
    }
    blob = json.dumps(meta, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest(), meta


def library_key(name: str) -> Tuple[str, Dict[str, Any]]:
    """Fingerprint one kernel library: its source digest (source and
    headers), the ``nvcc`` build and the flags."""
    meta = {
        "format": STORE_FORMAT,
        "library": name,
        "source_digest": _cuda.source_digest(name),
        "nvcc": _cuda.nvcc_version(),
        "flags": list(_cuda.NVCC_FLAGS),
    }
    blob = json.dumps(meta, sort_keys=True).encode()
    return f"{name}-{hashlib.sha256(blob).hexdigest()[:24]}", meta


def _split_entry(data: bytes) -> Tuple[Dict[str, Any], bytes]:
    """Entry bytes -> (meta from the JSON preamble, payload bytes).
    Raises on anything malformed, before the payload is read."""
    if not data.startswith(ENTRY_MAGIC):
        raise ValueError("not an AOT store entry (bad magic)")
    off = len(ENTRY_MAGIC)
    n = int.from_bytes(data[off:off + 8], "big")
    meta_end = off + 8 + n
    if n <= 0 or meta_end > len(data):
        raise ValueError("truncated AOT store entry")
    return json.loads(data[off + 8:meta_end]), data[meta_end:]


def _pack(meta: Dict[str, Any], payload: bytes) -> bytes:
    meta_blob = json.dumps(meta, sort_keys=True).encode()
    return ENTRY_MAGIC + len(meta_blob).to_bytes(8, "big") + meta_blob + payload


def _write_atomic(directory: str, path: str, blob: bytes, suffix: str) -> None:
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-", suffix=suffix)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class AotStore:
    """On-disk store of bucket entries and kernel libraries.

    ``save``/``load`` never raise on the serving path: every failure is
    counted (``errors``) and reported as "no entry", so the caller
    builds cold. Entries are written atomically (a temporary file and a
    rename). The directory is created 0700; a kernel library from the
    store is code the server loads, so only build steps trusted as much
    as the server may write there."""

    STALE_TMP_S = 3600.0

    def __init__(self, root: str, registry=None, namespace: Optional[str] = None):
        self.root = os.path.abspath(root)
        # the model-zoo partition: folded into every bucket_key of the
        # engines on this store; None keeps single-model keys stable
        self.namespace = namespace
        os.makedirs(self.root, mode=0o700, exist_ok=True)
        self._sweep_stale_tmp()
        self.hits = 0  # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock
        self.errors = 0  # guarded-by: _lock
        self.saves = 0  # guarded-by: _lock
        # kernel libraries: copied in from the store, and saved to it
        self.library_loads = 0  # guarded-by: _lock
        self.library_saves = 0  # guarded-by: _lock
        self._lock = threading.Lock()
        from keystone_tpu_torch.observability.registry import get_global_registry

        reg = registry if registry is not None else get_global_registry()
        self._hits_c = reg.counter(
            "keystone_aot_cache_hits_total",
            "AOT store: buckets installed from an entry whose probe "
            "output matched bit for bit",
        )
        self._misses_c = reg.counter(
            "keystone_aot_cache_misses_total",
            "AOT store: lookups that found no entry (built cold)",
        )
        self._errors_c = reg.counter(
            "keystone_aot_cache_errors_total",
            "AOT store: corrupt, mismatched or disagreeing entries, "
            "libraries that failed to load, and failed saves (built cold)",
        )
        self._load_h = reg.histogram(
            "keystone_aot_cache_load_seconds",
            "wall seconds to load, install, capture and check one stored "
            "bucket (hits only)",
            buckets=LOAD_SECONDS_BUCKETS,
        )
        self._bytes_g = reg.gauge(
            "keystone_aot_store_bytes",
            "on-disk bytes of AOT store entries, per model-zoo namespace "
            "('default' for single-model stores)",
            ("namespace",),
        )
        self._publish_bytes()

    # -- layout --------------------------------------------------------------

    def path_for(self, key: str) -> str:
        return os.path.join(self.root, key + ENTRY_SUFFIX)

    def library_path_for(self, key: str) -> str:
        return os.path.join(self.root, LIBRARY_DIR, key + LIBRARY_SUFFIX)

    def entries(self) -> list:
        try:
            return sorted(
                f[: -len(ENTRY_SUFFIX)]
                for f in os.listdir(self.root)
                if f.endswith(ENTRY_SUFFIX) and not f.startswith(".")
            )
        except OSError:
            return []

    def library_entries(self) -> list:
        try:
            return sorted(
                f[: -len(LIBRARY_SUFFIX)]
                for f in os.listdir(os.path.join(self.root, LIBRARY_DIR))
                if f.endswith(LIBRARY_SUFFIX) and not f.startswith(".")
            )
        except OSError:
            return []

    def _sweep_stale_tmp(self) -> None:
        """Remove crashed writers' ``.tmp-*`` leftovers older than
        ``STALE_TMP_S`` (a concurrent save must survive)."""
        now = time.time()
        for d in (self.root, os.path.join(self.root, LIBRARY_DIR)):
            try:
                names = os.listdir(d)
            except OSError:
                continue
            for f in names:
                if not f.startswith(".tmp-"):
                    continue
                path = os.path.join(d, f)
                try:
                    if now - os.path.getmtime(path) > self.STALE_TMP_S:
                        os.unlink(path)
                except OSError:
                    pass

    # -- accounting ------------------------------------------------------------

    def _count(self, which: str) -> None:
        with self._lock:
            setattr(self, which, getattr(self, which) + 1)
        counter = {
            "hits": self._hits_c, "misses": self._misses_c, "errors": self._errors_c,
        }.get(which)
        if counter is not None:
            counter.inc()

    def record_error(self) -> None:
        """An entry that loaded but whose probe disagreed (or a pipeline
        that could not be fingerprinted), charged by the engine."""
        self._count("errors")

    def record_hit(self, seconds: Optional[float] = None) -> None:
        """One bucket installed and its probe output equal; counted by
        the engine after the check, with the wall seconds of the whole
        install."""
        self._count("hits")
        if seconds is not None:
            self._load_h.observe(seconds)

    # -- bucket entries ----------------------------------------------------------

    def save(self, key: str, payload: Dict[str, Any], meta: Dict[str, Any]) -> Optional[str]:
        """Write one bucket entry (``payload``: tensors and plain
        containers; ``load`` maps them to the CPU). Best-effort: a
        failure is logged, counted and returns None."""
        path = self.path_for(key)
        try:
            buf = io.BytesIO()
            torch.save(payload, buf)
            blob = _pack(meta, buf.getvalue())
            _write_atomic(self.root, path, blob, ENTRY_SUFFIX)
        except Exception:
            self._count("errors")
            logger.info("aot store: could not save bucket entry to %s", path, exc_info=True)
            return None
        with self._lock:
            self.saves += 1
        self._publish_bytes()
        logger.info("aot store: saved bucket %s (%d bytes) to %s",
                    meta.get("bucket"), len(blob), path)
        return path

    def load(self, key: str, meta: Dict[str, Any]) -> Tuple[Any, str]:
        """The payload of the entry under ``key`` (tensors on the CPU):
        ``(payload, "hit")``, ``(None, "miss")`` when absent, ``(None,
        "error")`` when corrupt or when its stored meta disagrees with
        ``meta`` (checked before the payload is read). The hit counter
        waits for the engine's probe (``record_hit``). Never raises."""
        path = self.path_for(key)
        if not os.path.exists(path):
            self._count("misses")
            return None, "miss"
        try:
            with open(path, "rb") as f:
                data = f.read()
            stored_meta, body = _split_entry(data)
            if stored_meta != meta:
                raise ValueError("stored meta disagrees with the requested fingerprint")
            payload = torch.load(io.BytesIO(body), map_location="cpu", weights_only=True)
            if not isinstance(payload, dict) or "output" not in payload:
                raise ValueError("entry payload lacks the probe output")
        except Exception:
            self._count("errors")
            logger.info("aot store: entry %s unusable; building cold", path, exc_info=True)
            return None, "error"
        return payload, "hit"

    def read_meta(self, key: str) -> Optional[Dict[str, Any]]:
        """The stored meta of one entry (the JSON preamble only), or
        None when absent or corrupt."""
        try:
            with open(self.path_for(key), "rb") as f:
                return _split_entry(f.read())[0]
        except Exception:
            return None

    # -- kernel libraries ----------------------------------------------------------

    def save_library(self, name: str, path: str) -> Optional[str]:
        """Keep the built library ``name`` at ``path``, unless the store
        has it. Best-effort, like ``save``."""
        key, meta = library_key(name)
        dest = self.library_path_for(key)
        if os.path.exists(dest):
            return dest
        try:
            os.makedirs(os.path.dirname(dest), mode=0o700, exist_ok=True)
            with open(path, "rb") as f:
                blob = _pack(meta, f.read())
            _write_atomic(os.path.dirname(dest), dest, blob, LIBRARY_SUFFIX)
        except Exception:
            self._count("errors")
            logger.info("aot store: could not save library %s", name, exc_info=True)
            return None
        with self._lock:
            self.library_saves += 1
        return dest

    def load_library(self, name: str, dest: str) -> str:
        """Put the stored library ``name`` at ``dest`` and load it once:
        ``"loaded"``, ``"miss"`` (not in the store), or ``"error"`` (a
        corrupt entry, or a library that does not load: removed from
        ``dest`` and counted, so that ``nvcc`` builds it at first use).
        Never raises."""
        key, meta = library_key(name)
        src = self.library_path_for(key)
        if not os.path.exists(src):
            return "miss"
        try:
            with open(src, "rb") as f:
                stored_meta, body = _split_entry(f.read())
            if stored_meta != meta:
                raise ValueError("stored library meta disagrees")
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            _write_atomic(os.path.dirname(dest), dest, body, ".so")
            ctypes.CDLL(dest)
        except Exception:
            self._count("errors")
            logger.info("aot store: library %s unusable; nvcc rebuilds it", name,
                        exc_info=True)
            try:
                os.unlink(dest)
            except OSError:
                pass
            return "error"
        with self._lock:
            self.library_loads += 1
        return "loaded"

    # -- namespace accounting and GC ---------------------------------------------

    def _owned_entries(self) -> list:
        """``(key, bytes, mtime)`` of this namespace's bucket entries,
        oldest first; unreadable entries are claimed by every namespace."""
        owned = []
        for key in self.entries():
            meta = self.read_meta(key)
            if meta is not None and meta.get("namespace") != self.namespace:
                continue
            try:
                st = os.stat(self.path_for(key))
            except OSError:
                continue
            owned.append((key, int(st.st_size), st.st_mtime))
        owned.sort(key=lambda e: (e[2], e[0]))
        return owned

    def namespace_bytes(self) -> int:
        """On-disk bytes of this namespace's bucket entries."""
        return sum(size for _, size, _ in self._owned_entries())

    def _publish_bytes(self) -> None:
        try:
            self._bytes_g.set(float(self.namespace_bytes()), (self.namespace or "default",))
        except Exception:
            logger.debug("aot store: bytes gauge update failed", exc_info=True)

    def gc(self, max_bytes: int, pinned: Sequence[str] = ()) -> Dict[str, Any]:
        """Evict this namespace's least recently written entries until
        its bytes fit ``max_bytes``; ``pinned`` keys are never evicted.
        Other namespaces' entries and the kernel libraries are left
        alone. An entry that cannot be removed is counted and skipped."""
        report: Dict[str, Any] = {"namespace": self.namespace, "evicted": [],
                                  "evicted_bytes": 0}
        pinned_set = set(pinned)
        owned = self._owned_entries()
        total = sum(size for _, size, _ in owned)
        for key, size, _ in owned:
            if total <= max_bytes:
                break
            if key in pinned_set:
                continue
            try:
                os.unlink(self.path_for(key))
            except OSError:
                self._count("errors")
                continue
            total -= size
            report["evicted"].append(key)
            report["evicted_bytes"] += size
        report["kept_bytes"] = total
        report["over_budget"] = total > max_bytes
        self._publish_bytes()
        return report

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "dir": self.root,
                "namespace": self.namespace,
                "entries": len(self.entries()),
                "libraries": len(self.library_entries()),
                "hits": self.hits,
                "misses": self.misses,
                "errors": self.errors,
                "saves": self.saves,
                "library_loads": self.library_loads,
                "library_saves": self.library_saves,
            }


# -- kernel libraries of this process ------------------------------------------

def install_libraries(store: AotStore) -> Dict[str, str]:
    """Before any kernel launches: each library not yet in the build
    directory is taken from the store. Returns name -> ``"local"``
    (already built), ``"loaded"``, ``"miss"`` or ``"error"``; a miss or
    an error leaves the library to ``nvcc`` at first use."""
    out = {}
    for name in _cuda.SOURCES:
        path = _cuda.library_path(name)
        out[name] = "local" if os.path.exists(path) else store.load_library(name, path)
    return out


def save_libraries(store: AotStore) -> Dict[str, bool]:
    """Keep every built library of this build directory in the store
    (those it lacks). Returns name -> saved or already there."""
    out = {}
    for name in _cuda.SOURCES:
        path = _cuda.library_path(name)
        if os.path.exists(path):
            out[name] = store.save_library(name, path) is not None
    return out


# -- the process-configured store ----------------------------------------------

_aot_dir: Optional[str] = None
_configured: Optional[AotStore] = None
_configured_lock = threading.Lock()


def setup_aot_cache(cache_dir: Optional[str] = None) -> Optional[str]:
    """Configure this process's store directory: the argument, then
    ``$KEYSTONE_AOT_CACHE``, then ``~/.cache/keystone_tpu_torch/aot``.
    Returns it, or None when it cannot be created (serving goes on
    without a store)."""
    global _aot_dir
    cache_dir = (
        cache_dir
        or os.environ.get("KEYSTONE_AOT_CACHE")
        or os.path.join(os.path.expanduser("~"), ".cache", "keystone_tpu_torch", "aot")
    )
    try:
        os.makedirs(cache_dir, mode=0o700, exist_ok=True)
    except OSError as e:
        logger.info("AOT store unavailable: %s", e)
        return None
    _aot_dir = os.path.abspath(cache_dir)
    logger.info("AOT store at %s", _aot_dir)
    return _aot_dir


def aot_cache_dir() -> Optional[str]:
    """The configured store directory (None until ``setup_aot_cache``)."""
    return _aot_dir


def configured_store() -> Optional[AotStore]:
    """The store at the configured directory, or None when none was
    configured (engines then skip the store; the library and test
    default)."""
    global _configured
    root = aot_cache_dir()
    if root is None:
        return None
    with _configured_lock:
        if _configured is None or _configured.root != os.path.abspath(root):
            try:
                _configured = AotStore(root)
            except Exception:
                logger.info("aot store at %s unavailable; serving without it", root,
                            exc_info=True)
                return None
        return _configured


def namespaced_store(namespace: str) -> Optional[AotStore]:
    """A model-zoo (or model-version) view of the configured directory:
    entries keyed and GC'd under ``namespace``. None when no directory
    is configured."""
    root = aot_cache_dir()
    if root is None:
        return None
    try:
        return AotStore(root, namespace=str(namespace))
    except Exception:
        logger.info("aot store at %s unavailable for namespace %s", root, namespace,
                    exc_info=True)
        return None


def status() -> Dict[str, Any]:
    """The ``aot_cache`` block of ``/varz``'s build document."""
    store = configured_store()
    if store is None:
        return {"dir": None}
    return store.status()


# -- serve-aot-build -------------------------------------------------------------

def build_main(argv=None, device=None) -> int:
    """``python -m keystone_tpu_torch serve-aot-build`` — build every
    bucket of the ``serve-gateway`` pipeline once, on ``device``
    (``None`` means ``cuda``), and keep its entries and the kernel
    libraries in the store, so that a new host's ``serve-gateway`` with
    the same flags and ``--aot-cache`` starts from it. Exits 1 unless
    every bucket was saved, hit, or repaired (an error whose cold build
    was saved again). ``--device-featurize``/``--img`` name the
    gateway's featurize chain (flags of the port)."""
    import argparse

    from keystone_tpu_torch._device import resolve_device
    from keystone_tpu_torch.serving.bench import build_pipeline

    ap = argparse.ArgumentParser(
        prog="keystone_tpu_torch serve-aot-build",
        description="pre-populate the AOT store",
    )
    ap.add_argument("--buckets", default="8,32,128",
                    help="comma-separated row buckets (must match the "
                    "serving config that will load the store)")
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--aot-cache", default=None, metavar="DIR",
                    help="store dir (default: $KEYSTONE_AOT_CACHE, "
                    "then ~/.cache/keystone_tpu_torch/aot)")
    ap.add_argument("--device-featurize", nargs="?", const="demo",
                    choices=("demo", "flagship"), default=None, metavar="CHAIN",
                    help="as serve-gateway's: the featurize chain in front "
                    "of the model ('demo' or 'flagship')")
    ap.add_argument("--img", type=int, default=None,
                    help="raw image edge under --device-featurize")
    args = ap.parse_args(argv)
    root = setup_aot_cache(args.aot_cache)
    if root is None:
        print(json.dumps({"error": "aot cache dir unavailable"}))
        return 1
    store = configured_store()
    if store is None:
        print(json.dumps({"error": "aot store unavailable", "dir": root}))
        return 1
    dev = resolve_device(device)
    featurize = None
    d = args.d
    if args.device_featurize:
        from keystone_tpu_torch.serving.featurize import (
            build_featurize_pipeline,
            build_flagship_featurize_pipeline,
        )

        if args.device_featurize == "flagship":
            img = args.img if args.img is not None else 64
            featurize, d = build_flagship_featurize_pipeline(img=img, device=dev)
        else:
            img = args.img if args.img is not None else 16
            featurize, d = build_featurize_pipeline(img=img, device=dev)
        example = torch.zeros((img, img, 3), dtype=torch.uint8)
    else:
        example = torch.zeros((d,), dtype=torch.float32)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    fitted = build_pipeline(d=d, hidden=args.hidden, depth=args.depth, device=dev)
    engine = fitted.compiled(buckets=buckets, name="aot-build", featurize=featurize,
                             device=dev, aot_store=store)
    t0 = time.perf_counter()
    times = engine.warmup(example=example)
    report = {
        "dir": root,
        "buckets": list(engine.buckets),
        "warmup_seconds": {str(b): round(t, 3) for b, t in times.items()},
        "wall_seconds": round(time.perf_counter() - t0, 3),
        "aot": engine.aot_report(),
        **store.status(),
    }
    print(json.dumps(report), flush=True)
    ok = all(
        v.get("status") in ("saved", "hit") or v.get("fallback") == "saved"
        for v in (engine.aot_report().get(b, {}) for b in engine.buckets)
    )
    return 0 if ok else 1


__all__ = [
    "AotStore",
    "ENTRY_MAGIC",
    "STORE_FORMAT",
    "aot_cache_dir",
    "bucket_key",
    "build_main",
    "configured_store",
    "device_identity",
    "install_libraries",
    "library_key",
    "namespaced_store",
    "pipeline_token",
    "runtime_identity",
    "runtime_versions",
    "save_libraries",
    "setup_aot_cache",
    "status",
]
