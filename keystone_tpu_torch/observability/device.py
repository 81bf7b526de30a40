"""Device truth: what the card is and what it peaks at (counterpart of
``keystone_tpu/observability/device.py``: ``peaks_for`` and
``device_table``).

``device_table`` reads the local CUDA devices once
(``torch.cuda.get_device_name`` and ``get_device_properties``): kind,
platform, count, peak FLOP/s and memory rate from ``PEAK_TABLE``
(overridable by ``KEYSTONE_PEAK_FLOPS`` / ``KEYSTONE_PEAK_MEMBW_GBPS``
for hardware the table does not know), and the device memory in bytes.
Without CUDA it holds one ``cpu`` row with unknown peaks, as the JAX
table does on a CPU backend. ``device_memory_stats`` and
``host_memory_stats`` are the memory probes the weighted solver's and the
auto-cache rule's budgets read.

``register_device_metrics`` exports the table as the constant-1
``keystone_device_info`` gauge, and ``DeviceMemorySampler`` publishes
each card's in-use, peak and limit bytes (``torch.cuda.mem_get_info``
and the caching allocator's peak) as
``keystone_device_memory_bytes{device, kind, stat}``; without CUDA it
publishes host RAM (``device="host"``) instead. The admin endpoint and
the gateway frontend share one sampler thread per registry
(``acquire_memory_sampler``, ``MemorySamplerHost``).

``CostCounter`` is the counterpart of the JAX module's
``compiled_cost_model``: where JAX reads a bucket program's XLA cost
analysis, the port counts the aten ops of one eager run of it (the
serving engine's warm pass) in a ``TorchDispatchMode`` — ``flops`` by
``torch.utils.flop_counter``'s formulas (mm, addmm, bmm, convolution and
the like), ``transcendentals`` one per output element of ``tanh``,
``exp``, ``log``, ``sqrt`` and the like, ``bytes_accessed`` each tensor
input read once and each output written once (views move nothing) — and
returns JAX's flat ``{flops, bytes_accessed, transcendentals}`` dict.
The memory-analysis fields (``temp_bytes`` ...) have no counterpart and
stay absent. A hand-written kernel's wrapper reports its function's work
by shape (``kernel_cost``) and pauses the counter inside, so the kernel
on the card and its plain version on the CPU count the same work. The
MFU and roofline series of ``ServingMetrics`` read the model with the
peaks above (``peaks_of``: the table's on a card, the env overrides
alone on the CPU, as the JAX table gives a CPU backend).
"""

from __future__ import annotations

import logging
import os
import re
import sys
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack

logger = logging.getLogger(__name__)

# Peak float32 throughput outside the tensor cores and peak device-memory
# rate, keyed by a case-insensitive word-bounded substring of the device
# name; unknown parts stay (None, None). The JAX table gives each part's
# bf16 dense tensor-core rate; the port computes in float32 on the CUDA
# cores with TF32 off (``_device.resolve_device``), so its MFU
# denominator is the float32 rate (NVIDIA data sheets; the H100 SXM row
# is the 67 TFLOP/s and 3.35 TB/s that PERF.md's kernel bounds use). The
# port's kernels are built for sm_90a only, so only Hopper parts are
# listed.
PEAK_TABLE: Tuple[Tuple[str, float, float], ...] = (
    # (kind substring, peak FLOP/s, peak device-memory bytes/s)
    ("h200", 67e12, 4800e9),
    ("h100", 67e12, 3350e9),
)

_ENV_PEAK_FLOPS = "KEYSTONE_PEAK_FLOPS"
_ENV_PEAK_MEMBW = "KEYSTONE_PEAK_MEMBW_GBPS"


def peaks_for(device_kind: Optional[str]) -> Tuple[Optional[float], Optional[float]]:
    """``(peak_flops, peak_membw_bytes_per_s)`` for a device kind, from
    the env overrides first, then the table; ``(None, None)`` for
    hardware neither knows (MFU/roofline series stay absent)."""
    flops = membw = None
    env_flops = os.environ.get(_ENV_PEAK_FLOPS)
    if env_flops:
        try:
            flops = float(env_flops)
        except ValueError:
            logger.warning("ignoring non-numeric %s=%r",
                           _ENV_PEAK_FLOPS, env_flops)
    env_membw = os.environ.get(_ENV_PEAK_MEMBW)
    if env_membw:
        try:
            membw = float(env_membw) * 1e9
        except ValueError:
            logger.warning("ignoring non-numeric %s=%r",
                           _ENV_PEAK_MEMBW, env_membw)
    if flops is not None and membw is not None:
        return flops, membw
    kind = (device_kind or "").lower()
    for sub, table_flops, table_membw in PEAK_TABLE:
        if re.search(rf"\b{re.escape(sub)}\b", kind):
            return (flops if flops is not None else table_flops,
                    membw if membw is not None else table_membw)
    return flops, membw


_table: Optional[List[Dict[str, Any]]] = None
_table_lock = threading.Lock()


def device_table() -> List[Dict[str, Any]]:
    """The local device set as one row per device kind (kind, platform,
    count, peak FLOP/s, peak memory rate, device memory bytes), read
    once."""
    global _table
    with _table_lock:
        if _table is None:
            rows: Dict[str, Dict[str, Any]] = {}
            if torch.cuda.is_available():
                for i in range(torch.cuda.device_count()):
                    kind = torch.cuda.get_device_name(i)
                    row = rows.get(kind)
                    if row is None:
                        flops, membw = peaks_for(kind)
                        row = rows[kind] = {
                            "kind": kind,
                            "platform": "gpu",
                            "count": 0,
                            "peak_flops": flops,
                            "peak_membw_bytes_per_s": membw,
                            "hbm_bytes_limit": torch.cuda.get_device_properties(i).total_memory,
                        }
                    row["count"] += 1
            else:
                flops, membw = peaks_for("cpu")
                rows["cpu"] = {
                    "kind": "cpu", "platform": "cpu", "count": 1,
                    "peak_flops": flops, "peak_membw_bytes_per_s": membw,
                    "hbm_bytes_limit": None,
                }
            _table = list(rows.values())
        return [dict(row) for row in _table]


def peaks_of(device: torch.device) -> Tuple[Optional[float], Optional[float]]:
    """The table's peaks for ``device``'s kind; on the CPU the env
    overrides alone (``(None, None)`` without them)."""
    if device.type != "cuda":
        return peaks_for("cpu")
    kind = torch.cuda.get_device_name(device)
    row = next(r for r in device_table() if r["kind"] == kind)
    return row["peak_flops"], row["peak_membw_bytes_per_s"]


def device_memory_stats(device: Any = None) -> Optional[Dict[str, int]]:
    """The one device-memory probe (the JAX module's
    ``device_memory_stats``), shared by the weighted solver's memory budget
    and the auto-cache rule's. On a CUDA device: ``bytes_limit`` the
    card's memory, ``bytes_in_use`` what is not free for this process's
    allocations (the used memory ``cudaMemGetInfo`` reports, less the
    caching allocator's reserved but unallocated blocks, which it hands
    out again), and
    ``peak_bytes_in_use`` the allocator's peak. ``None`` for a device
    without allocator stats (the CPU, or ``device=None`` without CUDA),
    as the JAX probe gives ``None`` on a CPU backend."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(dev)
    reusable = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return {"bytes_limit": int(total), "bytes_in_use": int(total - free - reusable),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(dev))}


def host_memory_stats() -> Optional[Dict[str, int]]:
    """Host RAM in the shape of ``device_memory_stats``: ``bytes_limit``
    MemTotal, ``bytes_in_use`` MemTotal less MemAvailable
    (``/proc/meminfo``), ``peak_bytes_in_use`` this process's largest
    resident set; ``None`` where none of them can be read."""
    stats: Dict[str, int] = {}
    try:
        with open("/proc/meminfo") as f:
            fields = {}
            for line in f:
                parts = line.split()
                if parts and parts[0].rstrip(":") in ("MemTotal", "MemAvailable"):
                    fields[parts[0].rstrip(":")] = int(parts[1]) * 1024
        if "MemTotal" in fields:
            stats["bytes_limit"] = fields["MemTotal"]
            if "MemAvailable" in fields:
                stats["bytes_in_use"] = fields["MemTotal"] - fields["MemAvailable"]
    except OSError:
        pass
    try:
        import resource

        # ru_maxrss is kilobytes on Linux but bytes on macOS
        scale = 1 if sys.platform == "darwin" else 1024
        stats["peak_bytes_in_use"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * scale
    except (ImportError, OSError):
        pass
    return stats or None


def reset_device_table() -> None:
    """Drop the cached table (tests that change what the table reads)."""
    global _table
    with _table_lock:
        _table = None


_ENV_CHIP_HBM = "KEYSTONE_CHIP_HBM_BYTES"


def chip_hbm_bytes() -> Optional[int]:
    """The per-card memory budget: ``$KEYSTONE_CHIP_HBM_BYTES`` when set,
    else the smallest ``hbm_bytes_limit`` of the table's device kinds;
    None when neither knows (the CPU)."""
    env = os.environ.get(_ENV_CHIP_HBM)
    if env:
        try:
            return int(float(env))
        except ValueError:
            logger.warning("ignoring unparseable %s=%r", _ENV_CHIP_HBM, env)
    limits = [row["hbm_bytes_limit"] for row in device_table() if row.get("hbm_bytes_limit")]
    return min(limits) if limits else None


def register_device_metrics(registry) -> None:
    """Export the detected table as the constant-1 info gauge
    ``keystone_device_info{kind, platform, count, peak_flops}``; the
    table is read once, every scrape reads the cache."""
    def cells():
        return {
            (row["kind"], row["platform"], str(row["count"]),
             str(row["peak_flops"] or "unknown")): 1.0
            for row in device_table()
        }

    registry.gauge_func(
        "keystone_device_info",
        cells,
        "constant 1 labeled with the detected device kind/count/peaks",
        ("kind", "platform", "count", "peak_flops"),
    )


# -- the per-bucket cost model ------------------------------------------------

# aten ops (in-place forms included) whose every output element is one
# transcendental, as XLA's cost analysis counts them
_TRANSCENDENTAL = frozenset((
    "tanh", "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "sin", "cos",
    "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh", "asinh", "acosh", "atanh",
    "sqrt", "rsqrt", "sigmoid", "erf", "erfc", "erfinv", "pow", "_softmax",
    "_log_softmax", "logsumexp", "silu", "gelu", "lgamma", "digamma",
))
# ops that read or write no element: allocations without a fill, and
# aliases (views are found by ``OpOverload.is_view``)
_NO_DATA = frozenset((
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "alias", "lift_fresh", "resize_", "set_", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset", "_local_scalar_dense", "record_stream",
))

def _active_counters() -> List["CostCounter"]:
    """The counters on this thread's dispatch-mode stack, outermost
    first."""
    return [m for m in _get_current_dispatch_mode_stack() if isinstance(m, CostCounter)]


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _matvec_flops(name: str, args) -> int:
    """mv, addmv and dot, which ``torch.utils.flop_counter`` leaves out."""
    if name in ("mv", "addmv"):
        a = args[0] if name == "mv" else args[1]
        return 2 * a.shape[0] * a.shape[1]
    if name in ("dot", "vdot"):
        return 2 * args[0].numel()
    return 0


class CostCounter(TorchDispatchMode):
    """Counts the work of the aten ops run under it on this thread (a
    ``TorchDispatchMode`` is per thread): ``model()`` is JAX's flat
    ``{flops, bytes_accessed, transcendentals}`` cost model of what ran.
    ``kernels`` holds each hand-written kernel's reported work
    (``kernel_cost``) and ``sections`` the work inside each
    ``cost_section``."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.totals = {"flops": 0.0, "bytes_accessed": 0.0, "transcendentals": 0.0}
        # kernel name -> {"flops", "bytes_accessed", "transcendentals", "calls"}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.sections: Dict[Any, Dict[str, float]] = {}
        self._open_sections: List[Any] = []
        self._paused = 0

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # the port compiles nothing, so no Dynamo frame needs skipping;
        # unwrapped, the first counted run of a process does not import
        # torch._dynamo (about 2 s)
        return False

    def add(self, flops: float = 0.0, bytes_accessed: float = 0.0,
            transcendentals: float = 0.0) -> None:
        work = {"flops": flops, "bytes_accessed": bytes_accessed,
                "transcendentals": transcendentals}
        for into in [self.totals] + [self.sections[s] for s in self._open_sections]:
            for key, v in work.items():
                into[key] += float(v)

    def model(self) -> Dict[str, float]:
        return dict(self.totals)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        packet = func._overloadpacket
        name = packet.__name__
        base = name.rstrip("_") if not name.startswith("_") else name
        if func.is_view or base in _NO_DATA:
            return out
        flops = 0
        formula = self._flop_registry.get(packet)
        if formula is not None:
            flops = formula(*args, **kwargs, out_val=out)
        else:
            flops = _matvec_flops(base, args)
        trans = sum(t.numel() for t in _tensors(out)) if base in _TRANSCENDENTAL else 0
        self.add(flops, _nbytes(args) + _nbytes(kwargs) + _nbytes(out), trans)
        return out


class kernel_cost:
    """``with kernel_cost(name, work):`` around a hand-written kernel's
    wrapper body: the counters active on this thread are paused for the
    block, so whatever implements the function (the kernel or its plain
    version) counts nothing, and when it ends ``work()`` (``(flops,
    bytes_accessed[, transcendentals])`` of the function, by shape) is
    added to each, as kernel ``name``. ``work`` runs after the body, so it
    sees what the body resolved (the operators' bands). Without a
    counter, nothing (``work`` is not called)."""

    __slots__ = ("name", "work", "counters")

    def __init__(self, name: str, work):
        self.name, self.work = name, work
        self.counters = ()

    def __enter__(self):
        self.counters = tuple(_active_counters())
        for c in self.counters:
            c._paused += 1
        return self

    def __exit__(self, *exc):
        try:
            if self.counters and exc[0] is None:
                work = tuple(self.work()) + (0.0,)
                flops, nbytes, trans = work[0], work[1], work[2]
                for c in self.counters:
                    c.add(flops, nbytes, trans)
                    k = c.kernels.setdefault(self.name, {"flops": 0.0, "bytes_accessed": 0.0,
                                                         "transcendentals": 0.0, "calls": 0})
                    k["flops"] += flops
                    k["bytes_accessed"] += nbytes
                    k["transcendentals"] += trans
                    k["calls"] += 1
        finally:
            for c in self.counters:
                c._paused -= 1
            self.counters = ()
        return False


class cost_section:
    """``with cost_section(key):``: the work counted inside also goes to
    ``sections[key]`` of every active counter (the zoo's shared prefix
    and each head). Without a counter, nothing."""

    __slots__ = ("key", "counters")

    def __init__(self, key):
        self.key = key
        self.counters = ()

    def __enter__(self):
        self.counters = tuple(_active_counters())
        for c in self.counters:
            c.sections.setdefault(self.key, {"flops": 0.0, "bytes_accessed": 0.0,
                                             "transcendentals": 0.0})
            c._open_sections.append(self.key)
        return self

    def __exit__(self, *exc):
        for c in self.counters:
            c._open_sections.remove(self.key)
        self.counters = ()
        return False


# the device_memory_stats keys the sampler exports, as their `stat` label
_SAMPLED_STATS = (
    ("bytes_in_use", "in_use"),
    ("peak_bytes_in_use", "peak"),
    ("bytes_limit", "limit"),
)


class DeviceMemorySampler:
    """Background thread publishing ``device_memory_stats`` of every card
    as ``keystone_device_memory_bytes{device, kind, stat}`` gauges.

    Without CUDA the device list is the CPU alone, which reports no
    device stats, and one host-RAM series set (``device="host"``,
    ``kind="host-ram"``) publishes instead, as the JAX sampler does on a
    CPU backend. ``sample_once()`` is the testable core; ``start()``
    samples at once, then every ``interval_s`` on a daemon thread."""

    def __init__(
        self,
        registry=None,
        interval_s: float = 10.0,
        devices: Optional[Sequence[Any]] = None,
    ):
        from keystone_tpu_torch.observability.registry import get_global_registry

        self.registry = registry if registry is not None else get_global_registry()
        self.interval_s = float(interval_s)
        self._devices = devices
        self._gauge = self.registry.gauge(
            "keystone_device_memory_bytes",
            "device allocator memory (absent on backends without "
            "stats; device=\"host\" rows are host RAM)",
            ("device", "kind", "stat"),
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _device_list(self) -> Sequence[Any]:
        if self._devices is not None:
            return self._devices
        if torch.cuda.is_available():
            return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return [torch.device("cpu")]

    def sample_once(self) -> int:
        """Publish one sample of every device; returns the number of
        device series sets written (0 = no device reported stats)."""
        published = 0
        devices = self._device_list()
        # an empty device list must stay an absent family, not pass for
        # a healthy CPU host
        all_cpu = bool(devices)
        for i, dev in enumerate(devices):
            dev = torch.device(dev)
            if dev.type != "cpu":
                all_cpu = False
            stats = device_memory_stats(dev)
            if not stats:
                continue
            published += 1
            kind = torch.cuda.get_device_name(dev)
            for key, stat in _SAMPLED_STATS:
                if key in stats:
                    self._gauge.set(float(stats[key]), (str(i), kind, stat))
        if not published and all_cpu:
            host = host_memory_stats()
            if host:
                for key, stat in _SAMPLED_STATS:
                    if key in host:
                        self._gauge.set(float(host[key]), ("host", "host-ram", stat))
        return published

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:
                logger.exception("device memory sample failed")

    def start(self) -> "DeviceMemorySampler":
        if self._thread is not None:
            return self
        self._stop.clear()  # restartable (server stop/start cycles)
        try:
            self.sample_once()
        except Exception:
            logger.exception("initial device memory sample failed")
        self._thread = threading.Thread(
            target=self._loop, name="keystone-device-memory", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


# one sampler thread per registry, shared by the admin endpoint and the
# gateway frontend of one process
_samplers_lock = threading.Lock()
_samplers: Dict[int, List] = {}  # id(registry) -> [sampler, refcount]


def acquire_memory_sampler(registry=None, interval_s: float = 10.0) -> DeviceMemorySampler:
    """Start (or share) the memory sampler of a registry. Each
    ``acquire`` pairs with one ``release_memory_sampler``; the thread
    stops when the last holder releases. A shared sampler takes the
    tightest interval asked for."""
    from keystone_tpu_torch.observability.registry import get_global_registry

    registry = registry if registry is not None else get_global_registry()
    with _samplers_lock:
        entry = _samplers.get(id(registry))
        if entry is None:
            entry = _samplers[id(registry)] = [
                DeviceMemorySampler(registry=registry, interval_s=interval_s).start(), 0,
            ]
        elif interval_s < entry[0].interval_s:
            entry[0].interval_s = float(interval_s)
        entry[1] += 1
        return entry[0]


def release_memory_sampler(sampler: DeviceMemorySampler) -> None:
    with _samplers_lock:
        entry = _samplers.get(id(sampler.registry))
        if entry is None or entry[0] is not sampler:
            sampler.stop()  # not shared (constructed directly)
            return
        entry[1] -= 1
        if entry[1] <= 0:
            del _samplers[id(sampler.registry)]
            sampler.stop()


class MemorySamplerHost:
    """Mixin for endpoint servers with a ``registry``: hold the shared
    memory sampler between ``_start_memory_sampler()`` (after the server
    comes up) and ``_stop_memory_sampler()`` (before it goes down). Both
    are idempotent."""

    _mem_sampler: Optional[DeviceMemorySampler] = None

    def _start_memory_sampler(self) -> None:
        if self._mem_sampler is None:
            self._mem_sampler = acquire_memory_sampler(registry=self.registry)

    def _stop_memory_sampler(self) -> None:
        if self._mem_sampler is not None:
            release_memory_sampler(self._mem_sampler)
            self._mem_sampler = None


__all__ = [
    "CostCounter",
    "DeviceMemorySampler",
    "MemorySamplerHost",
    "acquire_memory_sampler",
    "chip_hbm_bytes",
    "cost_section",
    "device_memory_stats",
    "device_table",
    "host_memory_stats",
    "kernel_cost",
    "peaks_for",
    "peaks_of",
    "register_device_metrics",
    "release_memory_sampler",
    "reset_device_table",
]
