"""Admin HTTP endpoint: ``/metrics``, ``/varz``, ``/healthz``,
``/tracez``, ``/slz``, ``/debugz``, ``/profilez`` (counterpart of
``keystone_tpu/observability/admin.py``).

Built on the shared scaffolding in ``observability/httpd.py`` — a
stdlib ``http.server`` on a background daemon thread, nothing to
install, nothing running unless ``AdminServer.start()`` (or the
``--admin-port`` CLI flag) is called, zero overhead when off. Routes:

- ``GET /healthz``  -> ``ok`` (liveness probe; the gateway's
  ``/readyz`` is the READINESS signal — a draining process is alive
  but not ready)
- ``GET /metrics``  -> Prometheus text exposition v0.0.4 of the global
  (or injected) ``MetricsRegistry`` (OpenMetrics with exemplars when
  the scraper asks for it)
- ``GET /varz``     -> the same registry as one JSON document, plus a
  ``build`` block (git SHA, start time/uptime, torch and CUDA versions,
  the card's name, count and memory) so two scrapes of different
  binaries are distinguishable
- ``GET /tracez``   -> recent spans from the tracer as JSON
  (``?format=chrome`` returns Chrome trace-event JSON; ``?n=100``
  bounds the span count)
- ``GET /slz``      -> every live ``SloMonitor``'s objectives with
  fast/slow-window burn rates and breach verdicts
- ``GET /debugz``   -> the flight recorders' tail-sampled forensic
  records (``?trace_id=`` filters to one request;
  ``&format=chrome`` dumps that request as a Chrome trace)
- ``GET /profilez`` -> arm a Kineto trace around the next
  ``?seconds=N`` of live traffic and list the capture directory; one
  capture at a time — concurrent requests get 409
  (``observability/profilez.py``)

Starting the endpoint also starts the device side of the plane: the
detected device table rides in ``/varz``'s build block and as the
``keystone_device_info`` gauge (read once), and the endpoint's
``DeviceMemorySampler`` publishes per-card in-use/peak/limit memory
gauges (``observability/device.py``).

``/varz``'s build block carries the AOT store's ``aot_cache`` block
(``serving/aot.status()``: ``{"dir": None}`` without a store). The JAX
endpoint's ``/attributionz`` route is not here: a zoo's gateway serves
it.

Binding defaults to localhost; ``port=0`` picks an ephemeral port
(``server.port`` reports the real one).
"""

from __future__ import annotations

import logging
import os
import platform
import threading
import time
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

from keystone_tpu_torch.observability import (
    device as device_obs,
    flight,
    profilez,
    prometheus,
    slo,
)
from keystone_tpu_torch.observability.httpd import BackgroundServer, JsonHandler
from keystone_tpu_torch.observability.registry import (
    MetricsRegistry,
    get_global_registry,
)
from keystone_tpu_torch.observability.tracing import (
    Tracer,
    get_tracer,
    tracez_document,
)

logger = logging.getLogger(__name__)

_PROCESS_START_S = time.time()
_git_sha_cache: Optional[str] = None
_git_sha_read = False


def _git_sha() -> Optional[str]:
    """Best-effort repo SHA of the running checkout (one subprocess,
    cached; None outside a git checkout or without git)."""
    global _git_sha_cache, _git_sha_read
    if _git_sha_read:
        return _git_sha_cache
    _git_sha_read = True
    try:
        import subprocess

        out = subprocess.run(
            ["git", "-C", os.path.dirname(os.path.abspath(__file__)),
             "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=5,
        )
        if out.returncode == 0:
            _git_sha_cache = out.stdout.strip() or None
    except Exception:
        _git_sha_cache = None
    return _git_sha_cache


_build_static: Optional[Dict] = None
_build_static_lock = threading.Lock()


def _static_build_info() -> Dict:
    """The immutable part of the identity, computed ONCE: every
    ``/metrics`` scrape and ``/varz`` hit reads ``build_info``."""
    global _build_static
    with _build_static_lock:
        if _build_static is None:
            import torch

            info: Dict = {
                "git_sha": _git_sha(),
                "start_time_unix_s": _PROCESS_START_S,
                "pid": os.getpid(),
                "python_version": platform.python_version(),
                "torch_version": torch.__version__,
                "cuda_version": torch.version.cuda,
                "device_kind": None,
            }
            if torch.cuda.is_available():
                props = torch.cuda.get_device_properties(0)
                info["device_kind"] = props.name
                info["device_count"] = torch.cuda.device_count()
                info["device_memory_bytes"] = props.total_memory
            _build_static = info
        return dict(_build_static)


def build_info() -> Dict:
    """Who/what this process is: enough identity that two ``/varz``
    scrapes of different binaries are distinguishable — plus the
    detected device table (kind, count, peaks, memory; read once like
    the rest of the block)."""
    info = _static_build_info()
    info["uptime_s"] = round(time.time() - _PROCESS_START_S, 3)
    info["devices"] = device_obs.device_table()
    try:
        # late import: observability must not import serving at module
        # load (serving imports observability)
        from keystone_tpu_torch.serving import aot

        info["aot_cache"] = aot.status()
    except Exception:
        pass
    return info


def register_build_metrics(registry: MetricsRegistry) -> None:
    """Export identity onto the scrape surface: the standard
    ``_info``-style constant gauge plus process start time."""
    def info_cells():
        info = build_info()
        key = (
            str(info.get("git_sha") or "unknown"),
            str(info.get("torch_version") or "unknown"),
            str(info.get("cuda_version") or "none"),
            str(info.get("device_kind") or "unknown"),
        )
        return {key: 1.0}

    registry.gauge_func(
        "keystone_build_info",
        info_cells,
        "constant 1 labeled with the build/runtime identity",
        ("git_sha", "torch_version", "cuda_version", "device_kind"),
    )
    registry.gauge_func(
        "keystone_process_start_time_seconds",
        lambda: _PROCESS_START_S,
        "process start time, unix epoch seconds",
    )
    device_obs.register_device_metrics(registry)


class _Handler(JsonHandler):
    # routing state injected per-server via the `server` attribute
    def do_GET(self) -> None:  # noqa: N802 (stdlib handler API)
        url = urlparse(self.path)
        registry: MetricsRegistry = self.server.registry  # type: ignore
        tracer: Tracer = self.server.tracer  # type: ignore
        try:
            if url.path == "/healthz":
                self._send_text(200, "ok\n")
            elif url.path == "/metrics":
                body, ctype = prometheus.negotiate_render(
                    registry.collect(), self.headers.get("Accept")
                )
                self._send(200, body.encode("utf-8"), ctype)
            elif url.path == "/varz":
                doc = registry.varz()
                doc["build"] = build_info()
                self._send_json(doc, indent=1)
            elif url.path == "/tracez":
                q = parse_qs(url.query)
                self._send_json(
                    tracez_document(
                        tracer,
                        q.get("format", [""])[0],
                        q["n"][0] if "n" in q else None,
                    ),
                    indent=1,
                )
            elif url.path == "/slz":
                self._send_json(slo.slz_status(), indent=1)
            elif url.path == "/debugz":
                q = parse_qs(url.query)
                code, doc = flight.debugz_document(
                    q.get("trace_id", [None])[0],
                    q.get("format", [""])[0],
                )
                self._send_json(doc, code=code, indent=1)
            elif url.path == "/profilez":
                q = parse_qs(url.query)
                code, doc = profilez.profilez_document(
                    q.get("seconds", [None])[0]
                )
                self._send_json(doc, code=code, indent=1)
            else:
                self._send_text(
                    404,
                    "not found; try /metrics /varz /healthz /tracez "
                    "/slz /debugz /profilez\n",
                )
        except Exception as e:  # a broken collector must not kill the
            # serving thread — report it to the scraper instead
            logger.exception("admin endpoint error for %s", self.path)
            self._send_text(500, f"error: {e}\n")


class AdminServer(BackgroundServer, device_obs.MemorySamplerHost):
    """The background admin endpoint. ``start()`` binds and serves on a
    daemon thread; ``stop()`` shuts down cleanly. Usable as a context
    manager."""

    handler_cls = _Handler
    thread_name = "keystone-admin-http"

    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        registry: Optional[MetricsRegistry] = None,
        tracer: Optional[Tracer] = None,
    ):
        super().__init__(port=port, host=host)
        self.registry = registry if registry is not None else get_global_registry()
        self.tracer = tracer if tracer is not None else get_tracer()
        register_build_metrics(self.registry)

    def _configure(self, httpd) -> None:
        httpd.registry = self.registry
        httpd.tracer = self.tracer

    def start(self) -> "AdminServer":
        # device memory telemetry rides with the endpoint: the sampler
        # publishes per-device in-use/peak/limit gauges onto the same
        # registry this endpoint scrapes (refcounted — a gateway in the
        # same process shares the thread, not a second one)
        super().start()
        self._start_memory_sampler()
        return self

    def stop(self) -> None:
        self._stop_memory_sampler()
        super().stop()


_server: Optional[AdminServer] = None
_server_lock = threading.Lock()


def start_admin_server(
    port: int = 0, host: str = "127.0.0.1", **kwargs
) -> AdminServer:
    """Start (or return) the process-global admin endpoint — what the
    ``--admin-port`` CLI flag calls."""
    global _server
    with _server_lock:
        if _server is None:
            _server = AdminServer(port=port, host=host, **kwargs).start()
        return _server


def stop_admin_server() -> None:
    global _server
    with _server_lock:
        if _server is not None:
            _server.stop()
            _server = None
