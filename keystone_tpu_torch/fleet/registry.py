"""Replica registry: the fleet router's membership + health + load map
(counterpart of ``keystone_tpu/fleet/registry.py``, copied as it is).

``EnginePool`` keeps N shared-nothing lanes behind one ``submit()``;
this module is the same topology one level up, where a "lane" is a
whole ``serve-gateway`` PROCESS reachable over HTTP. A ``Replica``
mirrors ``gateway/pool.py Lane``'s accounting at network distance:

- **load** — the replica's scraped queue-depth + in-flight gauges
  (or the cheaper ``X-Keystone-Load`` header its ``/readyz`` carries)
  plus the router's own in-flight count toward it, so least-loaded
  routing stays honest between probe ticks;
- **health, two-layer** — *probe liveness* (did the last background
  ``/readyz`` probe reach the process at all) AND *request health*
  (consecutive request-path failures with half-open recovery,
  mirroring ``Lane.healthy``: ``unhealthy_after`` consecutive
  failures bench the replica until ``recovery_after_s`` elapses, then
  it gets probe traffic again and ONE successful request fully
  restores it). The layers are deliberately separate: a replica whose
  ``/readyz`` answers but whose ``/predict`` responses are being
  black-holed (``router.replica.blackhole``, a return-path partition)
  must stay benched on request evidence — a passing probe may not
  overrule failing traffic;
- **readiness** — the replica's own routing signal (``/readyz`` 200
  vs 503-draining), carried verbatim including the burn-state body so
  ``/fleetz`` shows WHY a replica is backing traffic off.

``ReplicaRegistry`` owns the set (static ``--replica`` URLs plus
``POST /registerz`` self-registration, deduped by URL), the
least-loaded pick with the pool's availability-over-purity fallback,
and the background probe loop. Lock discipline: the registry lock
guards ONLY the membership dict — probes run on their own daemon
thread and every HTTP call happens outside any lock (the
blocking-under-lock rule holds at fleet scale too).
"""

from __future__ import annotations

import logging
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple
from urllib.parse import urlparse

from keystone_tpu_torch.observability import prometheus

logger = logging.getLogger(__name__)

# request-path health thresholds, mirroring gateway/pool.py Lane:
# consecutive failures that bench a replica, and how long it sits out
# before the router half-opens it again
UNHEALTHY_AFTER = 3
RECOVERY_AFTER_S = 5.0

# the load gauges a replica's scrape contributes to its routing load
_LOAD_FAMILIES = (
    "keystone_gateway_queue_depth",
    "keystone_gateway_inflight",
)


def _validate_replica_url(url: str) -> str:
    parsed = urlparse(url)
    if parsed.scheme not in ("http", "https") or not parsed.netloc:
        raise ValueError(
            f"replica url must be http(s)://host:port, got {url!r}"
        )
    return url.rstrip("/")


class Replica:
    """One gateway process behind the router (see module docstring)."""

    def __init__(
        self,
        url: str,
        index: int,
        source: str = "static",
        unhealthy_after: int = UNHEALTHY_AFTER,
        recovery_after_s: float = RECOVERY_AFTER_S,
    ):
        self.url = _validate_replica_url(url)
        self.name = urlparse(self.url).netloc
        self.index = index
        self.source = source
        self.unhealthy_after = int(unhealthy_after)
        self.recovery_after_s = float(recovery_after_s)
        self.registered_t = time.time()
        self._lock = threading.Lock()
        # request-path health (mirrors Lane; ONLY the request path
        # writes these — a passing probe must not overrule failing
        # traffic, see module docstring)
        self._consecutive_failures = 0  # guarded-by: _lock
        self._last_failure_t = 0.0  # guarded-by: _lock
        self._last_failure_detail = None  # guarded-by: _lock
        # probe liveness + readiness (the background probe writes these)
        self._probe_alive = True  # guarded-by: _lock
        self._ready = False  # guarded-by: _lock
        self._ready_detail = "never probed"  # guarded-by: _lock
        self._last_probe_t = None  # guarded-by: _lock
        # routing load: replica-reported + router-local in-flight
        self._scraped_load = 0.0  # guarded-by: _lock
        self._inflight = 0  # guarded-by: _lock
        # federation inputs cached from the last probe scrape
        self._last_scrape = None  # guarded-by: _lock
        self._build: Dict[str, str] = {}  # guarded-by: _lock
        # zoo model ids this replica advertises (registration +
        # heartbeat refreshes); empty = pre-zoo replica, which only
        # receives bare-/predict traffic
        self._models: frozenset = frozenset()  # guarded-by: _lock

    # -- routing signals ----------------------------------------------------

    @property
    def healthy(self) -> bool:
        with self._lock:
            if not self._probe_alive:
                return False
            if self._consecutive_failures < self.unhealthy_after:
                return True
            # half-open: after the cool-down the replica gets probe
            # traffic again; one request success fully restores it
            return (
                time.perf_counter() - self._last_failure_t
                > self.recovery_after_s
            )

    @property
    def state(self) -> str:
        """``/fleetz``'s one-word verdict: ``unreachable`` (probe
        can't reach the process), ``unhealthy`` (benched on request
        failures), ``half-open`` (cool-down elapsed, next request is
        the probe), or ``healthy``."""
        with self._lock:
            if not self._probe_alive:
                return "unreachable"
            if self._consecutive_failures < self.unhealthy_after:
                return "healthy"
            if (
                time.perf_counter() - self._last_failure_t
                > self.recovery_after_s
            ):
                return "half-open"
            return "unhealthy"

    @property
    def ready(self) -> bool:
        with self._lock:
            return self._ready

    @property
    def load(self) -> float:
        """Routing load: the replica's last-reported queue depth +
        in-flight, plus requests THIS router currently has open
        against it (covers the gap between probe ticks)."""
        with self._lock:
            return self._scraped_load + self._inflight

    @property
    def cached_scrape(self) -> Optional[str]:
        with self._lock:
            return self._last_scrape

    @property
    def models(self) -> frozenset:
        with self._lock:
            return self._models

    def set_models(self, models) -> None:
        with self._lock:
            self._models = frozenset(str(m) for m in models)

    def advertises(self, model: str) -> bool:
        with self._lock:
            return model in self._models

    # -- request-path accounting (the router's forward path) ----------------

    def begin_request(self) -> None:
        with self._lock:
            self._inflight += 1

    def end_request(self) -> None:
        with self._lock:
            self._inflight = max(0, self._inflight - 1)

    def mark_ok(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._last_failure_detail = None

    def mark_failed(self, detail: Optional[str] = None) -> None:
        with self._lock:
            self._consecutive_failures += 1
            self._last_failure_t = time.perf_counter()
            if detail is not None:
                self._last_failure_detail = detail

    # -- probe results (the registry's probe thread) ------------------------

    def record_probe(
        self,
        alive: bool,
        ready: bool = False,
        detail: str = "",
        load: Optional[float] = None,
        scrape: Optional[str] = None,
        build: Optional[Dict[str, str]] = None,
    ) -> None:
        with self._lock:
            self._probe_alive = alive
            self._ready = ready
            self._ready_detail = detail
            self._last_probe_t = time.time()
            if load is not None:
                self._scraped_load = float(load)
            if scrape is not None:
                self._last_scrape = scrape
            if build:
                self._build = dict(build)

    def record_scrape(self, scrape: str) -> None:
        """Refresh only the cached federation input (an on-demand
        ``/metrics`` pull must not overwrite the probe's readiness
        verdict or its burn-state detail)."""
        with self._lock:
            self._last_scrape = scrape

    # -- introspection ------------------------------------------------------

    def status(self) -> Dict:
        """One ``/fleetz`` roster row."""
        with self._lock:
            consecutive = self._consecutive_failures
            row = {
                "url": self.url,
                "name": self.name,
                "index": self.index,
                "source": self.source,
                "ready": self._ready,
                "ready_detail": self._ready_detail,
                "load": self._scraped_load + self._inflight,
                "router_inflight": self._inflight,
                "consecutive_failures": consecutive,
                "last_failure": self._last_failure_detail,
                "last_probe_age_s": (
                    round(time.time() - self._last_probe_t, 2)
                    if self._last_probe_t is not None
                    else None
                ),
                "build": dict(self._build),
                "models": sorted(self._models),
            }
        # state/healthy re-take the lock; cheap, and keeps one
        # source of truth for the half-open arithmetic
        row["state"] = self.state
        row["healthy"] = self.healthy
        return row


class ReplicaRegistry:
    """The router's replica set + background health probes."""

    def __init__(
        self,
        urls: Sequence[str] = (),
        *,
        probe_interval_s: float = 2.0,
        probe_timeout_s: float = 5.0,
        unhealthy_after: int = UNHEALTHY_AFTER,
        recovery_after_s: float = RECOVERY_AFTER_S,
        name: str = "router",
    ):
        if probe_interval_s <= 0:
            raise ValueError(
                f"probe_interval_s must be > 0, got {probe_interval_s}"
            )
        self.name = name
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.unhealthy_after = int(unhealthy_after)
        self.recovery_after_s = float(recovery_after_s)
        self._lock = threading.Lock()
        self._replicas: Dict[str, Replica] = {}  # guarded-by: _lock
        self._next_index = 0  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        for url in urls:
            self.add(url, source="static")

    # -- membership ---------------------------------------------------------

    def add(
        self, url: str, source: str = "registered", models=None
    ) -> Tuple[Replica, bool]:
        """Add one replica (idempotent by URL). Returns ``(replica,
        created)`` — a re-registration of a known URL is a heartbeat,
        not a new member (but it DOES refresh the advertised model
        set: a replica whose zoo spec changed re-registers with the
        new ids)."""
        url = _validate_replica_url(url)
        with self._lock:
            existing = self._replicas.get(url)
            if existing is not None:
                if models is not None:
                    existing.set_models(models)
                return existing, False
            replica = Replica(
                url,
                index=self._next_index,
                source=source,
                unhealthy_after=self.unhealthy_after,
                recovery_after_s=self.recovery_after_s,
            )
            self._next_index += 1
            self._replicas[url] = replica
        if models:
            replica.set_models(models)
        logger.info(
            "fleet %s: replica %s added (%s, index %d)",
            self.name, replica.name, source, replica.index,
        )
        return replica, True

    def remove(self, url: str) -> bool:
        """Drop one replica from the roster (idempotent by URL) — the
        ``POST /deregisterz`` half of graceful retirement: once
        removed, ``pick()`` can never hand the replica new forwards,
        so it can drain its in-flight work and exit without lingering
        in the roster until probes fail it. Returns whether the URL
        was a member."""
        url = _validate_replica_url(url)
        with self._lock:
            replica = self._replicas.pop(url, None)
        if replica is not None:
            logger.info(
                "fleet %s: replica %s deregistered (index %d)",
                self.name, replica.name, replica.index,
            )
        return replica is not None

    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas.values())

    def find_by_name(self, name: str) -> Optional[Replica]:
        """Replica by roster name (``host:port``) — how the trace
        stitcher resolves a ``router.forward`` span's ``replica`` attr
        back to a URL it is allowed to dial (the registry is the
        authority on fleet membership, not span attrs)."""
        with self._lock:
            for replica in self._replicas.values():
                if replica.name == name:
                    return replica
        return None

    def __len__(self) -> int:
        with self._lock:
            return len(self._replicas)

    # -- routing ------------------------------------------------------------

    def pick(
        self,
        exclude: Sequence[Replica] = (),
        model: Optional[str] = None,
    ) -> Optional[Replica]:
        """The least-loaded ready+healthy replica outside ``exclude``
        — with the pool's availability-over-purity fallbacks: a
        healthy-but-draining replica beats nothing, and an unhealthy
        replica beats shedding when it is all that's left (which is
        also how a half-open replica earns its probe traffic).
        ``model`` restricts every tier to replicas ADVERTISING that
        zoo model id — the fallbacks relax health, never routing a
        model to a replica that doesn't serve it (None here means
        'no replica for model', the router's typed 503)."""
        # ONE membership snapshot for all three tiers: the hot path
        # takes the registry lock once, and the fallbacks filter the
        # same roster the first tier saw
        available = [r for r in self.replicas() if r not in exclude]
        if model is not None:
            available = [r for r in available if r.advertises(model)]
        candidates = [r for r in available if r.healthy and r.ready]
        if not candidates:
            candidates = [r for r in available if r.healthy]
        if not candidates:
            candidates = available
        if not candidates:
            return None
        return min(candidates, key=lambda r: r.load)

    # -- probes (own daemon thread; HTTP strictly outside the lock) ---------

    def probe_once(self) -> None:
        """One probe sweep over a membership snapshot: ``/readyz``
        (liveness + readiness + burn-state body + the
        ``X-Keystone-Load`` header) and a ``/metrics`` scrape (load
        fallback, build info, the cached federation input). Replicas
        are probed CONCURRENTLY — a serial sweep would stretch the
        probe period by the sum of per-replica timeouts the moment
        one host answers slowly, delaying unreachable-detection for
        whoever happens to be probed last."""
        self._fan_out(self._probe, self.replicas())

    @staticmethod
    def _fan_out(fn, replicas: Sequence[Replica]) -> None:
        if not replicas:
            return
        if len(replicas) == 1:
            fn(replicas[0])
            return
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(
            max_workers=min(8, len(replicas)),
            thread_name_prefix="keystone-fleet-probe",
        ) as pool:
            for _ in pool.map(fn, replicas):
                pass

    def _probe(self, replica: Replica) -> None:
        try:
            with urllib.request.urlopen(
                replica.url + "/readyz", timeout=self.probe_timeout_s
            ) as resp:
                ready = resp.status == 200
                detail = resp.read().decode("utf-8", "replace").strip()
                load_header = resp.headers.get("X-Keystone-Load")
        except urllib.error.HTTPError as e:
            # 503-draining: the PROCESS answered — alive, not ready
            ready = False
            detail = (e.read() or b"").decode("utf-8", "replace").strip()
            load_header = e.headers.get("X-Keystone-Load")
        except Exception as e:
            replica.record_probe(
                alive=False, ready=False,
                detail=f"probe failed: {type(e).__name__}: {e}",
            )
            return
        scrape = build = None
        scraped_load = None
        try:
            with urllib.request.urlopen(
                replica.url + "/metrics", timeout=self.probe_timeout_s
            ) as resp:
                scrape = resp.read().decode("utf-8", "replace")
            build, scraped_load = self._parse_scrape(scrape)
        except Exception:
            logger.debug(
                "fleet %s: /metrics scrape of %s failed",
                self.name, replica.name, exc_info=True,
            )
        load = None
        if load_header is not None:
            try:
                load = float(load_header)
            except ValueError:
                load = None
        if load is None:
            load = scraped_load
        replica.record_probe(
            alive=True, ready=ready, detail=detail,
            load=load, scrape=scrape, build=build,
        )

    @staticmethod
    def _parse_scrape(
        text: str,
    ) -> Tuple[Dict[str, str], Optional[float]]:
        """Build-info labels + summed load gauges from one scrape."""
        build: Dict[str, str] = {}
        load = None
        for name, labels, value in prometheus.parse_samples(text):
            if name == "keystone_build_info":
                build = dict(labels)
            elif name in _LOAD_FAMILIES:
                load = (load or 0.0) + value
        return build, load

    def start(self) -> "ReplicaRegistry":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.probe_interval_s):
                try:
                    self.probe_once()
                except Exception:
                    logger.exception(
                        "fleet %s: probe sweep failed", self.name
                    )

        self._thread = threading.Thread(
            target=loop,
            name=f"keystone-{self.name}-probes",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- federation + introspection ----------------------------------------

    def scrapes(self) -> List[str]:
        """The cached per-replica exposition bodies (last probe's) —
        the cheap federation input the SLO monitor burns against."""
        return [
            text
            for text in (r.cached_scrape for r in self.replicas())
            if text
        ]

    def fresh_scrapes(
        self, timeout_s: Optional[float] = None
    ) -> List[str]:
        """Scrape every reachable replica NOW (the router's
        ``/metrics`` path — a scrape should reflect the present, not
        the last probe tick); a replica that can't answer contributes
        its cached body instead, so one dead host degrades the
        federation to slightly-stale rather than absent. Replicas are
        scraped concurrently for the same reason probes are: the
        router's scrape latency must track the slowest replica, not
        the fleet-size-weighted sum of slow ones."""
        timeout = timeout_s if timeout_s is not None else self.probe_timeout_s

        def scrape_one(replica: Replica) -> None:
            if not replica.healthy:
                return
            try:
                with urllib.request.urlopen(
                    replica.url + "/metrics", timeout=timeout
                ) as resp:
                    text = resp.read().decode("utf-8", "replace")
                replica.record_scrape(text)
            except Exception:
                pass  # the cached body stands in below

        replicas = self.replicas()
        self._fan_out(scrape_one, replicas)
        return [
            text
            for text in (r.cached_scrape for r in replicas)
            if text
        ]

    def counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for replica in self.replicas():
            state = replica.state
            counts[state] = counts.get(state, 0) + 1
        return counts

    def roster(self) -> Dict:
        """The ``/fleetz`` replica listing."""
        rows = [r.status() for r in self.replicas()]
        return {
            "replicas": sorted(rows, key=lambda r: r["index"]),
            "counts": self.counts(),
            "probe_interval_s": self.probe_interval_s,
        }


__all__ = [
    "RECOVERY_AFTER_S",
    "Replica",
    "ReplicaRegistry",
    "UNHEALTHY_AFTER",
]
