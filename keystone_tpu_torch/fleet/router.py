"""Fleet router: the cross-host front door over N gateway replicas
(counterpart of ``keystone_tpu/fleet/router.py``, copied as it is; it is
host-only and never touches the card, so it initializes no CUDA).

``EnginePool`` lifted one level: the pool's least-loaded / health /
retry topology applied to whole ``serve-gateway`` PROCESSES instead of
in-process lanes — the failover-aware frontend shape production model
servers put in front of predictable replicas (Clockwork, OSDI '20; the
request plane below it is the Orca-style gateway of ``gateway/``). A
stdlib ``http.server`` on a daemon thread, same scaffolding as the
gateway frontend (``observability/httpd.py``). Routes:

- ``POST /predict`` — forwarded VERBATIM (raw bytes, no re-encode) to
  the least-loaded ready+healthy replica
  (``fleet/registry.py ReplicaRegistry.pick``). A transport failure,
  untyped 5xx, or black-holed response is retried ONCE on another
  replica before anything reaches the client, so a single replica
  dying mid-request is invisible; typed ``Overloaded`` responses
  (429/503/504 with the ``overloaded`` body) PROPAGATE verbatim — the
  shed/expired semantics the gateway computed survive the extra hop —
  except 503-``closed`` (a draining replica), which fails over to a
  sibling first and is surfaced only when no replica can answer. An
  untyped 5xx that REPRODUCES across the retry propagates verbatim as
  the error it is (the pool's deterministic-error doctrine — a
  500-ing fleet must look like one, not like a typed shed); only when
  no replica is reachable at all does the router shed typed itself
  (503 ``overloaded``/``closed``).
- ``POST /predict/<model>`` — the model-zoo route: forwarded with the
  PATH PRESERVED to the least-loaded replica ADVERTISING that model
  id (the ``models`` list in its registration), so the replica's own
  zoo resolves the model and its typed ``unknown_model`` 404 reaches
  the client verbatim. When NO replica advertises the id, the router
  answers a typed 503 ``{"error": "no_replica_for_model",
  "model": ...}`` — a routing fact, distinct from overload.
- ``POST /registerz`` — ``{"url": "http://host:port"}``
  self-registration (what ``serve-gateway --register`` POSTs at
  startup); idempotent per URL, so re-registration is a heartbeat —
  one that also REFRESHES the optional ``"models": [...]`` advertised
  zoo model ids (``serve-gateway --zoo --register`` sends its
  registry's ids).
- ``POST /deregisterz`` — ``{"url": "http://host:port"}`` roster
  REMOVAL (idempotent): no new forwards land on the replica from the
  moment this returns, which is the first step of graceful
  retirement — the autoscale supervisor (and a draining
  ``serve-gateway`` itself, on SIGTERM) deregisters, drains
  in-flight work, then exits, instead of lingering in the roster
  until probes fail it.
- ``GET /fleetz`` — the JSON roster: per-replica health state
  (healthy / half-open / unhealthy / unreachable), readiness + the
  burn-state body, load, build info, failure forensics.
- ``GET /metrics`` — **SLO federation**: every replica's scrape plus
  the router's own registry merged into ONE exposition
  (``prometheus.merge_expositions`` — identical-label series sum, so
  N replicas of one service export one fleet-wide family and
  ``quantile_from_buckets`` over the merged ``le`` buckets is the
  TRUE fleet p99, not a quantile of quantiles). Replicas that can't
  answer the on-demand scrape contribute their last probe's cached
  body instead.
- ``GET /attributionz`` — the FLEET-TRUTH per-model device-cost
  ledger: the federated scrape's ``keystone_attr_*{model}`` samples
  (identical model labels across replicas sum) rebuilt into the same
  document each replica serves (``observability/attribution.py``).
- ``GET /driftz`` — fleet drift: every replica's
  ``keystone_drift_score{model}`` off the federated scrape (the gauge
  MAX-merges — the worst replica's drift is the fleet's); re-plan
  recommendations stay on each replica's own ``/driftz``.
- ``GET /slz`` — burn rates of the router's fleet-wide latency SLO
  (``Slo.latency_from_buckets`` over the merged replica buckets) when
  one is declared, alongside any replica-local monitors in-process.
- ``GET /tracez`` — this process's recent spans (one ``router.forward``
  span per forward attempt; retries are sibling spans with a
  ``retry_reason`` attr), same surface as the gateway's.
- ``GET /debugz?trace_id=`` — **stitched cross-process forensics**
  (``observability/stitch.py``): the router's spans for the trace plus
  each involved replica's ``/debugz`` half grafted under the
  router-hop spans, rendered as JSON (with the
  ``router_hop/queue_wait/coalesce/device/deliver`` phase
  decomposition) or one multi-process Chrome trace
  (``format=chrome``). Partial when a replica can't contribute —
  counted, never an error.

- ``GET /readyz`` — 200 while at least one replica is ready+healthy
  (the roster state rides in the body), 503 otherwise: the router is
  a routing signal for the layer above it, same contract as the
  gateway's.
- ``GET|POST /chaosz`` — the fault-injection plane, identical to the
  gateway frontend's: the fleet-level points
  ``router.replica.blackhole`` (drop a matched replica's /predict
  responses — a return-path partition), ``router.replica.partition``
  (sever the forward BEFORE it dials — the request-path partition
  the autoscale drill fires mid-scale-up), and ``router.trace.drop``
  (strip the traceparent off a forward — the partial-stitch drill)
  are armed HERE, in the router process, and fire on the forward
  path.

Distributed tracing rides the hot path: the router mints (or adopts
an inbound) W3C ``traceparent``, sends it on every forward so the
replica's whole admit → coalesce → dispatch chain shares the trace
id, and echoes ``X-Keystone-Trace`` on every /predict response —
success AND typed shed. ``--request-log`` writes the gateway's
replayable JSONL schema plus ``replica``/``attempts`` per routed
POST. Tracing is ON by default (``--no-trace`` opts out).
"""

from __future__ import annotations

import http.client
import json
import logging
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Sequence, Tuple
from urllib.parse import parse_qs, urlparse

from keystone_tpu_torch.fleet.registry import ReplicaRegistry
from keystone_tpu_torch.loadgen import faults
from keystone_tpu_torch.observability import prometheus
from keystone_tpu_torch.observability import slo as slo_mod
from keystone_tpu_torch.observability.httpd import (
    BackgroundServer,
    JsonHandler,
    RequestLogWriter,
    next_post_seq,
)
from keystone_tpu_torch.observability.registry import get_global_registry
from keystone_tpu_torch.observability.stitch import TraceStitcher
from keystone_tpu_torch.observability.tracing import (
    TRACEPARENT_HEADER,
    TRACE_RESPONSE_HEADER,
    format_traceparent,
    get_tracer,
    new_trace_id,
    parse_traceparent,
    tracez_document,
)

logger = logging.getLogger(__name__)

# per-attempt forward bound: must EXCEED the gateway's own
# RESULT_TIMEOUT_S (60 s — a live replica always answers within it)
# while staying under the loadgen client's lost-declaration bound, so
# a slow-but-alive replica yields a typed answer, not a lost request
FORWARD_TIMEOUT_S = 70.0

# the replica latency family the fleet SLO federates over
FLEET_LATENCY_FAMILY = "keystone_gateway_request_latency_seconds"


class ReplicaUnavailable(RuntimeError):
    """One replica could not produce a response the client should see
    YET — transport failure, untyped 5xx, black-holed response, or a
    draining replica's 503-``closed``. ``charge`` says whether the
    failure is evidence against the replica's health (a drain is
    not). Two kinds of last-resort payload ride along for when NO
    sibling can answer either: ``typed`` (a draining replica's typed
    503, surfaced verbatim) and ``untyped`` (a real error response the
    replica produced — after the retry reproduces the failure it must
    PROPAGATE as the error it is, mirroring the pool's
    deterministic-error doctrine; dressing it up as a typed shed
    would hide a 500-ing fleet from the exact invariant checker built
    to catch it)."""

    def __init__(
        self,
        detail: str,
        charge: bool = True,
        typed: Optional[Tuple[int, bytes]] = None,
        untyped: Optional[Tuple[int, bytes]] = None,
    ):
        super().__init__(detail)
        self.charge = charge
        self.typed = typed
        self.untyped = untyped


class RouterMetrics:
    """The router's own (non-federated) series, merged into
    ``/metrics`` alongside the replica scrapes."""

    def __init__(self, registry=None, router: str = "router"):
        reg = registry if registry is not None else get_global_registry()
        self.registry = reg
        self.router = router
        self._requests = reg.counter(
            "keystone_router_requests_total",
            "terminal request outcomes through the fleet router",
            ("router", "status"),
        )
        self._retries = reg.counter(
            "keystone_router_retries_total",
            "requests retried on another replica after a replica "
            "failure",
            ("router",),
        )
        self._replicas = reg.gauge(
            "keystone_router_replicas",
            "replicas known to the router, by health state",
            ("router", "state"),
        )

    def record_outcome(self, status: str) -> None:
        self._requests.inc((self.router, status))

    def record_retry(self) -> None:
        self._retries.inc((self.router,))

    def set_replica_states(self, counts: Dict[str, int]) -> None:
        for state in ("healthy", "half-open", "unhealthy", "unreachable"):
            self._replicas.set(
                float(counts.get(state, 0)), (self.router, state)
            )

    def retry_count(self) -> float:
        return self._retries.get((self.router,))

    def outcome_count(self, status: str) -> float:
        return self._requests.get((self.router, status))


class _RouterHandler(JsonHandler):
    def _send(self, code, body, content_type, headers=None) -> None:
        # every /predict response — forwarded success, propagated
        # typed shed, router-minted shed — echoes the ONE fleet-wide
        # trace id; even when the replica answered under a different
        # (self-minted) id, the ROUTER's id is the one its /debugz
        # can stitch, partially or fully
        tid = getattr(self, "_trace_id", None)
        if tid:
            headers = {**(headers or {}), TRACE_RESPONSE_HEADER: tid}
        super()._send(code, body, content_type, headers=headers)

    def _send_error_json(self, code: int, error: str, **extra) -> None:
        self._send_json({"error": error, **extra}, code=code)

    @property
    def fleet(self) -> ReplicaRegistry:
        return self.server.fleet  # type: ignore[attr-defined]

    @property
    def metrics(self) -> RouterMetrics:
        return self.server.metrics  # type: ignore[attr-defined]

    def do_GET(self) -> None:  # noqa: N802 (stdlib handler API)
        url = urlparse(self.path)
        path = url.path
        self._trace_id = None  # per-request (keep-alive safety)
        try:
            if path == "/readyz":
                counts = self.fleet.counts()
                self.metrics.set_replica_states(counts)
                routable = sum(
                    1
                    for r in self.fleet.replicas()
                    if r.healthy and r.ready
                )
                body = (
                    f"{'ok' if routable else 'no replica ready'} "
                    f"({routable}/{len(self.fleet)} replicas ready; "
                    f"states {json.dumps(counts, sort_keys=True)})\n"
                )
                self._send_text(200 if routable else 503, body)
            elif path == "/healthz":
                self._send_text(200, "ok\n")
            elif path == "/fleetz":
                self._send_json(self.server.fleetz(), indent=1)  # type: ignore[attr-defined]
            elif path == "/metrics":
                body = self.server.federated_metrics()  # type: ignore[attr-defined]
                self._send(
                    200, body.encode("utf-8"), prometheus.CONTENT_TYPE
                )
            elif path == "/attributionz":
                self._send_json(
                    self.server.attributionz(), indent=1  # type: ignore[attr-defined]
                )
            elif path == "/driftz":
                self._send_json(
                    self.server.driftz(), indent=1  # type: ignore[attr-defined]
                )
            elif path == "/slz":
                self._send_json(slo_mod.slz_status(), indent=1)
            elif path == "/tracez":
                q = parse_qs(url.query)
                self._send_json(
                    tracez_document(
                        get_tracer(),
                        q.get("format", [""])[0],
                        q["n"][0] if "n" in q else None,
                    ),
                    indent=1,
                )
            elif path == "/debugz":
                # the stitched cross-process forensics: this router's
                # router.forward spans + every involved replica's
                # /debugz half, grafted into one tree with the phase
                # decomposition (observability/stitch.py)
                q = parse_qs(url.query)
                code, doc = self.server.stitcher.document(  # type: ignore[attr-defined]
                    q.get("trace_id", [None])[0],
                    q.get("format", [""])[0],
                    self.server.resolve_replica_url,  # type: ignore[attr-defined]
                )
                self._send_json(doc, code=code, indent=1)
            elif path == "/chaosz":
                if not self.server.chaos_routes:  # type: ignore[attr-defined]
                    self._send_error_json(
                        404, "chaos_routes_disabled",
                        detail="started with --no-chaosz",
                    )
                else:
                    self._send_json(
                        faults.get_injector().status(), indent=1
                    )
            else:
                self._send_text(
                    404,
                    "not found; try /predict /predict/<model> "
                    "/registerz /deregisterz /fleetz /readyz /healthz "
                    "/metrics /attributionz /driftz /slz /tracez "
                    "/debugz /chaosz\n",
                )
        except Exception as e:
            logger.exception("router GET error for %s", self.path)
            self._send_error_json(500, "internal", detail=str(e))

    def do_POST(self) -> None:  # noqa: N802 (stdlib handler API)
        path = urlparse(self.path).path
        self._trace_id = None  # _predict adopts/mints; see _send
        try:
            if path == "/predict" or path.startswith("/predict/"):
                model_id = path[len("/predict/"):] if (
                    path.startswith("/predict/")
                ) else None
                self._predict(model_id or None)
            elif path == "/registerz":
                self._registerz()
            elif path == "/deregisterz":
                self._deregisterz()
            elif path == "/chaosz":
                self._chaosz()
            else:
                self._send_text(
                    404, "not found; try /predict /predict/<model> "
                    "/registerz /deregisterz /chaosz\n"
                )
        except Exception as e:
            logger.exception("router POST error for %s", self.path)
            self._send_error_json(500, "internal", detail=str(e))

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0) or 0)
        return self.rfile.read(length) if length else b""

    # -- the fleet hot path -------------------------------------------------

    def _log_request(
        self,
        status: int,
        latency_s: float,
        attempts: int,
        replica_name: Optional[str],
        body: bytes,
        error: Optional[str] = None,
    ) -> None:
        """One structured JSON line per routed POST (``--request-log``)
        — the GATEWAY's schema (``ts/path/status/latency_ms/lane/
        trace_id/n_rows/shape/deadline_ms/post_seq``) plus the fleet
        fields ``replica`` (who served it) and ``attempts``, so a
        fleet recording replays through the same ``loadgen/trace.py``
        parser as a single-gateway one."""
        n_rows = shape = deadline_ms = None
        try:
            doc = json.loads(body or b"{}")
            instances = doc.get("instances")
            if isinstance(instances, list) and instances:
                n_rows = len(instances)
                first, dims = instances[0], []
                while isinstance(first, list):
                    dims.append(len(first))
                    first = first[0] if first else None
                shape = dims
            deadline_ms = doc.get("deadline_ms")
        except (ValueError, TypeError):
            pass  # a malformed body still deserves its outcome line
        line = {
            "ts": round(self._t_wall, 6),
            "path": "/predict",
            "status": status,
            "latency_ms": round(latency_s * 1e3, 3),
            "lane": None,  # schema parity: lanes are a replica detail
            "trace_id": self._trace_id,
            "n_rows": n_rows,
            "shape": shape,
            "deadline_ms": deadline_ms,
            "post_seq": next_post_seq(),
            "replica": replica_name,
            "attempts": attempts,
        }
        if error is not None:
            line["error"] = error
        self.server.write_request_log(line)  # type: ignore[attr-defined]

    def _predict(self, model_id: Optional[str] = None) -> None:
        body = self._read_body()
        t0 = time.perf_counter()
        self._t_wall = time.time()  # arrival clock for the request log
        # one fleet-wide trace id per request: adopt the client's W3C
        # traceparent if it sent one, mint otherwise (tracing on) —
        # every forward attempt below is a SIBLING span under this id
        # and the header the replica receives carries it downstream
        tracer = get_tracer()
        ctx = parse_traceparent(self.headers.get(TRACEPARENT_HEADER))
        if ctx is not None:
            self._trace_id = ctx.trace_id
        elif tracer.enabled:
            self._trace_id = new_trace_id()
        request_log = self.server.request_log  # type: ignore[attr-defined]
        if not body:
            if request_log:
                # one line per routed POST means THIS one too — a
                # replay that silently loses client mistakes can't
                # reproduce the client's offered load
                self._log_request(
                    400, time.perf_counter() - t0, 0, None, body,
                    error="empty /predict body",
                )
            self._send_error_json(
                400, "bad_request", detail="empty /predict body"
            )
            return
        max_retries = self.server.max_retries  # type: ignore[attr-defined]
        tried: List = []
        typed_fallback: Optional[Tuple[int, bytes]] = None
        untyped_fallback: Optional[Tuple[int, bytes]] = None
        retry_reason: Optional[str] = None
        for _attempt in range(max_retries + 1):
            # a named model only routes to replicas ADVERTISING it
            # (registration's "models" list) — the health fallbacks
            # inside pick() never widen past the advertiser set
            replica = self.fleet.pick(exclude=tried, model=model_id)
            if replica is None:
                break
            tried.append(replica)
            if _attempt > 0:
                # counted HERE, when a second attempt actually
                # dispatches — an exhausted pick() is not a retry
                self.metrics.record_retry()
            # one router.forward span per ATTEMPT: retries are sibling
            # spans (same trace, no parent) whose retry_reason attr
            # says why the previous hop failed — the stitched tree
            # shows the failover, not just the attempt that won
            span = tracer.start_span(
                "router.forward",
                trace_id=self._trace_id,
                router=self.server.router_name,  # type: ignore[attr-defined]
                replica=replica.name,
                attempt=_attempt,
            )
            if retry_reason is not None:
                span.set_attr("retry_reason", retry_reason)
            traceparent = None
            if self._trace_id is not None:
                # tracing off but an inbound context present: relay
                # the caller's header verbatim (a formatted one would
                # carry the null span's all-zero parent id, which the
                # replica must reject per the W3C spec)
                traceparent = (
                    format_traceparent(self._trace_id, span.span_id)
                    if span.span_id is not None
                    else self.headers.get(TRACEPARENT_HEADER)
                )
                # chaos point: strip the trace context off this
                # forward (router.trace.drop) — the replica must fall
                # back to a self-minted id and serve normally, and
                # the stitch must degrade to a counted partial tree
                if faults.armed() and faults.fire(
                    "router.trace.drop",
                    {"replica": replica.name, "index": replica.index},
                ) is not None:
                    span.set_attr("traceparent_dropped", True)
                    traceparent = None
            try:
                status, payload, ctype = self._forward(
                    replica, body, traceparent,
                    path=(
                        "/predict" if model_id is None
                        else f"/predict/{model_id}"
                    ),
                )
                span.set_attr("status", status)
            except ReplicaUnavailable as e:
                retry_reason = f"{replica.name}: {e}"
                span.set_attr("error", str(e))
                if e.charge:
                    replica.mark_failed(str(e))
                if e.typed is not None:
                    typed_fallback = e.typed
                if e.untyped is not None:
                    untyped_fallback = e.untyped
                if _attempt < max_retries:
                    logger.warning(
                        "router: replica %s failed a request (%s); "
                        "retrying on another replica",
                        replica.name, e,
                    )
                continue
            except Exception as e:
                # any other surprise propagates to do_POST's 500
                # handler — but the
                # attempt span must still record (or the forensics
                # for exactly the failed request lose its forward
                # hop), and the request log still gets its
                # one-line-per-POST outcome
                span.set_attr("error", f"{type(e).__name__}: {e}")
                if request_log:
                    self._log_request(
                        500, time.perf_counter() - t0, len(tried),
                        replica.name, body,
                        error=f"{type(e).__name__}: {e}",
                    )
                raise
            finally:
                # every exit path — success, retry, raise — ends the
                # span: a leaked _ActiveSpan stays on this handler
                # thread's stack and never reaches the ring/exporter
                tracer.end_span(span)
            replica.mark_ok()
            self.metrics.record_outcome(
                "ok" if status < 400
                else "shed" if status in (429, 503, 504)
                else "error"
            )
            if request_log:
                self._log_request(
                    status, time.perf_counter() - t0, len(tried),
                    replica.name, body,
                )
            self._send(
                status, payload,
                ctype or "application/json; charset=utf-8",
            )
            return
        if untyped_fallback is not None:
            # the failure REPRODUCED (or had no sibling to disprove
            # it): a real error response propagates as the error it
            # is — the pool's deterministic-error doctrine. Masking
            # it as a typed shed would hide a 500-ing fleet from the
            # invariant checker built to catch exactly that.
            status, payload = untyped_fallback
            self.metrics.record_outcome("error")
            if request_log:
                self._log_request(
                    status, time.perf_counter() - t0, len(tried),
                    None, body, error=retry_reason,
                )
            self._send(
                status, payload, "application/json; charset=utf-8"
            )
            return
        if typed_fallback is not None:
            # every live replica is draining: surface THEIR typed
            # answer (503 closed), not a router-invented error
            status, payload = typed_fallback
            self.metrics.record_outcome("shed")
            if request_log:
                self._log_request(
                    status, time.perf_counter() - t0, len(tried),
                    None, body, error="closed",
                )
            self._send(
                status, payload, "application/json; charset=utf-8"
            )
            return
        if model_id is not None and not tried:
            # a roster may exist yet hold NO advertiser for this model
            # — that is a routing fact, not overload, and the typed
            # body says which model the fleet can't place
            self.metrics.record_outcome("shed")
            if request_log:
                self._log_request(
                    503, time.perf_counter() - t0, 0, None, body,
                    error=f"no replica advertises model {model_id}",
                )
            self._send_json(
                {
                    "error": "no_replica_for_model",
                    "model": model_id,
                    "detail": (
                        f"none of {len(self.fleet)} replicas "
                        f"advertises model {model_id!r}"
                    ),
                },
                code=503,
            )
            return
        self.metrics.record_outcome("shed")
        if request_log:
            self._log_request(
                503, time.perf_counter() - t0, len(tried), None, body,
                error=retry_reason or "no replica available",
            )
        self._send_json(
            {
                "error": "overloaded",
                "reason": "closed",
                "detail": (
                    f"no replica available (tried {len(tried)} of "
                    f"{len(self.fleet)})"
                ),
            },
            code=503,
        )

    def _forward(
        self,
        replica,
        body: bytes,
        traceparent: Optional[str] = None,
        path: str = "/predict",
    ) -> Tuple[int, bytes, str]:
        """POST the raw /predict body to one replica (plus the W3C
        ``traceparent`` when the request is traced — the replica
        adopts its trace id). ``path`` is PRESERVED on the forward —
        a ``/predict/<model>`` request reaches the replica under the
        same model id the client named, so the replica's zoo (not the
        router) owns model resolution. Returns ``(status, payload,
        content_type)`` for any response the client should see
        verbatim; raises ``ReplicaUnavailable`` for outcomes worth
        trying another replica for."""
        # chaos point: an armed router.replica.partition severs the
        # router<->replica link BEFORE the forward is even dialed —
        # the request-path half of a network partition (the replica
        # never sees the request, unlike blackhole's return-path
        # drop). The retry + health machinery must absorb it exactly
        # like a connection refusal: fail over to a sibling, charge
        # the replica. Unarmed: one attribute read.
        if faults.armed() and faults.fire(
            "router.replica.partition",
            {"replica": replica.name, "index": replica.index},
        ) is not None:
            raise ReplicaUnavailable(
                "router.replica.partition severed the forward to "
                f"{replica.name}"
            )
        headers = {"Content-Type": "application/json"}
        if traceparent is not None:
            headers[TRACEPARENT_HEADER] = traceparent
        req = urllib.request.Request(
            replica.url + path,
            data=body,
            headers=headers,
            method="POST",
        )
        timeout = self.server.forward_timeout_s  # type: ignore[attr-defined]
        replica.begin_request()
        try:
            try:
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    status = resp.status
                    payload = resp.read()
                    ctype = resp.headers.get("Content-Type")
            except urllib.error.HTTPError as e:
                status = e.code
                payload = e.read() or b""
                ctype = e.headers.get("Content-Type")
                try:
                    doc = json.loads(payload or b"{}")
                except ValueError:
                    doc = {}
                typed = (
                    status in (429, 503, 504)
                    and doc.get("error") == "overloaded"
                )
                if not typed and status >= 500:
                    # an untyped 5xx is replica-specific until a
                    # sibling reproduces it — same doctrine as the
                    # pool's retry-to-another-lane. The raw response
                    # rides along: if every sibling fails too, THIS
                    # error surfaces verbatim, never a fake typed shed
                    raise ReplicaUnavailable(
                        f"untyped {status} from {replica.name}",
                        untyped=(status, payload),
                    ) from e
                if typed and doc.get("reason") == "closed":
                    # draining: fail over (a healthy sibling should
                    # answer), keep the typed 503 as the last resort,
                    # and charge nothing — draining is lifecycle, not
                    # failure
                    raise ReplicaUnavailable(
                        f"{replica.name} draining (typed closed)",
                        charge=False,
                        typed=(status, payload),
                    ) from e
                # typed shed (429/504) or a client 4xx: the gateway's
                # verdict about THIS request — propagate verbatim
            except (TimeoutError, OSError, http.client.HTTPException) as e:
                # URLError (connection refused/reset) and socket
                # timeouts are both OSError here: the replica process
                # never produced an answer; nor did one that died
                # between its headers and its body (IncompleteRead, a
                # kill -9 mid-response)
                raise ReplicaUnavailable(
                    f"{replica.name}: {type(e).__name__}: {e}"
                ) from e
        finally:
            replica.end_request()
        # chaos point: an armed router.replica.blackhole (typically
        # matched to one replica by name or registration index) drops
        # the matched replica's responses AFTER the replica did the
        # work — a return-path partition. The router must treat it
        # exactly like a transport failure: retry elsewhere, charge
        # the replica's health. Unarmed: one attribute read, no ctx
        # dict built.
        if faults.armed() and faults.fire(
            "router.replica.blackhole",
            {"replica": replica.name, "index": replica.index},
        ) is not None:
            raise ReplicaUnavailable(
                "router.replica.blackhole dropped a response from "
                f"{replica.name}"
            )
        return status, payload, ctype

    # -- membership + chaos surfaces ----------------------------------------

    def _registerz(self) -> None:
        try:
            doc = json.loads(self._read_body() or b"{}")
        except ValueError as e:
            self._send_error_json(400, "bad_request", detail=str(e))
            return
        url = doc.get("url")
        if not isinstance(url, str):
            self._send_error_json(
                400, "bad_request",
                detail='want {"url": "http://host:port"}',
            )
            return
        models = doc.get("models")
        if models is not None and (
            not isinstance(models, list)
            or not all(isinstance(m, str) for m in models)
        ):
            self._send_error_json(
                400, "bad_request",
                detail='"models" must be a list of model-id strings',
            )
            return
        try:
            replica, created = self.fleet.add(
                url, source="registered", models=models
            )
        except ValueError as e:
            self._send_error_json(400, "bad_request", detail=str(e))
            return
        self._send_json(
            {
                "registered": True,
                "created": created,
                "index": replica.index,
                "replicas": len(self.fleet),
                "probe_interval_s": self.fleet.probe_interval_s,
                "models": sorted(replica.models),
            }
        )

    def _deregisterz(self) -> None:
        """Roster removal (idempotent): the graceful-retirement half
        of ``/registerz``. A deregistered replica gets no new
        forwards; in-flight forwards finish normally."""
        try:
            doc = json.loads(self._read_body() or b"{}")
        except ValueError as e:
            self._send_error_json(400, "bad_request", detail=str(e))
            return
        url = doc.get("url")
        if not isinstance(url, str):
            self._send_error_json(
                400, "bad_request",
                detail='want {"url": "http://host:port"}',
            )
            return
        try:
            removed = self.fleet.remove(url)
        except ValueError as e:
            self._send_error_json(400, "bad_request", detail=str(e))
            return
        self._send_json(
            {"deregistered": removed, "replicas": len(self.fleet)}
        )

    def _chaosz(self) -> None:
        """Arm/disarm fault points in the ROUTER process (the fleet
        hot path's chaos surface; same contract as the gateway
        frontend's)."""
        if not self.server.chaos_routes:  # type: ignore[attr-defined]
            self._send_error_json(
                404, "chaos_routes_disabled",
                detail="started with --no-chaosz",
            )
            return
        injector = faults.get_injector()
        try:
            doc = json.loads(self._read_body() or b"{}")
        except ValueError as e:
            self._send_error_json(400, "bad_request", detail=str(e))
            return
        if "arm" in doc:
            spec = doc["arm"]
            if not isinstance(spec, dict) or "point" not in spec:
                self._send_error_json(
                    400, "bad_request",
                    detail='arm wants {"point": ..., [count/delay_ms/'
                           'for_s/match]}',
                )
                return
            spec = dict(spec)
            point = spec.pop("point")
            if point not in faults.FAULT_POINTS:
                self._send_error_json(
                    400, "unknown_fault_point", point=point,
                    known=sorted(faults.FAULT_POINTS),
                )
                return
            try:
                injector.arm(point, **spec)
            except (TypeError, ValueError) as e:
                self._send_error_json(400, "bad_request", detail=str(e))
                return
        elif "disarm" in doc:
            point = doc["disarm"]
            if point == "*":
                injector.disarm_all()
            else:
                injector.disarm(point)
        else:
            self._send_error_json(
                400, "bad_request",
                detail='want {"arm": {...}} or {"disarm": "<point>|*"}',
            )
            return
        self._send_json(injector.status(), indent=1)


class RouterServer(BackgroundServer):
    """The fleet router over one ``ReplicaRegistry``. ``start()``
    binds, serves on a daemon thread, and starts the registry's
    background health probes; ``stop()`` shuts both down."""

    handler_cls = _RouterHandler
    thread_name = "keystone-router-http"

    def __init__(
        self,
        replicas: Sequence[str] = (),
        port: int = 0,
        host: str = "127.0.0.1",
        *,
        name: str = "router",
        registry=None,
        probe_interval_s: float = 2.0,
        probe_timeout_s: float = 5.0,
        unhealthy_after: Optional[int] = None,
        recovery_after_s: Optional[float] = None,
        forward_timeout_s: float = FORWARD_TIMEOUT_S,
        max_retries: int = 1,
        chaos_routes: bool = True,
        request_log: Any = False,
        stitch_timeout_s: float = 5.0,
        slo_latency_s: Optional[float] = None,
        slo_target: float = 0.99,
        slo_fast_window_s: float = 60.0,
        slo_slow_window_s: float = 1800.0,
        slo_sample_interval_s: float = 5.0,
    ):
        super().__init__(port=port, host=host)
        if max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {max_retries}"
            )
        self.name = name
        self.registry = (
            registry if registry is not None else get_global_registry()
        )
        self.metrics = RouterMetrics(registry=self.registry, router=name)
        # ``--request-log`` parity with the gateway: one JSON line per
        # routed POST in the same replayable schema (plus replica +
        # attempts), through the shared writer
        self._request_log = RequestLogWriter(request_log)
        self.request_log = self._request_log.enabled
        # the cross-process forensics engine behind GET /debugz
        self.stitcher = TraceStitcher(
            name=name,
            registry=self.registry,
            fetch_timeout_s=stitch_timeout_s,
        )
        kwargs: Dict[str, Any] = {}
        if unhealthy_after is not None:
            kwargs["unhealthy_after"] = unhealthy_after
        if recovery_after_s is not None:
            kwargs["recovery_after_s"] = recovery_after_s
        self.fleet = ReplicaRegistry(
            replicas,
            probe_interval_s=probe_interval_s,
            probe_timeout_s=probe_timeout_s,
            name=name,
            **kwargs,
        )
        self.forward_timeout_s = float(forward_timeout_s)
        self.max_retries = int(max_retries)
        self.chaos_routes = bool(chaos_routes)
        self._started_t = time.time()
        # -- the fleet-wide SLO (federated burn rates at /slz) -------------
        self.slo_monitor: Optional[slo_mod.SloMonitor] = None
        self._slo_sample_interval_s = float(slo_sample_interval_s)
        if slo_latency_s is not None:
            self.slo_monitor = slo_mod.SloMonitor(
                fast_window_s=slo_fast_window_s,
                slow_window_s=slo_slow_window_s,
                registry=self.registry,
            )
            self.slo_monitor.add(
                slo_mod.Slo.latency_from_buckets(
                    f"{name}:fleet_latency",
                    self.federated_latency_buckets,
                    threshold_s=slo_latency_s,
                    target=slo_target,
                )
            )

    # -- federation ---------------------------------------------------------

    def federated_latency_buckets(self) -> List[Tuple[float, float]]:
        """The fleet-wide cumulative latency buckets: every replica's
        cached ``keystone_gateway_request_latency_seconds`` buckets
        merged (label-agnostic — distinctly-named gateways still sum
        into one fleet distribution)."""
        return prometheus.merge_histograms(
            [
                prometheus.histogram_buckets(text, FLEET_LATENCY_FAMILY)
                for text in self.fleet.scrapes()
            ]
        )

    def federated_metrics(self) -> str:
        """The ``/metrics`` body: on-demand replica scrapes (cached
        fallback for unreachable replicas) + the router's own
        registry, merged into one exposition. Conflicting histogram
        layouts drop (logged) rather than failing the whole fleet
        scrape."""
        own = prometheus.render(self.registry.collect())
        return prometheus.merge_expositions(
            [own] + self.fleet.fresh_scrapes(), on_conflict="drop"
        )

    def attributionz(self, top_k: int = 10) -> Dict:
        """The FLEET-TRUTH ``/attributionz``: the per-model cost-ledger
        document rebuilt from the federated scrape, so identical model
        labels across replicas have already SUMMED — the totals are the
        fleet's, not this process's."""
        from keystone_tpu_torch.observability.attribution import (
            attribution_from_samples,
        )

        return attribution_from_samples(
            prometheus.parse_samples(self.federated_metrics()),
            top_k=top_k,
        )

    def driftz(self) -> Dict:
        """The fleet ``/driftz``: every replica's
        ``keystone_drift_score{model}`` off the federated scrape (the
        gauge MAX-merges — the worst replica's drift IS the fleet's).
        Re-plan recommendations stay replica-local (each replica's
        ``/driftz`` owns its zoo's plan); this surface names who is
        drifting fleet-wide."""
        from keystone_tpu_torch.observability.drift import DEFAULT_THRESHOLD

        scores: Dict[str, float] = {}
        for name, labels, value in prometheus.parse_samples(
            self.federated_metrics()
        ):
            if name != "keystone_drift_score":
                continue
            model = labels.get("model")
            if model is not None:
                scores[model] = max(scores.get(model, value), value)
        return {
            "threshold": DEFAULT_THRESHOLD,
            "scores": {m: round(s, 4) for m, s in sorted(scores.items())},
            "drifted": sorted(
                m for m, s in scores.items() if s > DEFAULT_THRESHOLD
            ),
            "note": (
                "federated MAX of keystone_drift_score per model; "
                "re-plan recommendations live on each replica's /driftz"
            ),
        }

    def fleetz(self) -> Dict:
        """The ``/fleetz`` document: router identity + the roster."""
        doc = self.fleet.roster()
        counts = doc["counts"]
        self.metrics.set_replica_states(counts)
        doc["router"] = {
            "name": self.name,
            "uptime_s": round(time.time() - self._started_t, 1),
            "max_retries": self.max_retries,
            "forward_timeout_s": self.forward_timeout_s,
            "slo": (
                [s.name for s in self.slo_monitor.slos]
                if self.slo_monitor is not None
                else []
            ),
        }
        return doc

    # -- lifecycle ----------------------------------------------------------

    def resolve_replica_url(self, name: str) -> Optional[str]:
        """Replica NAME (a ``router.forward`` span's ``replica`` attr)
        -> base URL via the registry — the stitcher only ever dials
        replicas the fleet actually knows, never a URL a span claims."""
        replica = self.fleet.find_by_name(name)
        return replica.url if replica is not None else None

    def write_request_log(self, line: Dict[str, Any]) -> None:
        self._request_log.write(line)

    def _configure(self, httpd) -> None:
        httpd.fleet = self.fleet
        httpd.metrics = self.metrics
        httpd.max_retries = self.max_retries
        httpd.forward_timeout_s = self.forward_timeout_s
        httpd.chaos_routes = self.chaos_routes
        httpd.federated_metrics = self.federated_metrics
        httpd.fleetz = self.fleetz
        httpd.attributionz = self.attributionz
        httpd.driftz = self.driftz
        httpd.router_name = self.name
        httpd.request_log = self.request_log
        httpd.write_request_log = self.write_request_log
        httpd.stitcher = self.stitcher
        httpd.resolve_replica_url = self.resolve_replica_url

    def start(self) -> "RouterServer":
        super().start()
        self.fleet.start()
        if self.slo_monitor is not None:
            self.slo_monitor.start(self._slo_sample_interval_s)
        return self

    def stop(self) -> None:
        if self.slo_monitor is not None:
            self.slo_monitor.stop()
        self.fleet.stop()
        super().stop()
        self._request_log.close()


def main(argv=None) -> int:
    """``python -m keystone_tpu_torch serve-router --replica URL ...`` —
    stand up the fleet tier over running ``serve-gateway`` replicas
    (or an empty roster that fills via ``--register``
    self-registration)."""
    import argparse
    import signal

    ap = argparse.ArgumentParser(
        prog="keystone_tpu_torch serve-router", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--router-port", "--port", dest="port", type=int,
                    default=0, help="bind port (0 = ephemeral)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--replica", action="append", default=[],
                    metavar="URL",
                    help="a gateway replica's base URL (repeatable); "
                    "replicas can also self-register via POST "
                    "/registerz (serve-gateway --register)")
    ap.add_argument("--probe-interval", type=float, default=2.0,
                    help="seconds between background health probes")
    ap.add_argument("--probe-timeout", type=float, default=5.0)
    ap.add_argument("--unhealthy-after", type=int, default=None,
                    help="consecutive request failures that bench a "
                    "replica (default 3, mirroring the lane pool)")
    ap.add_argument("--recovery-after", type=float, default=None,
                    help="seconds a benched replica sits out before "
                    "half-open probe traffic (default 5)")
    ap.add_argument("--forward-timeout", type=float,
                    default=FORWARD_TIMEOUT_S)
    ap.add_argument("--max-retries", type=int, default=1,
                    help="retries on ANOTHER replica after a replica "
                    "failure before the error surfaces")
    ap.add_argument("--slo-latency-ms", type=float, default=None,
                    help="declare a FLEET-WIDE latency SLO at this "
                    "threshold: burn rates computed over the "
                    "federated le buckets, served at /slz")
    ap.add_argument("--slo-target", type=float, default=0.99)
    ap.add_argument("--no-chaosz", action="store_true",
                    help="disable the /chaosz fault-injection routes "
                    "on this router")
    ap.add_argument("--no-trace", action="store_true",
                    help="disable distributed tracing: no "
                    "router.forward spans, no W3C traceparent "
                    "propagation to replicas, no X-Keystone-Trace "
                    "echo, no /debugz stitching (default ON)")
    ap.add_argument("--request-log", nargs="?", const=True,
                    default=False, metavar="FILE",
                    help="one structured JSON line per routed "
                    "/predict (the gateway's replayable schema plus "
                    "replica + attempts). Bare flag: stdout; with "
                    "FILE: append line-buffered JSONL there")
    args = ap.parse_args(argv)
    if not args.no_trace:
        # the fleet's forensic chain — traceparent propagation, the
        # stitched /debugz, phase decomposition — keys off spans, so
        # the router traces by default
        from keystone_tpu_torch.observability import enable_tracing

        enable_tracing()
    server = RouterServer(
        args.replica,
        port=args.port,
        host=args.host,
        probe_interval_s=args.probe_interval,
        probe_timeout_s=args.probe_timeout,
        unhealthy_after=args.unhealthy_after,
        recovery_after_s=args.recovery_after,
        forward_timeout_s=args.forward_timeout,
        max_retries=args.max_retries,
        chaos_routes=not args.no_chaosz,
        request_log=args.request_log,
        slo_latency_s=(
            args.slo_latency_ms / 1e3
            if args.slo_latency_ms is not None else None
        ),
        slo_target=args.slo_target,
    ).start()
    # chaos experiments can pre-arm fleet fault points from the
    # environment (KEYSTONE_FAULTS="router.replica.blackhole=..."),
    # same contract as the serving CLIs
    faults.arm_from_env()
    # the machine-parseable bound-address line FIRST (smoke scripts
    # and drills launch with --port 0 and read this, no port races),
    # then the human summary
    print(
        json.dumps(
            {
                "listening": server.url().rstrip("/"),
                "role": "router",
                "replicas": [r.url for r in server.fleet.replicas()],
            }
        ),
        flush=True,
    )
    print(
        f"router: {server.url()} (POST /predict, POST /registerz, "
        "POST /deregisterz, GET /fleetz, GET /readyz, GET /metrics, "
        "GET /attributionz, GET /driftz, GET /slz, GET /tracez, "
        "GET /debugz?trace_id=, GET|POST /chaosz)",
        flush=True,
    )
    stop = threading.Event()

    def handle(signum, frame):
        logger.info("router: signal %d, stopping", signum)
        stop.set()

    signal.signal(signal.SIGTERM, handle)
    signal.signal(signal.SIGINT, handle)
    try:
        while not stop.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    server.stop()
    return 0


__all__ = [
    "FORWARD_TIMEOUT_S",
    "ReplicaUnavailable",
    "RouterMetrics",
    "RouterServer",
    "main",
]
