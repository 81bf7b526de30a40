"""HTTP inference frontend: the network face of the gateway (counterpart
of ``keystone_tpu/gateway/http.py``: one model, or a model zoo).

A stdlib ``http.server`` on a background daemon thread, following the
``observability/admin.py`` server pattern (nothing to install, ephemeral
``port=0`` for tests/smoke, daemon threads per request). Routes:

- ``POST /predict`` — body ``{"instances": [<example>, ...]}`` (each
  instance one example WITHOUT the batch axis; numbers nest as JSON
  arrays), optional ``"deadline_ms"``. Every instance is admitted
  individually, so concurrent clients coalesce in the micro-batchers.
  Under ``--device-featurize`` (``input_dtype=uint8``) instances are
  RAW uint8 images — the staging path carries raw bytes and the fused
  featurize∘model bucket graph does the rest on the card.
  Responds ``{"predictions": [...]}``; typed errors map to status
  codes: 429 shed (``Overloaded``: queue_full/deadline), 504 expired,
  503 draining/closed, 400 malformed, 500 engine error. An inbound
  W3C ``traceparent`` header (the fleet router sends one per forward)
  is ADOPTED: every instance's admit → coalesce → dispatch span
  chain, the latency exemplars, and any flight-recorder capture ride
  the caller's trace id, and every response — success AND typed
  shed — echoes it as ``X-Keystone-Trace`` (with tracing on and no
  inbound context, this process roots the trace itself).
- ``POST /predict/<model>`` — the model-zoo route (``--zoo``): same
  body, routed to the named model (``zoo/host.py`` ``ModelZoo``) with
  that model's input dtype; bare ``/predict`` serves the zoo's default
  model. An unknown id is a typed 404 ``{"error": "unknown_model",
  "model": ..., "registered": [...]}`` (the fleet router passes it
  through verbatim). Without ``--zoo`` the route 404s the same way
  with an empty ``registered`` list.
- ``GET /planz`` — zoo mode: the applied ``PlacementPlan`` (or none)
  next to every model's actual shape (resident, lanes, buckets,
  shared-prefix membership); ``GET /attributionz`` — the per-model
  device-cost ledger; ``GET /driftz`` — live-vs-plan request-size
  drift with the re-plan recommendation. Without ``--zoo`` each answers
  the typed 404 ``no_zoo``, as the JAX gateway does.
- ``GET /readyz`` — 200 while the gateway admits, 503 once draining.
  READINESS, not liveness: the admin endpoint's ``/healthz`` answers
  "is the process up", this answers "should the load balancer route
  here" — a draining gateway is alive but not ready. With SLOs
  declared, an active burn/pressure state is appended to the body
  (still 200: burning means "send less", not "stop sending"). Every
  response carries an ``X-Keystone-Load`` header (queued + in-lane
  requests) — the fleet router's probes read this replica's routing
  load from the same request its health comes from. A convenience
  ``GET /healthz`` is also served for single-port deployments.
- ``GET /metrics`` — Prometheus exposition of the (global) registry,
  so a gateway-only deployment is scrapeable without the admin server
  (latency-histogram buckets carry ``trace_id`` exemplars).
- ``GET /slz`` / ``GET /debugz`` / ``GET /tracez`` — the SLO
  burn-rate, flight-recorder, and recent-span surfaces, mirrored from
  the admin endpoint for single-port deployments (``/tracez`` shows
  the per-window ``microbatch.coalesce`` → ``pipeline.host_prep`` /
  ``.upload`` / ``.compute`` / ``.deliver`` stage chains when the
  lanes run pipelined and tracing is on).
- ``GET /profilez?seconds=N`` — arm a Kineto trace around
  the next N seconds of live traffic and list the capture directory
  (a Chrome trace); 409 while another capture runs — mirrored from the
  admin endpoint (``observability/profilez.py``) so a gateway-only
  deployment can still grab a device trace. The server also runs the
  device-memory sampler, so ``/metrics`` here carries the
  ``keystone_device_memory_bytes`` and ``keystone_device_info``
  families without an admin port.
- ``POST /swap`` — force one lifecycle iteration
  (``Gateway.rebucket(force=True)``, or every resident unit's in zoo
  mode); returns the active bucket set.
- ``POST /drain`` — begin graceful shutdown in the background;
  ``/readyz`` flips 503 immediately, admitted requests resolve.
- ``GET /chaosz`` / ``POST /chaosz`` — the fault-injection plane's
  admin surface (``loadgen/faults.py``): GET lists the fault-point
  catalog, armed specs, and fire counts; POST ``{"arm": {"point":
  ..., "count": ..., "delay_ms": ..., "for_s": ..., "match": {...}}}``
  arms a point in THIS process (400 for a point outside the catalog),
  ``{"disarm": "<point>"}`` / ``{"disarm": "*"}`` clears. This is how
  the load generator injects faults into a live gateway from outside.
- ``POST /feedback`` (and ``/feedback/<model>``) — body
  ``{"instances": [[...]], "labels": [[...]]}``: queue labeled examples
  for the streaming refit (``lifecycle/controller.py``); ``GET
  /lifecyclez`` reports every model's refit → shadow → canary state,
  ``POST /lifecyclez`` ``{"tick": true}`` forces a policy tick and
  ``{"rollback": true[, "model": m]}`` a rollback (``serve-lifecycle``).
  Without a lifecycle they answer the typed 404 ``no_lifecycle``; an
  unknown model, ``unknown_lifecycle_model``.

With ``--request-log`` (or ``GatewayServer(request_log=True)``) every
``/predict`` instance also emits one structured JSON line — ``{"ts",
"status", "latency_ms", "lane", "trace_id", "n_rows", "shape",
"deadline_ms"}`` — so a flight-recorder trace id found at ``/debugz``
is greppable straight from the process log, and the line carries
enough to RECONSTRUCT the request (``n_rows`` = instances in the
originating POST). Lines go to stdout by default;
``--request-log FILE`` (or ``GatewayServer(request_log="path")``)
appends them line-buffered to a JSONL file instead, so record/replay
needs no process-output scraping.

``main`` (``serve-gateway``) takes the JAX package's lifecycle, fleet
and zoo flags: ``--refit`` (with ``--refit-interval-s``,
``--refit-min-samples`` and ``--canary-fraction``) runs the online
lifecycle over the demo model, split at its last layer
(``serving/bench.build_split_pipeline``) so that the head refits in
closed form; single-model mode only, as in JAX. ``--register ROUTER_URL`` (repeatable) self-registers the
replica with a fleet router (``fleet/router.py``; ``--advertise-url``
names the URL to register), ``--zoo SPEC.json`` serves a model zoo,
with ``--optimize`` (host under the placement plan) and
``--max-resident N`` (LRU cap). ``--aot-cache DIR`` starts from the
AOT store at DIR (``serving/aot.py``: kernel libraries and bucket
entries; ``$KEYSTONE_AOT_CACHE`` names one too, ``--no-cache`` turns it
off; without either the port keeps no store, where the JAX package
defaults to one under the home directory). ``--shard-model`` shards the
model over a ``(data, model)`` mesh of ``--mesh-model N`` devices
(``serving/sharding.py``; more than the host has exits 1 with the
reason). The ``{"listening": ...}`` line carries ``start_s``, the start
split in seconds (``process_at_main``, ``cuda_init`` on the card,
``model``, ``gateway`` with its ``lanes`` and ``warmup``,
``kernel_build`` when ``nvcc`` ran, ``libraries`` from the store), and
under ``--shard-model`` every parameter's resolved spec. On SIGTERM a registered replica
deregisters from its routers first and then drains, so the routers
stop sending before it starts refusing (the JAX package drains first);
after the drain it prints ``{"drained": true, "launches": {...}}``, the
kernel launches of its life (``_cuda.LAUNCHES``).
"""

from __future__ import annotations

import json
import logging
import os
import signal
import sys
import threading
import time
from typing import Any, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from keystone_tpu_torch import _cuda
from keystone_tpu_torch.gateway.admission import Overloaded
from keystone_tpu_torch.gateway.lifecycle import Gateway
from keystone_tpu_torch.loadgen import faults
from keystone_tpu_torch.observability import device as device_obs
from keystone_tpu_torch.observability import flight as flight_mod
from keystone_tpu_torch.observability import profilez as profilez_mod
from keystone_tpu_torch.observability import prometheus
from keystone_tpu_torch.observability import slo as slo_mod
from keystone_tpu_torch.observability.httpd import (
    BackgroundServer,
    JsonHandler,
    RequestLogWriter,
    next_post_seq,
)
from keystone_tpu_torch.observability.registry import get_global_registry
from keystone_tpu_torch.observability.tracing import (
    TRACEPARENT_HEADER,
    TRACE_RESPONSE_HEADER,
    get_tracer,
    new_trace_id,
    parse_traceparent,
    tracez_document,
)

logger = logging.getLogger(__name__)

# generous server-side ceiling for waiting on one prediction; requests
# with their own deadline wait deadline + slack instead
RESULT_TIMEOUT_S = 60.0

# the model-zoo GET routes' answers without --zoo, as the JAX gateway's
NO_ZOO_DETAIL = {
    "/planz": "started without --zoo; /planz reports the model-zoo "
              "placement plan",
    "/attributionz": "started without --zoo; /attributionz reports the "
                     "per-model device-cost ledger",
    "/driftz": "started without --zoo; /driftz reports live-vs-plan "
               "workload drift and the re-plan recommendation",
}

def _status_for(err: Overloaded) -> int:
    if err.reason == "closed":
        return 503
    if err.reason == "expired":
        return 504
    return 429


class _Handler(JsonHandler):
    def _send(self, code, body, content_type, headers=None) -> None:
        # every response of a traced /predict (success, typed shed,
        # error) carries the trace id — the client's forensic handle
        # into /debugz?trace_id= on whichever process served it
        tid = getattr(self, "_trace_id", None)
        if tid:
            headers = {**(headers or {}), TRACE_RESPONSE_HEADER: tid}
        super()._send(code, body, content_type, headers=headers)

    def _send_error_json(self, code: int, error: str, **extra) -> None:
        self._send_json({"error": error, **extra}, code=code)

    @property
    def zoo(self):
        return self.server.zoo  # type: ignore[attr-defined]

    @property
    def lifecycle(self):
        """The LifecycleManager, if this frontend runs one — set
        directly (``--refit``) or attached to the zoo
        (``ModelZoo.attach_lifecycle``)."""
        mgr = self.server.lifecycle  # type: ignore[attr-defined]
        if mgr is None and self.zoo is not None:
            mgr = getattr(self.zoo, "lifecycle", None)
        return mgr

    @property
    def gateway(self) -> Gateway:
        gw = self.server.gateway  # type: ignore[attr-defined]
        if gw is None:
            # zoo mode: single-gateway routes act on the DEFAULT
            # model's unit
            zoo = self.zoo
            return zoo.gateway_for(zoo.registry.default_id)
        return gw

    def do_GET(self) -> None:  # noqa: N802 (stdlib handler API)
        url = urlparse(self.path)
        path = url.path
        self._trace_id = None  # per-request (keep-alive safety)
        try:
            if path == "/readyz" and self.zoo is not None:
                # zoo readiness: every RESIDENT unit admitting; load
                # is the sum across units (cold models hold no queue)
                zoo = self.zoo
                load_headers = {"X-Keystone-Load": str(zoo.total_load())}
                if zoo.ready:
                    self._send_text(200, "ok\n", headers=load_headers)
                else:
                    self._send_text(503, "draining\n", headers=load_headers)
            elif path == "/readyz":
                # the load-report header: queued + in-lane requests,
                # so the fleet router's probe reads this replica's
                # routing load without a full /metrics scrape
                load_headers = {
                    "X-Keystone-Load": str(
                        self.gateway.admission.queue_depth
                        + self.gateway.pool.total_load()
                    )
                }
                if self.gateway.ready:
                    status = self.gateway.slo_status()
                    if status is not None and (
                        status["pressure"] > 0 or status["breaching"]
                    ):
                        # burning is visible here but still 200: the
                        # LB should keep routing, admission itself is
                        # doing the early shedding
                        self._send_text(
                            200,
                            "ok (slo burning: "
                            f"pressure={status['pressure']:.2f} "
                            f"fast={status['burn_rate'].get('fast')})\n",
                            headers=load_headers,
                        )
                    else:
                        self._send_text(
                            200, "ok\n", headers=load_headers
                        )
                else:
                    self._send_text(
                        503, "draining\n", headers=load_headers
                    )
            elif path == "/healthz":
                self._send_text(200, "ok\n")
            elif path == "/metrics":
                registry = self.server.registry  # type: ignore[attr-defined]
                body, ctype = prometheus.negotiate_render(
                    registry.collect(), self.headers.get("Accept")
                )
                self._send(200, body.encode("utf-8"), ctype)
            elif path in NO_ZOO_DETAIL and self.zoo is None:
                # single-model deployment: the zoo routes answer as the
                # JAX gateway's do without --zoo
                self._send_error_json(
                    404, "no_zoo", detail=NO_ZOO_DETAIL[path],
                )
            elif path == "/planz":
                self._send_json(self.zoo.planz(), indent=1)
            elif path == "/attributionz":
                self._send_json(self.zoo.attributionz(), indent=1)
            elif path == "/driftz":
                self._send_json(self.zoo.driftz(), indent=1)
            elif path == "/slz":
                self._send_json(slo_mod.slz_status(), indent=1)
            elif path == "/debugz":
                q = parse_qs(url.query)
                code, doc = flight_mod.debugz_document(
                    q.get("trace_id", [None])[0],
                    q.get("format", [""])[0],
                )
                self._send_json(doc, code=code, indent=1)
            elif path == "/profilez":
                q = parse_qs(url.query)
                code, doc = profilez_mod.profilez_document(
                    q.get("seconds", [None])[0]
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
            elif path == "/lifecyclez":
                if self.lifecycle is None:
                    self._send_error_json(
                        404, "no_lifecycle",
                        detail="started without --refit; /lifecyclez "
                               "reports the online-lifecycle state "
                               "machine per model",
                    )
                else:
                    self._send_json(self.lifecycle.status(), indent=1)
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
            else:
                self._send_text(
                    404,
                    "not found; try /predict /predict/<model> /planz "
                    "/attributionz /driftz /readyz /healthz /metrics "
                    "/slz /debugz /tracez /profilez /chaosz "
                    "/lifecyclez\n",
                )
        except Exception as e:
            logger.exception("gateway GET error for %s", self.path)
            self._send_error_json(500, "internal", detail=str(e))

    def _log_request(
        self,
        status: int,
        latency_s: float,
        lane: Optional[int] = None,
        trace_id: Optional[str] = None,
        error: Optional[str] = None,
        n_rows: Optional[int] = None,
        shape: Optional[tuple] = None,
        deadline_ms: Optional[float] = None,
    ) -> None:
        """One structured JSON line per /predict instance
        (``--request-log``): trace ids surfaced at /debugz are
        greppable straight from the process log, and the
        ``n_rows``/``shape``/``deadline_ms`` fields make the record
        REPLAYABLE (``loadgen/trace.py`` reconstructs the request
        from them; pre-loadgen readers can ignore the extra keys)."""
        meta = getattr(self, "_log_meta", None) or {}
        line = {
            # arrival time (see do_POST), so replay preserves the
            # recorded arrival pattern rather than completion order
            "ts": round(getattr(self, "_t_wall", None) or time.time(), 6),
            "path": "/predict",
            "status": status,
            "latency_ms": round(latency_s * 1e3, 3),
            "lane": lane,
            "trace_id": trace_id,
            "n_rows": n_rows if n_rows is not None else meta.get("n_rows"),
            "shape": (
                list(shape) if shape is not None else meta.get("shape")
            ),
            "deadline_ms": (
                deadline_ms if deadline_ms is not None
                else meta.get("deadline_ms")
            ),
            "post_seq": meta.get("post_seq"),
            # zoo mode: which named model served the instance (None on
            # the bare single-model route; replay targets the same id)
            "model": meta.get("model"),
        }
        if error is not None:
            line["error"] = error
        self.server.write_request_log(line)  # type: ignore[attr-defined]

    def do_POST(self) -> None:  # noqa: N802 (stdlib handler API)
        path = urlparse(self.path).path
        self._trace_id = None  # _predict adopts/mints; see _send
        self._t_post = time.perf_counter()
        # ARRIVAL wall time: request-log lines stamp this (not
        # log-emit time, which for success lines is after the whole
        # POST resolved) — the replayer treats ts as the arrival
        # clock, so completion-time stamps would distort the recorded
        # inter-arrival gaps by per-request latency
        self._t_wall = time.time()
        # request-log context for the error handlers below; _predict
        # fills it once the body parses
        self._log_meta = {}
        try:
            if path == "/predict" or path.startswith("/predict/"):
                model_id = path[len("/predict/"):] if (
                    path.startswith("/predict/")
                ) else None
                self._predict(model_id or None)
            elif path == "/chaosz":
                self._chaosz()
            elif path == "/feedback" or path.startswith("/feedback/"):
                model_id = path[len("/feedback/"):] if (
                    path.startswith("/feedback/")
                ) else None
                self._feedback(model_id or None)
            elif path == "/lifecyclez":
                self._lifecyclez_post()
            elif path == "/swap":
                if self.zoo is not None:
                    self._send_json({"swapped": self.zoo.rebucket(force=True)})
                else:
                    swapped = self.gateway.rebucket(force=True)
                    self._send_json(
                        {
                            "swapped": swapped,
                            "buckets": list(self.gateway.buckets),
                        }
                    )
            elif path == "/drain":
                threading.Thread(
                    target=(
                        self.zoo.close if self.zoo is not None
                        else self.gateway.close
                    ),
                    name="keystone-gateway-drain",
                    daemon=True,
                ).start()
                self._send_json({"draining": True})
            else:
                self._send_text(
                    404,
                    "not found; try /predict /predict/<model> /swap "
                    "/drain /chaosz /feedback /lifecyclez\n",
                )
        except Overloaded as e:
            code = _status_for(e)
            if path == "/predict" and self.server.request_log:  # type: ignore[attr-defined]
                self._log_request(
                    code, time.perf_counter() - self._t_post,
                    error=e.reason,
                )
            self._send_error_json(
                code, "overloaded", reason=e.reason,
                detail=str(e),
            )
        except Exception as e:
            logger.exception("gateway POST error for %s", self.path)
            if path == "/predict" and self.server.request_log:  # type: ignore[attr-defined]
                self._log_request(
                    500, time.perf_counter() - self._t_post,
                    error=str(e),
                )
            self._send_error_json(500, "internal", detail=str(e))

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0) or 0)
        return self.rfile.read(length) if length else b""

    def _chaosz(self) -> None:
        """Arm/disarm fault points in this process (the load
        generator's remote chaos control; see loadgen/faults.py)."""
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

    def _feedback(self, model_id: Optional[str] = None) -> None:
        """Queue one labeled batch for the streaming refit. Body:
        ``{"instances": [[...], ...], "labels": [[...], ...]}``. The
        accumulation itself happens at policy-tick time, off this
        request path — the handler only validates shapes and appends
        to the controller's buffer."""
        mgr = self.lifecycle
        if mgr is None:
            self._send_error_json(
                404, "no_lifecycle",
                detail="started without --refit; /feedback feeds the "
                       "streaming-refit accumulator",
            )
            return
        controller = mgr.get(model_id)
        if controller is None:
            self._send_error_json(
                404, "unknown_lifecycle_model", model=model_id,
                known=mgr.models(),
            )
            return
        try:
            doc = json.loads(self._read_body() or b"{}")
            instances = doc["instances"]
            labels = doc["labels"]
        except (ValueError, KeyError, TypeError) as e:
            self._send_error_json(
                400, "bad_request",
                detail='want {"instances": [[...]], "labels": '
                       f'[[...]]}} ({e})',
            )
            return
        try:
            n = controller.add_feedback(instances, labels)
        except (ValueError, RuntimeError) as e:
            self._send_error_json(400, "bad_request", detail=str(e))
            return
        self._send_json({"queued": n, "model": controller.name})

    def _lifecyclez_post(self) -> None:
        """Operator controls (``serve-lifecycle``): ``{"tick": true}``
        forces one policy tick on every controller; ``{"rollback":
        true[, "model": m]}`` forces a rollback on one controller."""
        mgr = self.lifecycle
        if mgr is None:
            self._send_error_json(
                404, "no_lifecycle",
                detail="started without --refit",
            )
            return
        try:
            doc = json.loads(self._read_body() or b"{}")
        except ValueError as e:
            self._send_error_json(400, "bad_request", detail=str(e))
            return
        if doc.get("tick"):
            self._send_json({"ticked": mgr.tick_all()}, indent=1)
        elif doc.get("rollback"):
            controller = mgr.get(doc.get("model"))
            if controller is None:
                self._send_error_json(
                    404, "unknown_lifecycle_model",
                    model=doc.get("model"), known=mgr.models(),
                )
                return
            self._send_json(
                {"rolled_back": controller.force_rollback("manual")},
                indent=1,
            )
        else:
            self._send_error_json(
                400, "bad_request",
                detail='want {"tick": true} or {"rollback": true'
                       '[, "model": m]}',
            )

    def _predict(self, model_id: Optional[str] = None) -> None:
        # W3C trace adoption FIRST, before the body can 400 or
        # admission can shed: the router (or any tracing caller) sent
        # a `traceparent`, and EVERY response — success, typed shed,
        # malformed body — must echo the one trace id the fleet knows
        # this request by. With no inbound context and tracing on,
        # this process roots the trace itself (single-gateway mode).
        ctx = parse_traceparent(self.headers.get(TRACEPARENT_HEADER))
        if ctx is not None:
            self._trace_id = ctx.trace_id
        elif get_tracer().enabled:
            self._trace_id = new_trace_id()
        # model resolution before the body parse: an unknown id is a
        # typed 404 regardless of payload shape, and the error carries
        # the registered ids so the client can correct itself
        zoo = self.zoo
        if zoo is not None:
            from keystone_tpu_torch.zoo.registry import UnknownModel

            try:
                model_id, spec = zoo.resolve(model_id)
            except UnknownModel as e:
                self._send_error_json(
                    404, "unknown_model", model=e.model_id,
                    registered=list(e.registered),
                )
                return
            dtype = np.dtype(spec.input_dtype)

            def submit(ex, **kw):
                return zoo.predict(ex, model_id, **kw)

        elif model_id is not None:
            # single-model deployment: no named routes exist at all
            self._send_error_json(
                404, "unknown_model", model=model_id, registered=[],
                detail="single-model deployment (started without "
                       "--zoo); POST bare /predict",
            )
            return
        else:
            dtype = self.server.input_dtype  # type: ignore[attr-defined]
            submit = self.gateway.predict
        try:
            doc = json.loads(self._read_body() or b"{}")
            instances = doc["instances"]
            if not isinstance(instances, list) or not instances:
                raise ValueError("instances must be a non-empty list")
        except (ValueError, KeyError, TypeError) as e:
            self._send_error_json(400, "bad_request", detail=str(e))
            return
        deadline_ms = doc.get("deadline_ms")
        if deadline_ms is not None and (
            isinstance(deadline_ms, bool)
            or not isinstance(deadline_ms, (int, float))
            or deadline_ms <= 0
        ):
            self._send_error_json(
                400, "bad_request",
                detail=f"deadline_ms must be a positive number, "
                       f"got {deadline_ms!r}",
            )
            return
        try:
            # OverflowError: an out-of-range integer against a narrow
            # dtype (a 256 pixel under --device-featurize's uint8) is
            # a malformed REQUEST — 400, not a 500 + stack trace
            examples = [np.asarray(inst, dtype=dtype) for inst in instances]
        except (ValueError, TypeError, OverflowError) as e:
            self._send_error_json(400, "bad_request", detail=str(e))
            return
        # replay context for every log line this POST emits (including
        # the typed-shed/error lines in do_POST's handlers): what the
        # request WAS, so loadgen can reissue it
        self._log_meta = {
            "n_rows": len(examples),
            "shape": list(examples[0].shape),
            "deadline_ms": deadline_ms,
            "post_seq": next_post_seq(),
            "model": model_id,
        }
        if zoo is not None:
            # one drift observation per POST: the request's SIZE is its
            # instance count, the unit of the planner's histograms
            zoo.observe_request(model_id, len(examples))
        # admit every instance BEFORE waiting on any: concurrent
        # instances coalesce into shared micro-batch windows. Every
        # instance of one POST shares the POST's trace id — the span
        # trees of sibling instances interleave under one trace.
        futures = []
        try:
            for ex in examples:
                futures.append(
                    submit(
                        ex,
                        deadline_ms=deadline_ms,
                        trace_id=self._trace_id,
                    )
                )
        except Overloaded:
            # partial admission on a shed response: cancel what was
            # already admitted so the engines don't burn overload-time
            # cycles computing results this 429 discards
            for f in futures:
                f.cancel()
            raise  # -> do_POST's typed handler
        timeout = (
            deadline_ms / 1e3 + 5.0
            if deadline_ms is not None
            else RESULT_TIMEOUT_S
        )
        try:
            # the lanes resolve each future with the row as host numpy
            # (serving/pipeline.py resolve_window_futures), serial and
            # pipelined alike
            preds = [np.asarray(f.result(timeout=timeout)) for f in futures]
        except Overloaded:
            # one instance shed/expired -> whole response is an error:
            # cancel the siblings so engines don't compute answers this
            # response discards (same reason as the admission path above)
            for f in futures:
                f.cancel()
            raise
        except Exception as e:
            for f in futures:
                f.cancel()
            if self.server.request_log:  # type: ignore[attr-defined]
                self._log_request(
                    500, time.perf_counter() - self._t_post,
                    error=str(e),
                )
            self._send_error_json(500, "prediction_failed", detail=str(e))
            return
        if self.server.request_log:  # type: ignore[attr-defined]
            whole_post_s = time.perf_counter() - self._t_post
            for ex, f in zip(examples, futures):
                # per-request latency as the admission layer measured
                # it (rides the future) — iterating result() above
                # would charge every instance the wait on instance 0
                self._log_request(
                    200,
                    getattr(f, "latency_s", None) or whole_post_s,
                    lane=getattr(f, "lane_index", None),
                    trace_id=getattr(f, "trace_id", None),
                    n_rows=len(examples),
                    shape=ex.shape,
                    deadline_ms=deadline_ms,
                )
        self._send_json({"predictions": [p.tolist() for p in preds]})


class GatewayServer(BackgroundServer, device_obs.MemorySamplerHost):
    """The inference frontend over one ``Gateway`` or one ``ModelZoo``.
    ``start()`` binds and serves on a daemon thread; ``stop()`` shuts the
    listener down (the gateway itself drains via
    ``Gateway.close``/``/drain``)."""

    handler_cls = _Handler
    thread_name = "keystone-gateway-http"

    def __init__(
        self,
        gateway: Optional[Gateway] = None,
        port: int = 0,
        host: str = "127.0.0.1",
        registry=None,
        input_dtype: Any = np.float32,
        request_log: Any = False,
        chaos_routes: bool = True,
        zoo=None,
        lifecycle=None,
    ):
        """``request_log``: falsy = off; True = one JSON line per
        /predict instance on stdout; a path string = append the lines
        to that JSONL file, line-buffered. ``chaos_routes=False``
        removes the /chaosz fault-injection surface from this
        frontend (a production deployment that is not a chaos
        experiment shouldn't expose sabotage routes to anyone who
        can reach /predict). ``zoo`` (a ``ModelZoo``) replaces
        ``gateway``: /predict/<model> routes by id, bare /predict
        serves the default model with ITS input dtype, and /planz,
        /attributionz and /driftz answer from the zoo. ``lifecycle`` (a
        ``LifecycleManager``) turns on the online-lifecycle surface:
        ``POST /feedback`` streams labeled examples into the refit,
        ``GET /lifecyclez`` reports every model's refit→shadow→canary
        state, ``POST /lifecyclez`` forces a policy tick or a rollback
        (``serve-lifecycle``)."""
        if (gateway is None) == (zoo is None):
            raise ValueError(
                "GatewayServer wants exactly one of gateway= or zoo="
            )
        super().__init__(port=port, host=host)
        self.gateway = gateway
        self.zoo = zoo
        self.lifecycle = lifecycle
        self.registry = (
            registry if registry is not None else get_global_registry()
        )
        self.input_dtype = np.dtype(input_dtype)
        self._request_log = RequestLogWriter(request_log)
        self.request_log = self._request_log.enabled
        self.chaos_routes = bool(chaos_routes)
        # single-port deployments scrape THIS port: carry the device
        # identity gauge and the memory sampler here too, same as the
        # admin endpoint (refcounted — one thread per registry even
        # when both servers run in one process)
        device_obs.register_device_metrics(self.registry)

    def _configure(self, httpd) -> None:
        httpd.gateway = self.gateway
        httpd.zoo = self.zoo
        httpd.lifecycle = self.lifecycle
        httpd.registry = self.registry
        httpd.input_dtype = self.input_dtype
        httpd.request_log = self.request_log
        httpd.chaos_routes = self.chaos_routes
        httpd.write_request_log = self.write_request_log

    def write_request_log(self, line: dict) -> None:
        """One record to the request log (stdout or the file)."""
        self._request_log.write(line)

    def start(self) -> "GatewayServer":
        super().start()
        self._start_memory_sampler()
        return self

    def stop(self) -> None:
        self._stop_memory_sampler()
        super().stop()
        self._request_log.close()


def register_with_router(
    router_url: str,
    own_url: str,
    attempts: int = 30,
    interval_s: float = 1.0,
    cancel: Optional[threading.Event] = None,
    models=None,
) -> bool:
    """POST this gateway's base URL to a fleet router's ``/registerz``
    (``serve-gateway --register``). Retries: replicas and their router
    launch concurrently, so the router may not be listening yet — the
    registration is idempotent per URL, a later success is as good as
    a first one. ``cancel`` stops the retry loop: the retirement path
    sets it before deregistering, or a straggling retry could
    re-register a replica that is already exiting. ``models``
    advertises the zoo model ids this replica serves (zoo mode) so
    the router can route ``/predict/<model>`` to it."""
    from keystone_tpu_torch.fleet.client import REGISTER_ROUTE, post_roster

    for attempt in range(attempts):
        if cancel is not None and cancel.is_set():
            return False
        try:
            post_roster(
                router_url, REGISTER_ROUTE, own_url, timeout_s=10,
                models=models,
            )
            logger.info(
                "registered %s with router %s", own_url, router_url
            )
            return True
        except Exception as e:
            if attempt == attempts - 1:
                logger.warning(
                    "could not register with router %s after %d "
                    "attempts: %s", router_url, attempts, e,
                )
            if cancel is not None:
                if cancel.wait(interval_s):
                    return False
            else:
                time.sleep(interval_s)
    return False


def deregister_from_router(router_url: str, own_url: str) -> bool:
    """POST this gateway's base URL to a fleet router's
    ``/deregisterz`` — the exit half of ``register_with_router``. ONE
    short attempt (``fleet/client.try_deregister``): a dead router must
    not stall a process exit."""
    from keystone_tpu_torch.fleet.client import try_deregister

    return try_deregister(router_url, own_url, timeout_s=3.0)


def main(argv=None, device=None) -> int:
    """``python -m keystone_tpu_torch serve-gateway [--gateway-port N] ...``
    — stand up the request plane over the demo model (``serving/bench.py``
    ``build_pipeline``), with ``--refit`` the online lifecycle over it,
    over a featurize chain and the demo model with
    ``--device-featurize``, or over a model zoo with ``--zoo``, on
    ``device`` (``None`` means ``cuda``, which raises when it is missing;
    tests pass ``device="cpu"``)."""
    import argparse

    from keystone_tpu_torch._device import resolve_device
    from keystone_tpu_torch.serving.bench import build_pipeline

    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(
        prog="keystone_tpu_torch serve-gateway", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--gateway-port", "--port", dest="port", type=int,
                    default=0, help="bind port (0 = ephemeral)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--buckets", default="8,32,128")
    ap.add_argument("--lanes", type=int, default=2)
    ap.add_argument("--max-pending", type=int, default=1024)
    ap.add_argument("--max-delay-ms", type=float, default=5.0)
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="stage-queue depth of each lane's staged "
                    "pipeline (host-prep/upload/compute/deliver "
                    "overlap across windows); 0 = serial dispatch")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="default per-request deadline")
    ap.add_argument("--rebucket-interval", type=float, default=None,
                    help="seconds between autoscale/rebucket sweeps")
    ap.add_argument("--slo-latency-ms", type=float, default=None,
                    help="declare + enforce a latency SLO at this "
                    "threshold: burn-rate gauges + /slz, admission "
                    "tightening under sustained fast-window burn, and "
                    "tail-sampled forensics at /debugz (enables span "
                    "tracing)")
    ap.add_argument("--trace", action="store_true",
                    help="enable span tracing without declaring an "
                    "SLO: /tracez fills, inbound W3C traceparent "
                    "headers are adopted, and every /predict response "
                    "carries X-Keystone-Trace")
    ap.add_argument("--slo-target", type=float, default=0.99,
                    help="fraction of requests that must make the "
                    "latency threshold")
    ap.add_argument("--flight-capacity", type=int, default=64,
                    help="forensic ring size (requests)")
    ap.add_argument("--request-log", nargs="?", const=True,
                    default=False, metavar="FILE",
                    help="one structured JSON line per /predict "
                    "instance (status, latency_ms, lane, trace_id, "
                    "plus the n_rows/shape/deadline_ms replay fields). "
                    "Bare flag: stdout; with FILE: append line-buffered "
                    "JSONL there")
    ap.add_argument("--no-chaosz", action="store_true",
                    help="disable the /chaosz fault-injection routes "
                    "on this frontend (faults stay armable in-process "
                    "via code/env)")
    ap.add_argument("--register", action="append", default=[],
                    metavar="ROUTER_URL",
                    help="self-register this replica with a fleet "
                    "router (POST {url} to ROUTER_URL/registerz, "
                    "retried in the background; repeatable). The "
                    "router probes /readyz and scrapes /metrics from "
                    "then on; on SIGTERM the replica deregisters, then "
                    "drains")
    ap.add_argument("--advertise-url", default=None, metavar="URL",
                    help="the base URL to register (and for the "
                    "router to reach this replica at); the default "
                    "advertises the BIND address")
    ap.add_argument("--zoo", default=None, metavar="SPEC.json",
                    help="serve a MODEL ZOO instead of one model: a "
                    "JSON spec of named models (keystone_tpu_torch/zoo/"
                    "registry.py has the format). POST /predict/<model> "
                    "routes by id, bare /predict serves the spec's "
                    "default model, GET /planz reports plan-vs-actual. "
                    "Co-hosted models with IDENTICAL featurize chains "
                    "share one engine that computes the prefix once per "
                    "window, one CUDA graph per bucket. Ignores the "
                    "single-model flags (--d/--hidden/--depth/"
                    "--device-featurize/--buckets/--lanes)")
    ap.add_argument("--optimize", action="store_true",
                    help="with --zoo: run the placement optimizer "
                    "(zoo/optimizer.py) over the spec's expected-size "
                    "histograms, measured param bytes and the card's "
                    "memory, and host each model with the PLANNED "
                    "buckets/lanes")
    ap.add_argument("--max-resident", type=int, default=None,
                    metavar="N",
                    help="with --zoo: cap how many models hold engines "
                    "at once; over the cap the least-recently-used "
                    "unpinned model is evicted (drains in the background, "
                    "its graphs released) and pages back in on its next "
                    "request (default: all models resident)")
    ap.add_argument("--refit", action="store_true",
                    help="run the ONLINE MODEL LIFECYCLE over the "
                    "demo model: POST /feedback streams labeled "
                    "examples into an incremental normal-equations "
                    "refit of the model's head; each solved candidate "
                    "walks shadow -> canary -> promoted (atomic "
                    "engine swap) or auto-rolls back on the accuracy/"
                    "SLO gates. GET /lifecyclez reports the state "
                    "machine; serve-lifecycle drives it remotely. "
                    "Single-model mode only (not --zoo/"
                    "--device-featurize)")
    ap.add_argument("--refit-interval-s", type=float, default=2.0,
                    metavar="S",
                    help="with --refit: background policy-tick "
                    "period; 0 disables the thread (tick via POST "
                    "/lifecyclez, e.g. serve-lifecycle tick)")
    ap.add_argument("--refit-min-samples", type=int, default=256,
                    metavar="N",
                    help="with --refit: fresh feedback rows required "
                    "before a new candidate is solved")
    ap.add_argument("--canary-fraction", type=float, default=0.25,
                    metavar="F",
                    help="with --refit: deterministic fraction of "
                    "live requests the canary stage routes to the "
                    "candidate")
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--device-featurize", nargs="?", const="demo",
                    choices=("demo", "flagship"), default=None,
                    metavar="CHAIN",
                    help="serve RAW uint8 images instead of float32 "
                    "feature vectors: an image featurize chain "
                    "(serving/featurize.py) runs in front of the model "
                    "inside every bucket's CUDA graph, so /predict "
                    "instances are (--img, --img, 3) uint8 arrays (--d "
                    "is derived from the featurize output and ignored). "
                    "CHAIN: 'demo' (bare flag; the dense-conv stack, "
                    "default --img 16) or 'flagship' (the SIFT+LCS -> "
                    "PCA -> GMM Fisher vector DAG on the port's CUDA "
                    "kernels, default --img 64)")
    ap.add_argument("--img", type=int, default=None,
                    help="raw image edge length under "
                    "--device-featurize (default: 16 for the demo "
                    "chain, 64 for flagship)")
    ap.add_argument("--shard-model", action="store_true",
                    help="shard the MODEL over a (data, model) mesh of "
                    "the local devices (serving/sharding.py): the "
                    "default partition rules split every weight matrix "
                    "over the model axis, and each lane engine runs the "
                    "model on params it placed. On one card the model "
                    "axis has size 1 and every param is placed whole")
    ap.add_argument("--mesh-model", type=int, default=None,
                    metavar="N",
                    help="model-axis size under --shard-model "
                    "(default: all local devices); more than the host "
                    "has exits 1")
    ap.add_argument("--no-cache", action="store_true",
                    help="run with no AOT store, even if --aot-cache or "
                    "$KEYSTONE_AOT_CACHE names one")
    ap.add_argument("--aot-cache", default=None, metavar="DIR",
                    help="AOT store dir (serving/aot.py): kernel "
                    "libraries and each bucket's entry; pre-populate "
                    "with serve-aot-build. Default: $KEYSTONE_AOT_CACHE "
                    "when set, else no store. Ignored under --no-cache")
    args = ap.parse_args(argv)
    t_main = time.perf_counter()
    start_s = {"process_at_main": _process_age_s()}
    if args.refit and (args.zoo or args.device_featurize):
        print(
            "--refit wants the plain demo model (not --zoo / "
            "--device-featurize)",
            flush=True,
        )
        return 2
    dev = resolve_device(device)
    if dev.type == "cuda":
        # the CUDA context, apart from the model built on it
        t = time.perf_counter()
        torch.empty(1, device=dev)
        start_s["cuda_init"] = time.perf_counter() - t
    if not args.no_cache and (args.aot_cache or os.environ.get("KEYSTONE_AOT_CACHE")):
        from keystone_tpu_torch.serving.aot import setup_aot_cache

        setup_aot_cache(args.aot_cache)
    if args.shard_model:
        # pin the process mesh so every engine generation (first build,
        # rebuckets, swaps) places over the same (data, model) topology
        from keystone_tpu_torch.serving import sharding as sharding_lib

        devices = (sharding_lib.local_devices() if dev.type == "cuda"
                   else [torch.device("cpu")])
        try:
            mesh = sharding_lib.make_mesh(
                n_model=args.mesh_model or len(devices), devices=devices
            )
        except ValueError as e:
            print(json.dumps({"error": f"--mesh-model: {e}"}), flush=True)
            return 1
        sharding_lib.set_mesh(mesh)

    if args.slo_latency_ms is not None or args.trace:
        # the forensic chain (exemplars, flight records, burn gauges)
        # keys off trace ids, so SLO mode implies tracing
        from keystone_tpu_torch.observability import enable_tracing

        enable_tracing()

    featurize = None
    input_dtype = np.float32
    zoo = None
    gateway = None
    if args.zoo:
        from keystone_tpu_torch.zoo import ModelZoo, load_zoo_spec

        model_registry = load_zoo_spec(args.zoo, device=dev)
        zoo = ModelZoo(model_registry, max_resident=args.max_resident, device=dev)
        if args.optimize:
            from keystone_tpu_torch.observability.device import chip_hbm_bytes
            from keystone_tpu_torch.zoo.optimizer import ChipBudget, plan_placement

            # plan BEFORE hosting: profiles(build=True) materializes
            # params so params_nbytes is measured, not guessed; apply_plan
            # pins each profile's histogram as the drift baseline
            profiles = zoo.profiles(build=True)
            budget = ChipBudget(hbm_bytes=chip_hbm_bytes(), n_chips=1)
            zoo.apply_plan(
                plan_placement(profiles, budget),
                budget=budget,
                profiles=profiles,
            )
            print(json.dumps({"plan": zoo.plan.to_dict()}), flush=True)
        if args.max_resident is None:
            # everything resident up-front: one host() call, so CSE
            # groups form across the whole spec
            zoo.host()
        else:
            # capped: warm the pinned set + the default model now,
            # the rest page in on first request
            want = [s.model_id for s in model_registry if s.pinned]
            if model_registry.default_id not in want:
                want.append(model_registry.default_id)
            zoo.host(want)
    elif args.device_featurize:
        from keystone_tpu_torch.serving.featurize import (
            build_featurize_pipeline,
            build_flagship_featurize_pipeline,
        )

        if args.device_featurize == "flagship":
            args.img = args.img if args.img is not None else 64
            featurize, feat_d = build_flagship_featurize_pipeline(
                img=args.img, device=dev
            )
        else:
            args.img = args.img if args.img is not None else 16
            featurize, feat_d = build_featurize_pipeline(img=args.img, device=dev)
        args.d = feat_d  # the model consumes the featurize output
        warmup_example = torch.zeros((args.img, args.img, 3), dtype=torch.uint8)
        input_dtype = np.uint8
    refit_base = refit_head = None
    if zoo is None:
        if not args.device_featurize:
            warmup_example = torch.zeros((args.d,), dtype=torch.float32)
        if args.refit:
            # the SAME model build_pipeline serves (identical rng
            # draws, the same outputs), split at the last layer so the
            # lifecycle can refit the head in closed form and rebuild
            # candidates as base.and_then(affine_head(W, b))
            from keystone_tpu_torch.serving.bench import (
                affine_head,
                build_split_pipeline,
            )

            refit_base, head_w, head_b = build_split_pipeline(
                d=args.d, hidden=args.hidden, depth=args.depth, device=dev
            )

            def refit_head(W, b):
                return affine_head(W, b, device=dev)

            fitted = refit_base.and_then(refit_head(head_w, head_b))
        else:
            fitted = build_pipeline(
                d=args.d, hidden=args.hidden, depth=args.depth, device=dev
            )
        start_s["model"] = time.perf_counter() - t_main - start_s.get("cuda_init", 0.0)
        t_gateway = time.perf_counter()
        gateway = Gateway(
            fitted,
            buckets=tuple(int(b) for b in args.buckets.split(",")),
            n_lanes=args.lanes,
            max_delay_ms=args.max_delay_ms,
            pipeline_depth=args.pipeline_depth,
            device_featurize=featurize,
            device=dev,
            warmup_example=warmup_example,
            max_pending=args.max_pending,
            default_deadline_ms=args.deadline_ms,
            maintenance_interval_s=args.rebucket_interval,
            slo_latency_s=(
                args.slo_latency_ms / 1e3
                if args.slo_latency_ms is not None else None
            ),
            slo_target=args.slo_target,
            flight_capacity=args.flight_capacity,
            param_sharding=True if args.shard_model else None,
        )
        start_s["gateway"] = time.perf_counter() - t_gateway
        start_s.update(gateway.startup_s)
    if _cuda.BUILD_WALL_S:
        # nvcc's wall seconds: a gateway builds each library at its first
        # launch, one after another
        start_s["kernel_build"] = _cuda.BUILD_WALL_S
    plane = zoo if zoo is not None else gateway
    # chaos experiments can pre-arm fault points from the environment
    # (KEYSTONE_FAULTS="point=k:v,... ..."); absent env is a no-op.
    # This must run AFTER the Gateway exists: trigger points
    # (gateway.swap.force) disarm immediately when nothing has
    # registered for them, so arming before construction would be a
    # silent no-op.
    faults.arm_from_env()
    lifecycle = None
    if args.refit:
        from keystone_tpu_torch.lifecycle import LifecycleManager
        from keystone_tpu_torch.lifecycle.controller import LifecycleController

        lifecycle = LifecycleManager()
        lifecycle.add(
            LifecycleController(
                gateway,
                base=refit_base,
                head_builder=refit_head,
                feature_dim=args.hidden,
                out_dim=args.d,
                name="default",
                canary_fraction=args.canary_fraction,
                min_refit_samples=args.refit_min_samples,
                interval_s=args.refit_interval_s or None,
            ),
            default=True,
        )
    server = GatewayServer(
        gateway, port=args.port, host=args.host,
        input_dtype=input_dtype,
        request_log=args.request_log,
        chaos_routes=not args.no_chaosz,
        zoo=zoo,
        lifecycle=lifecycle,
    ).start()
    advertised = args.advertise_url or server.url().rstrip("/")
    # set on retirement, BEFORE deregistering: a registration retry that
    # outlives it must not re-add this replica to the roster
    cancel_registration = threading.Event()
    retire_lock = threading.Lock()

    def retire() -> None:
        """Leave every router's roster, then drain: the routers stop
        forwarding before this replica starts refusing with 503. Runs
        once; a second caller waits for the first."""
        with retire_lock:
            if cancel_registration.is_set():
                return
            cancel_registration.set()
            for router_url in args.register:
                deregister_from_router(router_url, advertised)
            if lifecycle is not None:
                # stop the refit/tick plane BEFORE draining the gateway:
                # a tick mid-drain would race swap_model against close()
                lifecycle.close()
            plane.close()

    def handle(signum, frame):
        logger.info("gateway: signal %d, deregistering and draining", signum)
        threading.Thread(target=retire, name="keystone-gateway-retire",
                         daemon=True).start()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, handle)
        except ValueError:
            pass  # not the main thread (embedded use)
    # the machine-parseable bound-address line FIRST: with --port 0
    # (ephemeral — no port races) smoke scripts read the actual
    # address off this one JSON line
    start_s["total"] = time.perf_counter() - t_main
    listening = {
        "listening": server.url().rstrip("/"),
        "role": "gateway",
        **({"models": list(zoo.registry.ids())} if zoo is not None else {}),
        "start_s": start_s,
    }
    if args.shard_model and gateway is not None:
        engine = gateway.pool.lanes[0].engine
        listening["mesh"] = sharding_lib.current_mesh().shape
        listening["sharding"] = {k: str(v) for k, v in engine.param_sharding.items()}
    print(json.dumps(listening), flush=True)
    zoo_routes = (
        "POST /predict/<model>, GET /planz, GET /attributionz, "
        "GET /driftz, " if zoo is not None else ""
    )
    lifecycle_routes = (
        "POST /feedback, GET|POST /lifecyclez, "
        if lifecycle is not None else ""
    )
    print(
        f"gateway: {server.url()} (POST /predict, {zoo_routes}"
        f"{lifecycle_routes}"
        "GET /readyz, GET /metrics, GET /slz, GET /debugz, "
        "GET /profilez, POST /swap, POST /drain, GET|POST /chaosz)",
        flush=True,
    )
    for router_url in args.register:
        # background: registration retries must not delay serving. Zoo
        # mode advertises the registry's model ids so the router can
        # route /predict/<model> here.
        threading.Thread(
            target=register_with_router,
            args=(router_url, advertised),
            kwargs={
                "cancel": cancel_registration,
                "models": list(zoo.registry.ids()) if zoo is not None else None,
            },
            name="keystone-gateway-register",
            daemon=True,
        ).start()
    try:
        while plane.ready:
            time.sleep(0.5)
    except KeyboardInterrupt:
        pass
    # a /drain or a signal ended the loop: finish the retirement (or
    # wait for the signal's), then stop the listener
    retire()
    server.stop()
    print(json.dumps({"drained": True, "launches": dict(_cuda.LAUNCHES)}), flush=True)
    return 0


def _process_age_s() -> Optional[float]:
    """Seconds since this process started (Linux ``/proc``), else None:
    what an interpreter start and the imports took before ``main``."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None
