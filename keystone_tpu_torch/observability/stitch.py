"""Cross-process trace stitching: one request, one forensic object
(counterpart of ``keystone_tpu/observability/stitch.py``, copied as it
is: the port's gateway, batcher and engine emit the span names and
attributes its phase decomposition reads).

The fleet made tracing multi-process: the router opens
``router.forward`` spans and sends a W3C ``traceparent`` downstream;
the replica adopts the trace id, so its ``gateway.admit →
microbatch.coalesce → serving.dispatch`` (or staged-pipeline) chain
rides the router's id — but the two halves live in two processes'
tracer rings. This module federates them back into ONE tree:

- ``TraceStitcher.stitch(trace_id, resolve_url)`` collects the
  router-side spans, reads which replicas served attempts off the
  ``router.forward`` spans' attrs, fetches each replica's
  ``GET /debugz?trace_id=`` (pinned flight records when the request
  was tail-sampled, the live tracer ring otherwise — see
  ``flight.debugz_status``), and grafts the replica's root spans under
  the router-hop span that carried them. Span ids are
  process-qualified (``router:17`` vs ``replica:host:port:17``) —
  the two processes' integer id counters collide by construction.
- The result renders as JSON (``to_dict``) or a Chrome trace-event
  document (``to_chrome_trace``) with one ``pid`` per process, so
  chrome://tracing / Perfetto shows the router hop and the replica's
  admit/coalesce/dispatch chain in one timeline.
- **Phase decomposition**: every stitched request is decomposed into
  ``router_hop / queue_wait / coalesce / device / deliver``
  milliseconds (see ``phase_decomposition`` for the exact span
  arithmetic) — the "where did this request's 40 ms go" answer — and
  each phase lands on the ``keystone_request_phase_seconds{phase=}``
  histogram, which federates through ``prometheus.merge_expositions``
  like every other ``le``-bucket family.
- **Partial traces are a feature, not a failure**: a replica that is
  unreachable, restarted (ring gone), or running with tracing off —
  or a forward whose ``traceparent`` was stripped by the
  ``router.trace.drop`` chaos point, leaving the replica to mint its
  own id — yields the router-side partial tree, marked
  ``partial: true`` with per-replica detail and counted on
  ``keystone_trace_stitch_partial_total{reason=}``.

Clock discipline: ``router_hop`` is computed as a DIFFERENCE of
durations (router-measured total minus the replica-measured span
envelope), never as a difference of two hosts' wall clocks, so modest
cross-host clock skew cannot turn the network hop negative. The Chrome
render does plot each process on its own wall clock — on one host
(tests, smoke) they align; across hosts skew shows as a visual offset
only.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import threading
import urllib.parse
import urllib.request
from typing import Any, Callable, Deque, Dict, List, Optional

from keystone_tpu_torch.observability.tracing import Tracer, get_tracer

logger = logging.getLogger(__name__)

# the decomposition's phase names, in pipeline order
PHASES = ("router_hop", "queue_wait", "coalesce", "device", "deliver")

# request phases span µs (a warm device dispatch) to seconds (a queue
# under overload): finer-than-default low buckets so sub-ms phases
# don't all land in one bin
PHASE_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
)

# traces whose phases were already observed onto the histogram: the
# stitcher remembers this many trace ids so repeated /debugz queries
# of one request don't multiply-count it
OBSERVED_TRACES_CAPACITY = 4096

# span names the decomposition keys on (the serving chain's contract)
_ADMIT = "gateway.admit"
_COALESCE = "microbatch.coalesce"
_DISPATCH = "serving.dispatch"
_FORWARD = "router.forward"
_PIPELINE_DEVICE = ("pipeline.upload", "pipeline.compute")


def _start(s: Dict[str, Any]) -> float:
    return float(s["start_s"])


def _end(s: Dict[str, Any]) -> float:
    return float(s["start_s"]) + float(s["duration_ms"]) / 1e3


def _dur_s(s: Dict[str, Any]) -> float:
    return float(s["duration_ms"]) / 1e3


def qualify_spans(
    spans: List[Dict[str, Any]], process: str
) -> List[Dict[str, Any]]:
    """Namespace one process's span dicts (``Span.to_dict`` shape) so
    they can share a tree with another process's: ids become
    ``<process>:<id>`` strings, a parent id that points outside the
    provided set (fell out of the ring, or a remote parent the replica
    recorded as an attr) degrades to a root."""
    ids = {s.get("span_id") for s in spans}
    out = []
    for s in spans:
        q = dict(s)
        q["process"] = process
        q["span_id"] = f"{process}:{s.get('span_id')}"
        parent = s.get("parent_id")
        q["parent_id"] = (
            f"{process}:{parent}" if parent in ids and parent is not None
            else None
        )
        out.append(q)
    return out


def phase_decomposition(
    spans: List[Dict[str, Any]], router_process: str
) -> Dict[str, Any]:
    """One stitched trace's spans -> the per-request latency
    decomposition. Phase definitions (all clamped >= 0):

    - ``total``      — the winning ``router.forward`` span's duration
                       (the request as the router measured it); with
                       no router spans, the whole-trace envelope.
    - ``router_hop`` — total minus the replica-side span envelope:
                       network + serialization + router overhead
                       (durations subtracted, never cross-host clocks).
    - ``queue_wait`` — first ``microbatch.coalesce`` start minus first
                       ``gateway.admit`` start: admission-queue time
                       before a window opened for this request.
    - ``coalesce``   — window formation: with a dispatch span present
                       (serial lanes — where the REAL coalesce span
                       ENCLOSES the dispatch it triggers), first
                       dispatch start minus first coalesce start, so
                       device time is never counted twice; with
                       staged lanes, the coalesce span's own duration
                       (it ends at the pipeline handoff).
    - ``device``     — ``serving.dispatch`` (serial lanes) or
                       ``pipeline.upload`` + ``pipeline.compute``
                       (staged lanes): H2D + device compute.
    - ``deliver``    — the remainder (result download, future
                       resolution, response write): total minus every
                       phase above. Defined as the remainder so the
                       phases PARTITION the request — what is not
                       attributable to a named span is delivery-side
                       by construction, and the acceptance check
                       "phases sum ≈ measured latency" stays honest
                       because every OTHER phase is span-measured.

    Multi-window traces (a multi-instance POST split across windows)
    use the widest window per phase — the request resolves when its
    slowest instance does."""
    router = [s for s in spans if s.get("process") == router_process]
    remote = [s for s in spans if s.get("process") != router_process]
    forwards = [s for s in router if s.get("name") == _FORWARD]
    if forwards:
        # attempts are recorded in order; the last sibling is the one
        # that produced the response the client saw
        total_s = _dur_s(forwards[-1])
        # the envelope/queue arithmetic below must read ONE process's
        # clock: a retried trace can carry spans from a failed attempt
        # on ANOTHER replica host, and mixing two hosts' wall clocks
        # would turn their skew into phantom queue time — restrict the
        # remote side to the WINNING attempt's replica
        win = (forwards[-1].get("attrs") or {}).get("replica")
        if win:
            # possibly empty (the winner's half is missing): phases
            # then degrade to hop-only rather than decomposing the
            # winning request with a FAILED attempt's spans
            remote = [
                s for s in remote
                if s.get("process") == f"replica:{win}"
            ]
    elif spans:
        total_s = max(_end(s) for s in spans) - min(
            _start(s) for s in spans
        )
    else:
        return {"total_ms": None, "phases_ms": {}}

    def named(name: str) -> List[Dict[str, Any]]:
        return [s for s in remote if s.get("name") == name]

    admits = named(_ADMIT)
    coalesces = named(_COALESCE)
    dispatches = named(_DISPATCH)
    if not remote:
        # router-side partial: the hop is all that was MEASURED. The
        # replica phases are unknown, not zero — absent, so a partial
        # stitch can never drag the federated phase quantiles toward
        # zero (the repo's absent-not-zero doctrine)
        return {
            "total_ms": round(total_s * 1e3, 3),
            "phases_ms": {"router_hop": round(total_s * 1e3, 3)},
        }
    phases = dict.fromkeys(PHASES, 0.0)
    if remote:
        envelope = max(_end(s) for s in remote) - min(
            _start(s) for s in remote
        )
        phases["router_hop"] = max(0.0, total_s - envelope) if forwards else 0.0
        if admits and coalesces:
            phases["queue_wait"] = max(
                0.0,
                min(_start(s) for s in coalesces)
                - min(_start(s) for s in admits),
            )
        if coalesces:
            if dispatches:
                # serial lanes: the live coalesce span ENCLOSES the
                # dispatch it triggers (batching.py applies the engine
                # inside the with block) — formation time is up to the
                # dispatch start, or device time would count twice
                phases["coalesce"] = max(
                    0.0,
                    min(_start(s) for s in dispatches)
                    - min(_start(s) for s in coalesces),
                )
            else:
                phases["coalesce"] = max(_dur_s(s) for s in coalesces)
        if dispatches:
            phases["device"] = max(_dur_s(s) for s in dispatches)
        else:
            stage_device = [
                s for s in remote if s.get("name") in _PIPELINE_DEVICE
            ]
            if stage_device:
                phases["device"] = sum(
                    _dur_s(s) for s in stage_device
                )
        phases["deliver"] = max(
            0.0,
            total_s
            - phases["router_hop"]
            - phases["queue_wait"]
            - phases["coalesce"]
            - phases["device"],
        )
    return {
        "total_ms": round(total_s * 1e3, 3),
        "phases_ms": {
            k: round(v * 1e3, 3) for k, v in phases.items()
        },
    }


@dataclasses.dataclass
class StitchedTrace:
    """One cross-process trace: identity, the grafted span forest,
    which processes contributed, the phase decomposition, and whether
    any replica's half is missing (with per-replica detail)."""

    trace_id: str
    spans: List[Dict[str, Any]]
    processes: List[str]
    partial: bool
    partial_detail: List[str]
    phases: Dict[str, Any]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "processes": list(self.processes),
            "partial": self.partial,
            "partial_detail": list(self.partial_detail),
            "total_ms": self.phases.get("total_ms"),
            "phases_ms": self.phases.get("phases_ms", {}),
            "spans": list(self.spans),
        }

    def to_chrome_trace(self) -> Dict[str, Any]:
        """The stitched tree as Chrome trace-event JSON: one ``pid``
        per PROCESS (named via ``process_name`` metadata events), so
        Perfetto lays the router hop and the replica chain out as the
        separate processes they are — under one trace."""
        pids = {p: i for i, p in enumerate(self.processes)}
        events: List[Dict[str, Any]] = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": process},
            }
            for process, pid in pids.items()
        ]
        for s in self.spans:
            events.append(
                {
                    "name": s.get("name"),
                    "ph": "X",
                    "ts": _start(s) * 1e6,
                    "dur": float(s.get("duration_ms", 0.0)) * 1e3,
                    "pid": pids.get(s.get("process"), 0),
                    "tid": s.get("thread_id", 0),
                    "args": {
                        **dict(s.get("attrs") or {}),
                        "span_id": s.get("span_id"),
                        "parent_id": s.get("parent_id"),
                        "trace_id": self.trace_id,
                    },
                }
            )
        return {"traceEvents": events, "displayTimeUnit": "ms"}


class TraceStitcher:
    """The router's stitch engine over its own tracer + the fleet's
    ``/debugz`` surfaces. Owns the phase histogram and the
    partial-stitch counter so every ``/debugz?trace_id=`` served by
    the router also feeds the federated metrics plane."""

    def __init__(
        self,
        *,
        name: str = "router",
        tracer: Optional[Tracer] = None,
        registry=None,
        fetch_timeout_s: float = 5.0,
    ):
        self.name = name
        self._tracer = tracer
        self.fetch_timeout_s = float(fetch_timeout_s)
        if registry is None:
            from keystone_tpu_torch.observability.registry import (
                get_global_registry,
            )

            registry = get_global_registry()
        self._phases = registry.histogram(
            "keystone_request_phase_seconds",
            "per-request end-to-end latency decomposition from "
            "stitched cross-process traces, by phase",
            ("phase",),
            buckets=PHASE_BUCKETS,
        )
        self._partials = registry.counter(
            "keystone_trace_stitch_partial_total",
            "stitches missing a replica's half of the trace, by why "
            "(unreachable scrape, no spans at the replica, unknown "
            "replica)",
            ("reason",),
        )
        # the histogram is PER-REQUEST: only the first stitch of a
        # trace observes its phases, or a human re-querying /debugz
        # would skew the family toward investigated requests
        self._observed: set = set()  # guarded-by: _observed_lock
        self._observed_order: Deque[str] = (
            collections.deque()
        )  # guarded-by: _observed_lock
        self._observed_lock = threading.Lock()

    @property
    def tracer(self) -> Tracer:
        return self._tracer if self._tracer is not None else get_tracer()

    # -- replica fetch ------------------------------------------------------

    def _fetch_debugz(self, url: str, trace_id: str) -> Dict[str, Any]:
        with urllib.request.urlopen(
            url.rstrip("/")
            + "/debugz?trace_id="
            + urllib.parse.quote(trace_id),
            timeout=self.fetch_timeout_s,
        ) as resp:
            return json.loads(resp.read())

    @staticmethod
    def _replica_spans(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Span dicts out of one replica ``/debugz`` document: the
        live-ring ``spans`` plus any pinned records' trees, deduped by
        span id (a tail-sampled request appears in both)."""
        seen = set()
        out: List[Dict[str, Any]] = []
        span_lists = [doc.get("spans") or []]
        for record in doc.get("records") or []:
            span_lists.append(record.get("spans") or [])
        for spans in span_lists:
            for s in spans:
                sid = s.get("span_id")
                if sid in seen:
                    continue
                seen.add(sid)
                out.append(s)
        return out

    # -- the stitch ---------------------------------------------------------

    def stitch(
        self,
        trace_id: str,
        resolve_url: Callable[[str], Optional[str]],
    ) -> Optional[StitchedTrace]:
        """Build the stitched trace, or None when this router's ring
        holds nothing for ``trace_id`` (unknown/lapped trace — the
        HTTP layer 404s). ``resolve_url`` maps a replica NAME (the
        ``router.forward`` span's ``replica`` attr) to its base URL —
        the registry lookup, so the stitch only ever dials replicas
        the fleet actually knows."""
        # the ROUTER-origin spans of this trace: router spans stamp a
        # ``router=<name>`` attr at creation. In a real router process
        # this filter is a no-op (its ring holds nothing else for the
        # trace); with a SHARED tracer (in-process tests, the bench
        # A/B rig) it is what keeps the replica's admit/coalesce chain
        # from double-counting as router-side spans.
        own = [
            s.to_dict()
            for s in self.tracer.spans_for_trace(trace_id)
            if (s.attrs or {}).get("router") == self.name
        ]
        local = qualify_spans(own, self.name)
        if not local:
            return None
        # identity of the router's own spans, so a replica /debugz
        # that shares this process's tracer echoing them back cannot
        # masquerade them as replica-side spans. Raw span ids alone
        # can't be the key — two real processes both count from 1 —
        # but a full (id, name, start, duration, thread) match across
        # processes is impossible outside the shared-tracer case.
        local_keys = {
            (
                s.get("span_id"), s.get("name"), s.get("start_s"),
                s.get("duration_ms"), s.get("thread_id"),
            )
            for s in own
        }
        forwards = [s for s in local if s.get("name") == _FORWARD]
        replica_names: List[str] = []
        for s in forwards:
            rname = (s.get("attrs") or {}).get("replica")
            if rname and rname not in replica_names:
                replica_names.append(rname)
        spans = list(local)
        processes = [self.name]
        partial_detail: List[str] = []
        for rname in replica_names:
            url = resolve_url(rname)
            if not url:
                partial_detail.append(f"{rname}: not in the registry")
                self._partials.inc(("unknown_replica",))
                continue
            try:
                doc = self._fetch_debugz(url, trace_id)
            except Exception as e:
                partial_detail.append(
                    f"{rname}: /debugz fetch failed "
                    f"({type(e).__name__}: {e})"
                )
                self._partials.inc(("unreachable",))
                continue
            raw = [
                s
                for s in self._replica_spans(doc)
                if (
                    s.get("span_id"), s.get("name"), s.get("start_s"),
                    s.get("duration_ms"), s.get("thread_id"),
                )
                not in local_keys
            ]
            if not raw:
                # the replica answered but holds nothing under this
                # id: ring lapped, process restarted, tracing off, or
                # the traceparent was dropped on the forward path
                # (router.trace.drop) and the replica self-minted
                partial_detail.append(
                    f"{rname}: no spans for this trace (ring lapped, "
                    "restarted, tracing off, or traceparent dropped)"
                )
                self._partials.inc(("no_spans",))
                continue
            process = f"replica:{rname}"
            qualified = qualify_spans(raw, process)
            # graft: the replica's roots hang under the LAST router
            # hop that dialed it (the attempt that carried them)
            anchor = next(
                (
                    s["span_id"]
                    for s in reversed(forwards)
                    if (s.get("attrs") or {}).get("replica") == rname
                ),
                None,
            )
            for s in qualified:
                if s["parent_id"] is None and anchor is not None:
                    s["parent_id"] = anchor
                    s["grafted"] = True
            spans.extend(qualified)
            processes.append(process)
        phases = phase_decomposition(spans, self.name)
        with self._observed_lock:
            first_stitch = trace_id not in self._observed
            if first_stitch:
                self._observed.add(trace_id)
                self._observed_order.append(trace_id)
                while len(self._observed_order) > OBSERVED_TRACES_CAPACITY:
                    self._observed.discard(
                        self._observed_order.popleft()
                    )
        if first_stitch:
            for phase, ms in phases.get("phases_ms", {}).items():
                self._phases.observe(
                    ms / 1e3, (phase,), trace_id=trace_id
                )
        return StitchedTrace(
            trace_id=trace_id,
            spans=spans,
            processes=processes,
            partial=bool(partial_detail),
            partial_detail=partial_detail,
            phases=phases,
        )

    def document(
        self,
        trace_id: Optional[str],
        fmt: str,
        resolve_url: Callable[[str], Optional[str]],
    ) -> tuple:
        """The router's ``/debugz`` routing -> ``(status, json_doc)``,
        mirroring ``flight.debugz_document``'s shape: JSON stitched
        tree by default, the cross-process Chrome trace with
        ``format=chrome``."""
        if not trace_id:
            return 400, {
                "error": "the router's /debugz stitches one trace: "
                "pass ?trace_id= (find ids in X-Keystone-Trace "
                "response headers, /tracez, or a --request-log)"
            }
        stitched = self.stitch(trace_id, resolve_url)
        if stitched is None:
            return 404, {
                "error": f"no spans for trace {trace_id} in this "
                "router's ring (lapped, or tracing is off)"
            }
        if fmt == "chrome":
            return 200, stitched.to_chrome_trace()
        return 200, stitched.to_dict()


__all__ = [
    "PHASES",
    "PHASE_BUCKETS",
    "StitchedTrace",
    "TraceStitcher",
    "phase_decomposition",
    "qualify_spans",
]
