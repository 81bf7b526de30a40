"""Request traces: parse the gateway's ``--request-log`` and
synthesize open-loop workloads (counterpart of
``keystone_tpu/loadgen/trace.py``; numpy only).

**Recorded traces.** The gateway frontend emits one structured JSON
line per ``/predict`` instance (``gateway/http.py _log_request``),
carrying ``n_rows`` (how many instances rode the originating POST),
``shape`` (that instance's example shape) and ``deadline_ms`` — the
fields a replayer needs to reconstruct the request, not just observe
its outcome.
``parse_request_log`` tolerates the old format (ts/status/latency_ms/
lane/trace_id only): such lines replay as single-instance requests of
a caller-chosen default shape. ``collapse_posts`` folds the
one-line-per-instance records back into one event per POST (runs of
``n_rows`` adjacent lines sharing shape/deadline/timestamp), so a
replay issues the same requests the clients did rather than one POST
per instance.

**Synthetic workloads.** Open-loop arrival processes in the MLPerf
Inference LoadGen tradition (Reddi et al.): requests are issued on the
generator's clock, never paced by responses, so overload actually
overloads. Arrivals: ``poisson`` (exponential gaps — the memoryless
baseline), ``lognormal`` and ``pareto`` (heavy-tail burstiness, the
production shape padding/batching decisions must survive). Request
sizes draw from an explicit mixture (``size_mix``), deadlines from a
fixed value with optional lognormal jitter. Everything is seeded —
the same spec replays bit-identically."""

from __future__ import annotations

import dataclasses
import json
import logging
import math
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

# lines from one POST land within this window; collapse_posts uses it
# to stop a run that merely LOOKS contiguous (same shape/deadline) but
# came from requests seconds apart
_POST_WINDOW_S = 0.05


@dataclasses.dataclass
class TraceEvent:
    """One replayable request: issue ``n_rows`` instances of ``shape``
    at ``ts`` (seconds; relative once normalized) with ``deadline_ms``.
    The recorded-outcome fields (status/latency/lane/trace id) ride
    along for analysis but don't drive the replay."""

    ts: float
    n_rows: int = 1
    shape: Optional[Tuple[int, ...]] = None
    deadline_ms: Optional[float] = None
    status: Optional[int] = None
    latency_ms: Optional[float] = None
    lane: Optional[int] = None
    trace_id: Optional[str] = None
    post_seq: Optional[Any] = None  # shared by lines of one POST
    # (opaque id — a "nonce-counter" string from the gateway)
    # fleet-tier fields (serve-router --request-log): which replica
    # served the POST and how many forward attempts it took — ride
    # along for analysis, don't drive the replay
    replica: Optional[str] = None
    attempts: Optional[int] = None
    # zoo mode: the named model that served the instance (None on the
    # bare single-model route). This one DOES drive the replay — the
    # HTTP target POSTs /predict/<model> when set, so a recorded
    # multi-model mix replays against the same per-model lanes
    model: Optional[str] = None


def parse_request_log_line(line: str) -> Optional[TraceEvent]:
    """One ``--request-log`` line -> event, or None for non-record
    lines (startup banners, blank lines, foreign log output)."""
    line = line.strip()
    if not line.startswith("{"):
        return None
    try:
        doc = json.loads(line)
    except ValueError:
        return None
    if not isinstance(doc, dict) or "ts" not in doc:
        return None
    if doc.get("path") not in (None, "/predict"):
        return None
    shape = doc.get("shape")
    if shape is not None:
        try:
            shape = tuple(int(s) for s in shape)
        except (TypeError, ValueError):
            shape = None
    try:
        return TraceEvent(
            ts=float(doc["ts"]),
            # old-format lines (pre-loadgen) have none of these three:
            # a 1-instance default-shape event is the degraded replay
            n_rows=int(doc.get("n_rows", 1)),
            shape=shape,
            deadline_ms=doc.get("deadline_ms"),
            status=doc.get("status"),
            latency_ms=doc.get("latency_ms"),
            lane=doc.get("lane"),
            trace_id=doc.get("trace_id"),
            post_seq=doc.get("post_seq"),
            replica=doc.get("replica"),
            attempts=doc.get("attempts"),
            model=doc.get("model"),
        )
    except (TypeError, ValueError):
        return None


def parse_request_log(lines: Iterable[str]) -> List[TraceEvent]:
    """Every parseable record line, one event per line (per recorded
    instance). Feed through ``collapse_posts`` to restore per-POST
    granularity for replay."""
    events = []
    for line in lines:
        ev = parse_request_log_line(line)
        if ev is not None:
            events.append(ev)
    return events


def collapse_posts(events: Sequence[TraceEvent]) -> List[TraceEvent]:
    """Fold per-instance lines back into per-POST events, one event
    of ``n_rows`` instances per POST. Lines carrying a ``post_seq``
    (every line since this subsystem landed) dedupe by that id — the
    robust path, immune to concurrent handler threads interleaving
    their lines in the file. Lines WITHOUT a post_seq (hand-authored
    or foreign traces that state ``n_rows`` but no id) fall back to
    adjacency: a run of up to ``n_rows`` neighboring lines sharing
    (n_rows, shape, deadline_ms) within one post window. Shed/error
    POSTs logged a single line and still collapse to one full-size
    event — the replay reissues the whole request, which is the
    point."""
    out: List[TraceEvent] = []
    seen_seq = set()
    i = 0
    n = len(events)
    while i < n:
        head = events[i]
        if head.post_seq is not None:
            if head.post_seq not in seen_seq:
                seen_seq.add(head.post_seq)
                out.append(head)
            i += 1
            continue
        run = 1
        while (
            run < head.n_rows
            and i + run < n
            and events[i + run].post_seq is None
            and events[i + run].n_rows == head.n_rows
            and events[i + run].shape == head.shape
            and events[i + run].deadline_ms == head.deadline_ms
            and events[i + run].model == head.model
            and events[i + run].ts - head.ts <= _POST_WINDOW_S
        ):
            run += 1
        out.append(head)
        i += run
    return out


def load_trace(path: str, collapse: bool = True) -> List[TraceEvent]:
    """Parse a ``--request-log`` JSONL file into replayable events
    (per-POST by default), timestamps normalized to start at 0.
    ``collapse=False`` replays ONE single-instance request per
    recorded line — n_rows is reset to 1, because keeping the
    per-POST count on every one of its per-instance lines would
    multiply the offered load by n_rows."""
    with open(path, "r", encoding="utf-8") as f:
        events = parse_request_log(f)
    if collapse:
        events = collapse_posts(events)
    else:
        events = [
            dataclasses.replace(e, n_rows=1) for e in events
        ]
    return normalize(events)


def normalize(events: Sequence[TraceEvent]) -> List[TraceEvent]:
    """Sort by timestamp and rebase so the first event is at t=0 (the
    replayer's clock is relative)."""
    events = sorted(events, key=lambda e: e.ts)
    if not events:
        return []
    t0 = events[0].ts
    return [dataclasses.replace(e, ts=e.ts - t0) for e in events]


# -- synthetic workloads ---------------------------------------------------

ARRIVALS = ("poisson", "lognormal", "pareto", "uniform")


def _inter_arrivals(
    rng: np.random.Generator,
    n: int,
    arrivals: str,
    rate: float,
    sigma: float,
    alpha: float,
) -> np.ndarray:
    """``n`` gaps with mean 1/rate under the named process."""
    mean_gap = 1.0 / rate
    if arrivals == "poisson":
        return rng.exponential(mean_gap, n)
    if arrivals == "lognormal":
        # E[LN(mu, sigma)] = exp(mu + sigma^2/2) = mean_gap
        mu = np.log(mean_gap) - sigma * sigma / 2.0
        return rng.lognormal(mu, sigma, n)
    if arrivals == "pareto":
        if alpha <= 1.0:
            raise ValueError(
                f"pareto arrivals need alpha > 1 for a finite mean "
                f"gap, got {alpha}"
            )
        # Lomax+shift: gap = xm * (1 + Pareto(alpha)); E = xm*alpha/(alpha-1)
        xm = mean_gap * (alpha - 1.0) / alpha
        return xm * (1.0 + rng.pareto(alpha, n))
    if arrivals == "uniform":
        return np.full(n, mean_gap)
    raise ValueError(
        f"unknown arrival process {arrivals!r} (have {ARRIVALS})"
    )


def synthesize(
    n_requests: int,
    *,
    arrivals: str = "poisson",
    rate: float = 100.0,
    size_mix: Sequence[Tuple[int, float]] = ((1, 1.0),),
    shape: Sequence[int] = (8,),
    deadline_ms: Optional[float] = None,
    deadline_sigma: float = 0.0,
    sigma: float = 1.0,
    alpha: float = 1.5,
    seed: int = 0,
) -> List[TraceEvent]:
    """``n_requests`` synthetic events: arrival gaps from the named
    process at ``rate`` req/s, per-request instance counts drawn from
    ``size_mix`` ((n_rows, weight) pairs), a fixed per-example
    ``shape``, and deadlines of ``deadline_ms`` with optional
    lognormal jitter (``deadline_sigma``). Deterministic per seed."""
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    rng = np.random.default_rng(seed)
    gaps = _inter_arrivals(rng, n_requests, arrivals, rate, sigma, alpha)
    ts = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    return _events_at(
        rng, ts, size_mix, shape, deadline_ms, deadline_sigma
    )


def _events_at(
    rng: np.random.Generator,
    ts: np.ndarray,
    size_mix: Sequence[Tuple[int, float]],
    shape: Sequence[int],
    deadline_ms: Optional[float],
    deadline_sigma: float,
) -> List[TraceEvent]:
    """Dress arrival instants with sizes/deadlines — the shared tail
    of ``synthesize`` and ``synthesize_steps``."""
    n_requests = len(ts)
    sizes = np.asarray([int(s) for s, _ in size_mix])
    weights = np.asarray([float(w) for _, w in size_mix], np.float64)
    if (weights <= 0).any():
        raise ValueError(f"size_mix weights must be > 0: {list(size_mix)}")
    weights = weights / weights.sum()
    n_rows = rng.choice(sizes, size=n_requests, p=weights)
    deadlines: List[Optional[float]] = [deadline_ms] * n_requests
    if deadline_ms is not None and deadline_sigma > 0:
        mu = np.log(deadline_ms) - deadline_sigma**2 / 2.0
        deadlines = [
            float(d)
            for d in rng.lognormal(mu, deadline_sigma, n_requests)
        ]
    return [
        TraceEvent(
            ts=float(ts[i]),
            n_rows=int(n_rows[i]),
            shape=tuple(int(s) for s in shape),
            deadline_ms=deadlines[i],
        )
        for i in range(n_requests)
    ]


def synthesize_steps(
    steps: Sequence[Tuple[float, float]],
    *,
    arrivals: str = "poisson",
    size_mix: Sequence[Tuple[int, float]] = ((1, 1.0),),
    shape: Sequence[int] = (8,),
    deadline_ms: Optional[float] = None,
    deadline_sigma: float = 0.0,
    sigma: float = 1.0,
    alpha: float = 1.5,
    seed: int = 0,
) -> List[TraceEvent]:
    """A STEP/RAMP offered-load shape: ``steps`` is ``[(rate,
    duration_s), ...]`` and each step issues arrivals from the named
    process at its own rate for its own duration — the deterministic
    load staircase the scale-out drills and the capacity planner
    script against a fleet (a ramp is just many small steps). A
    ``(0, duration)`` step is a silence — the idle tail a scale-down
    drill needs. Deterministic per seed, like ``synthesize``.

    The open-loop replayer treats the result identically to any
    other trace: arrivals on the generator's clock, never paced by
    responses, so the high step genuinely overloads an under-scaled
    fleet."""
    if not steps:
        raise ValueError("synthesize_steps needs at least one step")
    expected = sum(
        float(rate) * float(dur) for rate, dur in steps
        if math.isfinite(float(rate)) and math.isfinite(float(dur))
    )
    if expected > 2_000_000:
        # --synthetic bounds the event count explicitly; the
        # staircase must too — a typo'd rate must fail loud, not
        # allocate the host away before the replay starts
        raise ValueError(
            f"steps {list(steps)} expect ~{expected:.0f} arrivals; "
            "bound the workload under 2e6 events"
        )
    rng = np.random.default_rng(seed)
    ts: List[float] = []
    t0 = 0.0
    for rate, duration_s in steps:
        rate, duration_s = float(rate), float(duration_s)
        if not math.isfinite(duration_s) or duration_s <= 0:
            raise ValueError(
                f"step durations must be finite and > 0, got "
                f"{duration_s}"
            )
        if not math.isfinite(rate) or rate < 0:
            raise ValueError(
                f"step rates must be finite and >= 0, got {rate}"
            )
        if rate > 0:
            # draw in generously-sized batches until the step is
            # covered (heavy-tail processes can exhaust a single
            # batch before the step's clock runs out) — the sequence
            # of draws is still seeded-deterministic
            expect = max(1, int(rate * duration_s))
            draw = expect + max(8, int(4 * math.sqrt(expect)))
            t = t0
            end = t0 + duration_s
            while t < end:
                gaps = _inter_arrivals(
                    rng, draw, arrivals, rate, sigma, alpha
                )
                for gap in gaps:
                    t += float(gap)
                    if t >= end:
                        break
                    ts.append(t)
        t0 += duration_s
    if not ts:
        raise ValueError(
            f"steps {list(steps)} produced no arrivals (rates too "
            "low for their durations)"
        )
    return _events_at(
        rng,
        np.asarray(ts),
        size_mix,
        shape,
        deadline_ms,
        deadline_sigma,
    )


def parse_steps(spec: str) -> List[Tuple[float, float]]:
    """CLI step spec ``"rate:duration,..."`` (e.g. ``"5:4,40:8,5:6"``:
    4 s at 5 rps, 8 s at 40 rps, 6 s back at 5 rps) ->
    ``[(rate, duration_s), ...]`` for ``synthesize_steps``."""
    steps = []
    for part in spec.split(","):
        rate, sep, duration = part.partition(":")
        if not sep:
            raise ValueError(
                f"bad step entry {part!r} (want rate:duration_s)"
            )
        steps.append((float(rate), float(duration)))
    if not steps:
        raise ValueError("empty step spec")
    return steps


def parse_size_mix(spec: str) -> List[Tuple[int, float]]:
    """CLI mixture spec ``"1:0.8,4:0.15,16:0.05"`` ->
    [(n_rows, weight), ...]."""
    mix = []
    for part in spec.split(","):
        rows, sep, weight = part.partition(":")
        if not sep:
            raise ValueError(
                f"bad size-mix entry {part!r} (want rows:weight)"
            )
        mix.append((int(rows), float(weight)))
    if not mix:
        raise ValueError("empty size mix")
    return mix


def summarize(events: Sequence[TraceEvent]) -> Dict[str, Any]:
    """Quick shape-of-the-workload stats (the CLI prints this before a
    run so an operator can sanity-check a trace)."""
    if not events:
        return {"requests": 0}
    gaps = np.diff([e.ts for e in events])
    rows = np.asarray([e.n_rows for e in events])
    return {
        "requests": len(events),
        "duration_s": round(float(events[-1].ts - events[0].ts), 3),
        "instances": int(rows.sum()),
        "mean_gap_ms": (
            round(float(gaps.mean()) * 1e3, 3) if len(gaps) else None
        ),
        "p99_gap_ms": (
            round(float(np.percentile(gaps, 99)) * 1e3, 3)
            if len(gaps) else None
        ),
        "size_counts": {
            str(int(s)): int((rows == s).sum()) for s in np.unique(rows)
        },
        "with_deadline": int(
            sum(1 for e in events if e.deadline_ms is not None)
        ),
    }


__all__ = [
    "ARRIVALS",
    "TraceEvent",
    "collapse_posts",
    "load_trace",
    "normalize",
    "parse_request_log",
    "parse_request_log_line",
    "parse_size_mix",
    "parse_steps",
    "summarize",
    "synthesize",
    "synthesize_steps",
]
