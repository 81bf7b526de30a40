"""Per-model device-cost attribution: WHO is spending the fleet
(counterpart of ``keystone_tpu/observability/attribution.py``, copied
as it is).

Every serving counter so far answers "what did this engine do"; nothing
answers "which model (tenant) caused it" — the number the placement
planner's re-plan loop and any multi-tenant QoS policy need as
evidence. The ``AttributionLedger`` is that answer: a per-model account
of device seconds, modeled FLOPs, H2D bytes, goodput vs padded rows and
dispatch counts, fed from the same ``record_dispatch`` facts the
engine-level counters read, so the two surfaces can never tell
different stories.

Solo engines charge their one model everything. Shared-prefix engines
(``zoo/cse.py``) need the *fair-split* rule: each dispatched window ran
one shared featurize prefix plus every co-resident model's head, so the
prefix's modeled cost (its own cost model, vs the heads') is
apportioned across the window's models **by row share**, and each
head's cost goes to its own model. The per-window weights are
normalized against the ENGINE's dispatch totals, so per-model charges
sum exactly to the engine totals — the invariant the tests and the
pin at 1e-6 relative. Engines whose prefix/head cost models are
absent (a bucket before its counted run, ``zoo/cse.py``) degrade to
pure row-share splitting — still exactly summing, just less informed.

Exported two ways, same numbers:
- ``keystone_attr_*{model}`` Prometheus families (``register()``) —
  absent-not-zero like every degradable series here, and federated
  across the fleet by the existing ``merge_expositions`` sum path
  (identical model labels across replicas add, which IS fleet truth
  for these counters);
- the ``GET /attributionz`` document (``attribution_document``) —
  per-model device-seconds share, a $/FLOP-style normalized cost
  (device seconds per modeled GFLOP), and a top-k spender table. The
  router builds the SAME document from its federated scrape
  (``attribution_from_samples``) so its ``/attributionz`` is
  fleet-truth, not router-local.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

# the ledger's additive per-model cells, in export order; every one is
# a lifetime total (monotonic -> Prometheus counters)
CELL_FIELDS = (
    "device_seconds",
    "device_flops",
    "h2d_bytes",
    "goodput_rows",
    "padded_rows",
    "dispatches",
)

_COUNTER_HELP = {
    "device_seconds": "device wall seconds attributed to the model "
    "(completion-timed dispatches, fair-split over shared engines)",
    "device_flops": "modeled device FLOPs attributed to the model "
    "(shared featurize prefixes split by row share)",
    "h2d_bytes": "host-to-device bytes attributed to the model "
    "(padding included, split by row share on shared engines)",
    "goodput_rows": "valid (non-padding) rows served for the model",
    "padded_rows": "padded rows attributed to the model "
    "(its share of bucket waste)",
    "dispatches": "compiled-program dispatches attributed to the model "
    "(fractional on shared engines: the model's weight share of each "
    "window)",
}


class AttributionLedger:
    """Thread-safe per-model cost account. Cells are floats — shared
    windows charge fractional rows/dispatches, which is what makes the
    sum-to-engine-totals invariant exact instead of rounded."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cells: Dict[str, Dict[str, float]] = {}
        # per-model staging/AOT bytes: a gauge (point-in-time), kept
        # out of the additive cells; None never stored (absent = absent)
        self._staging: Dict[str, float] = {}

    def charge(self, model: str, **deltas: float) -> None:
        """Add cost to one model's account. Unknown fields raise —
        a typo'd field silently opening a new column is exactly the
        drift this plane exists to catch."""
        bad = set(deltas) - set(CELL_FIELDS)
        if bad:
            raise ValueError(f"unknown attribution fields: {sorted(bad)}")
        with self._lock:
            cell = self._cells.get(model)
            if cell is None:
                cell = self._cells[model] = {f: 0.0 for f in CELL_FIELDS}
            for field, v in deltas.items():
                cell[field] += float(v)

    def set_staging_bytes(self, model: str, nbytes: Optional[float]) -> None:
        """Point-in-time staging/AOT byte footprint for one model
        (None clears — the series goes absent, never zero-stamped)."""
        with self._lock:
            if nbytes is None:
                self._staging.pop(model, None)
            else:
                self._staging[model] = float(nbytes)

    # -- queries -----------------------------------------------------------

    def per_model(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {m: dict(cell) for m, cell in self._cells.items()}

    def totals(self) -> Dict[str, float]:
        """Cross-model sums — what must equal the engine-side totals."""
        out = {f: 0.0 for f in CELL_FIELDS}
        for cell in self.per_model().values():
            for f in CELL_FIELDS:
                out[f] += cell[f]
        return out

    def staging_bytes(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._staging)

    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._cells)

    # -- MetricsRegistry bridge --------------------------------------------

    def register(self, registry=None) -> None:
        """Export the ledger as ``keystone_attr_*{model}`` families.
        Absent-not-zero: a model appears only once it has been charged,
        and the staging gauge only where a footprint was set."""
        from keystone_tpu_torch.observability.registry import (
            MetricFamily,
            Sample,
            get_global_registry,
        )

        reg = registry if registry is not None else get_global_registry()
        import weakref

        ref = weakref.ref(self)

        def collect():
            ledger = ref()
            if ledger is None:
                return None
            cells = ledger.per_model()
            fams = []
            for field in CELL_FIELDS:
                samples = [
                    Sample("", {"model": m}, cell[field])
                    for m, cell in sorted(cells.items())
                    if cell[field]
                ]
                if samples:
                    fams.append(MetricFamily(
                        f"keystone_attr_{field}_total", "counter",
                        _COUNTER_HELP[field], samples,
                    ))
            staging = ledger.staging_bytes()
            if staging:
                fams.append(MetricFamily(
                    "keystone_attr_staging_bytes", "gauge",
                    "per-model staging/AOT byte footprint (host "
                    "staging pools + serialized-executable namespaces)",
                    [
                        Sample("", {"model": m}, v)
                        for m, v in sorted(staging.items())
                    ],
                ))
            return fams

        reg.register_collector(collect)


class RowClaimQueue:
    """FIFO of ``(model, rows)`` claims declaring which model each row
    of upcoming shared-engine traffic belongs to — enqueued at submit
    time, drained per dispatched window. One queue per shared UNIT
    (shared by every lane's engine): the micro-batcher coalesces FIFO,
    so the drain tracks window membership; concurrent lanes can skew an
    individual window's shares, but the attribution binding normalizes
    per window, so per-model totals still sum exactly to engine totals
    whatever the interleaving."""

    def __init__(self):
        self._lock = threading.Lock()
        self._claims: collections.deque = collections.deque()

    def claim(self, model: str, rows: float) -> None:
        if rows > 0:
            with self._lock:
                self._claims.append((model, float(rows)))

    def drain(self, n_valid: float) -> Dict[str, float]:
        """Consume claims covering ``n_valid`` dispatched rows ->
        ``{model: rows}``. A partially-covered claim is split and its
        remainder left queued; an under-claimed window returns what was
        claimed (missing rows are unattributed — the binding
        normalizes)."""
        out: Dict[str, float] = {}
        need = float(n_valid)
        with self._lock:
            while need > 1e-9 and self._claims:
                model, rows = self._claims.popleft()
                take = min(rows, need)
                out[model] = out.get(model, 0.0) + take
                need -= take
                if rows - take > 1e-9:
                    self._claims.appendleft((model, rows - take))
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._claims)


class EngineAttribution:
    """The per-engine binding ``ServingMetrics`` calls into from
    ``record_dispatch`` / ``record_dispatch_complete``.

    ``models`` is the engine's resident model set. Solo engines pass
    one model and every weight question collapses to "all of it".
    Shared engines pass ``shares_fn(n_valid) -> {model: rows}`` (the
    CSE claim-queue drain: which model contributed which rows to this
    window) and optionally ``split_cost_fn(bucket) -> (prefix_flops,
    {model: head_flops})`` from the prefix/head split cost models.

    Per-window weight of model m:
        ``w[m] = rowshare[m] * prefix_flops + head_flops[m]``
    normalized to sum 1 — so ``total * w[m]`` sums exactly to the
    engine's total whatever the cost models say. Without a split cost
    model the weights degrade to pure row share.
    """

    def __init__(
        self,
        ledger: AttributionLedger,
        models: Sequence[str],
        *,
        shares_fn: Optional[Callable[[int], Dict[str, float]]] = None,
        split_cost_fn: Optional[
            Callable[[int], Optional[Tuple[float, Dict[str, float]]]]
        ] = None,
    ):
        if not models:
            raise ValueError("an attribution binding needs >= 1 model")
        self.ledger = ledger
        self.models = tuple(models)
        self.shares_fn = shares_fn
        self.split_cost_fn = split_cost_fn
        self._lock = threading.Lock()
        # weight vectors accumulated since the last completion record:
        # record_dispatch_complete covers every dispatch since the
        # caller's previous sync point, so its seconds are split by the
        # SUM of the pending windows' weights, not just the last one
        self._pending: Dict[str, float] = {}

    # -- weight computation ------------------------------------------------

    def _row_shares(self, n_valid: int) -> Dict[str, float]:
        if len(self.models) == 1:
            return {self.models[0]: 1.0}
        rows: Dict[str, float] = {}
        if self.shares_fn is not None:
            try:
                rows = {
                    m: float(r)
                    for m, r in (self.shares_fn(n_valid) or {}).items()
                    if r > 0
                }
            except Exception:
                rows = {}
        total = sum(rows.values())
        if total <= 0:
            # no claims (direct engine.apply, warmup): uniform split
            even = 1.0 / len(self.models)
            return {m: even for m in self.models}
        return {m: r / total for m, r in rows.items()}

    def _weights(self, bucket: int, row_shares: Dict[str, float]):
        split = None
        if self.split_cost_fn is not None:
            try:
                split = self.split_cost_fn(bucket)
            except Exception:
                split = None
        if not split:
            return dict(row_shares)
        prefix_flops, head_flops = split
        weights = {
            m: row_shares.get(m, 0.0) * float(prefix_flops)
            + float(head_flops.get(m, 0.0))
            for m in set(row_shares) | set(head_flops)
        }
        total = sum(weights.values())
        if total <= 0:
            return dict(row_shares)
        return {m: w / total for m, w in weights.items()}

    # -- ServingMetrics hooks ----------------------------------------------

    def on_dispatch(
        self,
        bucket: int,
        n_valid: int,
        padded: int,
        flops: float,
        seconds: Optional[float],
        h2d_bytes: Optional[int],
    ) -> None:
        row_shares = self._row_shares(n_valid)
        weights = self._weights(bucket, row_shares)
        if seconds is None:
            # this window's device seconds arrive later, at the
            # caller's sync point (record_dispatch_complete) — queue
            # its weights; a dispatch that already carried completion
            # seconds is charged right here instead
            with self._lock:
                for m, w in weights.items():
                    self._pending[m] = self._pending.get(m, 0.0) + w
        for m in set(row_shares) | set(weights):
            rs = row_shares.get(m, 0.0)
            w = weights.get(m, 0.0)
            deltas = {
                "goodput_rows": rs * n_valid,
                "padded_rows": rs * padded,
                "dispatches": w,
            }
            if flops:
                deltas["device_flops"] = w * flops
            if h2d_bytes:
                deltas["h2d_bytes"] = rs * h2d_bytes
            if seconds is not None:
                deltas["device_seconds"] = w * seconds
            self.ledger.charge(m, **deltas)

    def on_complete(self, seconds: float) -> None:
        """Completion-timed seconds covering every dispatch since the
        last completion: split by the accumulated pending weights."""
        with self._lock:
            pending, self._pending = self._pending, {}
        total = sum(pending.values())
        if total <= 0:
            even = 1.0 / len(self.models)
            pending = {m: even for m in self.models}
            total = 1.0
        for m, w in pending.items():
            if w:
                self.ledger.charge(
                    m, device_seconds=seconds * (w / total)
                )


# -- /attributionz documents ----------------------------------------------


def _share_doc(
    cells: Dict[str, Dict[str, float]],
    staging: Dict[str, float],
    top_k: int,
) -> Dict:
    total_seconds = sum(c.get("device_seconds", 0.0) for c in cells.values())
    total_flops = sum(c.get("device_flops", 0.0) for c in cells.values())
    models = {}
    for m, cell in sorted(cells.items()):
        flops = cell.get("device_flops", 0.0)
        seconds = cell.get("device_seconds", 0.0)
        entry = {f: cell.get(f, 0.0) for f in CELL_FIELDS}
        entry["device_seconds_share"] = (
            seconds / total_seconds if total_seconds > 0 else None
        )
        entry["device_flops_share"] = (
            flops / total_flops if total_flops > 0 else None
        )
        # the $/FLOP-style normalized unit cost: device seconds per
        # modeled GFLOP — a model burning time without modeled work
        # (host-bound, tiny batches) surfaces as expensive here
        entry["seconds_per_gflop"] = (
            seconds / (flops / 1e9) if flops > 0 else None
        )
        rows = entry["goodput_rows"] + entry["padded_rows"]
        entry["goodput_fraction"] = (
            entry["goodput_rows"] / rows if rows > 0 else None
        )
        if m in staging:
            entry["staging_bytes"] = staging[m]
        models[m] = entry

    def spend(item):
        m, e = item
        return (e["device_seconds"], e["device_flops"], e["goodput_rows"])

    top = [
        {
            "model": m,
            "device_seconds": e["device_seconds"],
            "device_seconds_share": e["device_seconds_share"],
            "device_flops": e["device_flops"],
            "seconds_per_gflop": e["seconds_per_gflop"],
        }
        for m, e in sorted(models.items(), key=spend, reverse=True)[:top_k]
    ]
    return {
        "models": models,
        "top": top,
        "totals": {
            "device_seconds": total_seconds,
            "device_flops": total_flops,
        },
    }


def attribution_document(ledger: AttributionLedger, top_k: int = 10) -> Dict:
    """The ``GET /attributionz`` document off one process's ledger."""
    return _share_doc(ledger.per_model(), ledger.staging_bytes(), top_k)


def attribution_from_samples(
    samples: Iterable[Tuple[str, Dict[str, str], float]], top_k: int = 10
) -> Dict:
    """The same document rebuilt from parsed exposition rows
    (``prometheus.parse_samples``) — the fleet router feeds its
    FEDERATED scrape through here so its ``/attributionz`` totals are
    the fleet's, not its own."""
    cells: Dict[str, Dict[str, float]] = {}
    staging: Dict[str, float] = {}
    prefix = "keystone_attr_"
    for name, labels, value in samples:
        if not name.startswith(prefix):
            continue
        model = labels.get("model")
        if model is None:
            continue
        field = name[len(prefix):]
        if field == "staging_bytes":
            staging[model] = staging.get(model, 0.0) + value
            continue
        if field.endswith("_total"):
            field = field[: -len("_total")]
        if field not in CELL_FIELDS:
            continue
        cell = cells.setdefault(model, {f: 0.0 for f in CELL_FIELDS})
        cell[field] += value
    return _share_doc(cells, staging, top_k)


__all__ = [
    "CELL_FIELDS",
    "AttributionLedger",
    "EngineAttribution",
    "RowClaimQueue",
    "attribution_document",
    "attribution_from_samples",
]
