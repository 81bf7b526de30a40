"""ModelZoo: one process hosting many named models (counterpart of
``keystone_tpu/zoo/host.py``).

Each model (or cross-model CSE group — see ``zoo/cse.py``) is hosted
as one **unit**: a full ``Gateway`` (admission -> lanes -> micro-batch
-> engines, one CUDA graph per bucket per lane) under the model's own
name, its own bucket list and SLO, and, for a solo unit, a per-model
**AOT store namespace** (``aot.namespaced_store(model_id)``: two models
never share an entry, and the store's GC accounts each namespace
separately; shared-prefix units keep the store off, as in JAX).
Lifecycle:

- **page-in** — a cold model's first request (or an explicit
  ``host()``) builds its artifacts and gateway OUTSIDE the zoo's
  resident lock — the same build-outside-lock discipline as the warm
  pool — and publishes the unit atomically; concurrent requesters
  wait on the build instead of duplicating it.
- **LRU resident cap** — ``max_resident`` bounds how many models hold
  compiled engines + device residency at once; exceeding it evicts
  the least-recently-used unpinned unit, whose gateway DRAINS ON A
  BACKGROUND THREAD — paging model B in never stalls model A's
  in-flight windows, and vice versa. Once its last lane is closed the
  unit's graphs and their private memory pools are released
  (``CompiledPipeline.release_graphs``: it waits on that unit's own
  compute stream only, and leaves the freed pools in the caching
  allocator until the next capture empties it).
- **pinning** — ``ModelSpec.pinned`` exempts a model from eviction.
- **cross-model CSE** — models hosted together whose featurize
  ``pipeline_token``s match are fused into ONE shared-prefix unit:
  one engine computes the prefix once per window and fans activations
  to every member head (grouping is decided per ``host()`` call — a
  later solo page-in doesn't silently re-plumb a running unit).

Zoo-level metrics ride the ``model`` label:
``keystone_zoo_resident{model}``, ``keystone_zoo_pageins_total{model}``,
``keystone_zoo_evictions_total{model}`` — next to each unit's normal
gateway/engine families under its own gateway name.

A spec or plan that shards a model (``param_sharding``) hosts it
sharded in both kinds of unit: a solo unit's ``Gateway`` and a shared
unit's ``SharedPrefixEngine`` (every head through its own binder) place
the params over the process mesh, whole on one card. ``profiles()``
sizes params with ``serving/sharding.named_params``/``params_nbytes``.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from concurrent.futures import CancelledError, Future
from typing import Any, Dict, List, Optional, Sequence, Tuple

from keystone_tpu_torch._device import resolve_device
from keystone_tpu_torch.gateway.lifecycle import Gateway
from keystone_tpu_torch.observability.attribution import (
    AttributionLedger,
    EngineAttribution,
    RowClaimQueue,
    attribution_document,
)
from keystone_tpu_torch.observability.drift import DriftDetector
from keystone_tpu_torch.serving import aot as aot_lib
from keystone_tpu_torch.serving.sharding import named_params, params_nbytes
from keystone_tpu_torch.zoo.cse import SharedPrefixEngine, featurize_groups
from keystone_tpu_torch.zoo.optimizer import (
    ChipBudget,
    ModelProfile,
    PlacementPlan,
    diff_plans,
    plan_placement,
)
from keystone_tpu_torch.zoo.registry import (
    BuiltModel,
    ModelRegistry,
    ModelSpec,
    UnknownModel,
)

logger = logging.getLogger(__name__)


def _chain(parent: Future, fn) -> Future:
    """A future resolving to ``fn(parent.result())`` — how a shared
    unit's per-model view is carved out of its dict output. Cancelling
    the view is best-effort only (the underlying window request keeps
    its slot, same as any coalesced request)."""
    out: Future = Future()

    def done(f: Future) -> None:
        try:
            result = f.result()
        except CancelledError:
            out.cancel()
        except Exception as e:
            try:
                out.set_exception(e)
            except Exception:
                pass  # view cancelled concurrently
        else:
            try:
                out.set_result(fn(result))
            except Exception as e:
                try:
                    out.set_exception(e)
                except Exception:
                    pass

    parent.add_done_callback(done)
    return out


def _retire(unit: "_Unit", timeout: Optional[float] = 10.0) -> None:
    """Drain a unit's gateway, then release its engines' graphs and
    their private memory pools: after the close no window dispatches
    there again. Sets ``unit.retired`` to the seconds of each step."""
    t0 = time.perf_counter()
    unit.gateway.close(timeout=timeout)
    drained = time.perf_counter()
    graphs = sum(lane.engine.release_graphs() for lane in unit.gateway.pool.lanes)
    unit.retired = {
        "drain_s": drained - t0,
        "release_s": time.perf_counter() - drained,
        "graphs": graphs,
    }
    logger.info(
        "zoo: retired %s: drained in %.3f s, %d graphs released in %.3f s",
        "+".join(unit.ids), unit.retired["drain_s"], graphs,
        unit.retired["release_s"],
    )


class _Unit:
    """One hosted gateway serving one model or one CSE group."""

    def __init__(
        self,
        ids: Tuple[str, ...],
        gateway: Gateway,
        shared: bool,
        pinned: bool,
        claims: Optional[RowClaimQueue] = None,
    ):
        self.ids = ids
        self.gateway = gateway
        self.shared = shared
        self.pinned = pinned
        # shared units: the unit-level row-claim queue every lane
        # engine's attribution binding drains from
        self.claims = claims
        # LRU stamp. The owning ModelZoo holds ITS lock around every
        # touch()/read — the lock lives on the zoo, not this unit, so
        # the contract is prose rather than a guarded-by annotation.
        self.last_used = time.monotonic()
        # set once the unit has drained and released its graphs
        self.retired: Optional[Dict[str, float]] = None

    def touch(self) -> None:
        self.last_used = time.monotonic()


class ModelZoo:
    """The multi-model host. ``registry`` names the models; ``plan``
    (a ``PlacementPlan``) overrides each spec's buckets/lanes/sharding
    with the optimizer's choices; ``max_resident`` caps how many
    models hold engines at once (None = all); ``cse=False`` disables
    shared-prefix fusion (every model solo); ``aot_namespaces=False``
    gives solo units the process store itself instead of per-model
    namespaces of it. ``device`` is where every unit's engines run
    (``None`` means ``cuda`` and raises without it); the registry's
    models must be built there too."""

    def __init__(
        self,
        registry: ModelRegistry,
        *,
        max_resident: Optional[int] = None,
        plan: Optional[PlacementPlan] = None,
        cse: bool = True,
        aot_namespaces: bool = True,
        device=None,
        metrics_registry=None,
    ):
        if len(registry) == 0:
            raise ValueError("zoo needs at least one model spec")
        if max_resident is not None and max_resident < 1:
            raise ValueError("max_resident must be >= 1")
        self.registry = registry
        self.plan = plan
        self.max_resident = max_resident
        self._cse = cse
        self._aot_namespaces = aot_namespaces
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._units: Dict[Tuple[str, ...], _Unit] = {}
        self._by_model: Dict[str, _Unit] = {}  # guarded-by: _lock
        self._building: Dict[str, threading.Event] = {}
        self._artifacts: Dict[str, BuiltModel] = {}
        self._artifacts_lock = threading.Lock()
        self._closed = False
        # optional per-model online-lifecycle plane (attach_lifecycle)
        self.lifecycle = None
        # the budget the applied plan was planned under (apply_plan /
        # --optimize) — what the drift audit re-plans against
        self.plan_budget: Optional[ChipBudget] = None
        from keystone_tpu_torch.observability.registry import (
            get_global_registry,
        )

        reg = (
            metrics_registry if metrics_registry is not None
            else get_global_registry()
        )
        # the attribution & drift plane: every unit's engines charge
        # the per-model cost ledger (keystone_attr_*{model}), and the
        # drift detector scores live request-size mixtures against the
        # applied plan's baselines (keystone_drift_score{model})
        self.attribution = AttributionLedger()
        self.attribution.register(reg)
        self.drift = DriftDetector()
        self.drift.register(reg)
        self._resident_g = reg.gauge(
            "keystone_zoo_resident",
            "1 when the model currently holds compiled engines "
            "(paged in), 0 after eviction",
            ("model",),
        )
        self._pageins_c = reg.counter(
            "keystone_zoo_pageins_total",
            "cold-model page-ins (gateway build + warm through the "
            "build-outside-lock path)",
            ("model",),
        )
        self._evictions_c = reg.counter(
            "keystone_zoo_evictions_total",
            "LRU resident-cap evictions (the gateway drains on a "
            "background thread)",
            ("model",),
        )
        for model_id in registry.ids():
            self._resident_g.set(0.0, (model_id,))

    # -- artifacts ---------------------------------------------------------

    def _built(self, model_id: str) -> BuiltModel:
        """Build (once) and cache a model's fitted artifacts. Params
        on host are the cheap half; engines/compiles are what the
        resident cap governs."""
        with self._artifacts_lock:
            built = self._artifacts.get(model_id)
            if built is None:
                spec = self.registry.get(model_id)
                built = spec.build()
                self._artifacts[model_id] = built
            return built

    # -- hosting -----------------------------------------------------------

    def host(
        self, model_ids: Optional[Sequence[str]] = None
    ) -> List[Tuple[str, ...]]:
        """Page in a set of models together (default: every registered
        model). Models paged in by the same call are CSE-grouped —
        identical featurize tokens fuse into one shared-prefix unit.
        Returns the hosted unit id-tuples."""
        want = [
            mid for mid in (model_ids or self.registry.ids())
            if mid not in self._by_model
        ]
        for mid in want:
            self.registry.get(mid)  # raise UnknownModel before building
        groups: List[Tuple[str, ...]] = []
        if self._cse and len(want) > 1:
            featurizers = {}
            for mid in want:
                built = self._built(mid)
                if built.featurize is not None:
                    featurizers[mid] = built.featurize
            grouped = set()
            for group in featurize_groups(featurizers):
                if len(group) >= 2:
                    groups.append(group)
                    grouped.update(group)
            groups.extend(
                (mid,) for mid in want if mid not in grouped
            )
        else:
            groups = [(mid,) for mid in want]
        hosted = []
        for group in groups:
            hosted.append(self._ensure_resident(group[0], group))
        return [u.ids for u in hosted]

    def gateway_for(self, model_id: str) -> Gateway:
        """The model's live gateway (pages it in solo if cold)."""
        return self._ensure_resident(model_id).gateway

    def resolve(
        self, model_id: Optional[str] = None
    ) -> Tuple[str, ModelSpec]:
        """Route-time lookup: the effective model id (default when
        None) and its spec. Raises ``UnknownModel`` with the
        registered ids — the HTTP layer's typed-404 payload."""
        mid = model_id or self.registry.default_id
        return mid, self.registry.get(mid)

    def _ensure_resident(
        self,
        model_id: str,
        group: Optional[Tuple[str, ...]] = None,
    ) -> _Unit:
        while True:
            with self._lock:
                if self._closed:
                    raise RuntimeError("ModelZoo is closed")
                unit = self._by_model.get(model_id)
                if unit is not None:
                    unit.touch()
                    return unit
                ev = self._building.get(model_id)
                if ev is None:
                    ev = threading.Event()
                    for mid in group or (model_id,):
                        self._building[mid] = ev
                    owner = True
                else:
                    owner = False
            if not owner:
                # another request is building this model: wait for the
                # publish instead of compiling a duplicate generation
                ev.wait()
                continue
            try:
                unit = self._build_unit(group or (model_id,))
                with self._lock:
                    self._units[unit.ids] = unit
                    for mid in unit.ids:
                        self._by_model[mid] = unit
                for mid in unit.ids:
                    self._pageins_c.inc((mid,))
                    self._resident_g.set(1.0, (mid,))
                logger.info(
                    "zoo: paged in %s (%s)",
                    "+".join(unit.ids),
                    "shared-prefix" if unit.shared else "solo",
                )
                self._enforce_cap(keep=unit)
                return unit
            finally:
                with self._lock:
                    for mid in group or (model_id,):
                        if self._building.get(mid) is ev:
                            del self._building[mid]
                ev.set()

    def _placement_kwargs(self, spec: ModelSpec) -> Dict[str, Any]:
        """Spec hosting parameters, overridden by the optimizer's plan
        when one was applied."""
        buckets = spec.buckets
        lanes = spec.lanes
        param_sharding = spec.param_sharding
        if self.plan is not None:
            placement = self.plan.placement_for(spec.model_id)
            if placement is not None:
                buckets = placement.buckets
                lanes = placement.lanes
                if placement.sharded and param_sharding is None:
                    # the plan's budget check says replicated params
                    # don't fit: shard with the default rule set
                    param_sharding = True
                elif not placement.sharded:
                    param_sharding = None
        return {
            "buckets": buckets,
            "lanes": lanes,
            "param_sharding": param_sharding,
        }

    def _aot_store_for(self, model_id: str):
        if not self._aot_namespaces:
            return "auto"
        store = aot_lib.namespaced_store(model_id)
        # no store configured means OFF, not "auto": auto would put two
        # models' entries in one undifferentiated namespace
        return store if store is not None else None

    def _build_unit(self, ids: Tuple[str, ...]) -> _Unit:
        """Build one unit's gateway — engines compiled and warmed —
        entirely outside the zoo's resident lock."""
        specs = [self.registry.get(mid) for mid in ids]
        pinned = any(s.pinned for s in specs)
        if len(ids) == 1:
            spec = specs[0]
            built = self._built(spec.model_id)
            place = self._placement_kwargs(spec)
            gw = Gateway(
                built.fitted,
                buckets=place["buckets"],
                n_lanes=place["lanes"],
                max_delay_ms=spec.max_delay_ms,
                warmup_example=spec.warmup_example,
                pipeline_depth=spec.pipeline_depth,
                device_featurize=built.featurize,
                param_sharding=place["param_sharding"],
                aot_store=self._aot_store_for(spec.model_id),
                device=self.device,
                name=spec.model_id,
                slo_latency_s=spec.slo_latency_s,
            )
            for lane in gw.pool.lanes:
                lane.engine.metrics.attach_attribution(
                    EngineAttribution(self.attribution, ids)
                )
            return _Unit(ids, gw, shared=False, pinned=pinned)
        # -- shared-prefix unit (CSE group) ----------------------------
        sharding = {
            s.model_id: self._placement_kwargs(s)["param_sharding"] for s in specs
        }
        builts = {mid: self._built(mid) for mid in ids}
        featurize = builts[ids[0]].featurize
        heads = {mid: b.fitted for mid, b in builts.items()}
        # the group serves every member's traffic: union buckets, the
        # widest lane ask, the tightest SLO and coalesce delay
        buckets = tuple(sorted(set(
            b
            for s in specs
            for b in self._placement_kwargs(s)["buckets"]
        )))
        lanes = max(
            self._placement_kwargs(s)["lanes"] for s in specs
        )
        slos = [
            s.slo_latency_s for s in specs
            if s.slo_latency_s is not None
        ]
        name = "+".join(ids)

        device = self.device

        def engine_factory(eng_buckets):
            def factory(lane_name: str):
                return SharedPrefixEngine(
                    featurize, heads, eng_buckets, name=lane_name,
                    device=device, head_sharding=sharding,
                )

            return factory

        gw = Gateway(
            heads[ids[0]],
            buckets=buckets,
            n_lanes=lanes,
            max_delay_ms=min(s.max_delay_ms for s in specs),
            warmup_example=specs[0].warmup_example,
            pipeline_depth=min(s.pipeline_depth for s in specs),
            engine_factory=engine_factory,
            device=self.device,
            name=name,
            slo_latency_s=min(slos) if slos else None,
        )
        # fair-split attribution: one UNIT-level claim queue shared by
        # every lane, each lane's shared engine bound with its own
        # prefix/head split cost model
        claims = RowClaimQueue()
        for lane in gw.pool.lanes:
            engine = lane.engine
            split_fn = getattr(engine, "split_cost_model", None)
            lane.engine.metrics.attach_attribution(
                EngineAttribution(
                    self.attribution, ids,
                    shares_fn=claims.drain,
                    split_cost_fn=split_fn,
                )
            )
        return _Unit(ids, gw, shared=True, pinned=pinned, claims=claims)

    # -- LRU eviction ------------------------------------------------------

    def _enforce_cap(self, keep: Optional[_Unit] = None) -> None:
        if self.max_resident is None:
            return
        to_evict: List[_Unit] = []
        with self._lock:
            resident = sum(len(u.ids) for u in self._units.values())
            candidates = sorted(
                (
                    u for u in self._units.values()
                    if not u.pinned and u is not keep
                ),
                key=lambda u: u.last_used,
            )
            for unit in candidates:
                if resident <= self.max_resident:
                    break
                del self._units[unit.ids]
                for mid in unit.ids:
                    del self._by_model[mid]
                resident -= len(unit.ids)
                to_evict.append(unit)
        for unit in to_evict:
            for mid in unit.ids:
                self._evictions_c.inc((mid,))
                self._resident_g.set(0.0, (mid,))
            logger.info(
                "zoo: evicting %s (LRU over max_resident=%d)",
                "+".join(unit.ids), self.max_resident,
            )
            # drain on a background thread: eviction is bookkeeping
            # for the pager, and model B's page-in must never block on
            # model A's in-flight windows
            threading.Thread(
                target=_retire,
                args=(unit,),
                name=f"keystone-zoo-evict-{unit.ids[0]}",
                daemon=True,
            ).start()

    def evict(self, model_id: str) -> bool:
        """Explicitly drop one model's unit (drains in background).
        Pinned models evict too when asked by name — the pin guards
        against LRU pressure, not operators."""
        with self._lock:
            unit = self._by_model.get(model_id)
            if unit is None:
                return False
            del self._units[unit.ids]
            for mid in unit.ids:
                del self._by_model[mid]
        for mid in unit.ids:
            self._evictions_c.inc((mid,))
            self._resident_g.set(0.0, (mid,))
        threading.Thread(
            target=_retire,
            args=(unit,),
            name=f"keystone-zoo-evict-{unit.ids[0]}",
            daemon=True,
        ).start()
        return True

    # -- serving -----------------------------------------------------------

    def predict(
        self,
        example: Any,
        model_id: Optional[str] = None,
        deadline_ms: Optional[float] = None,
        trace_id: Optional[str] = None,
    ) -> Future:
        """Admit one example to one model (the default when
        ``model_id`` is None). Resolves to THAT model's output — a
        shared-prefix unit's dict result is carved down to the
        requested member. Raises ``UnknownModel`` / ``Overloaded``
        synchronously like ``Gateway.predict``."""
        mid, _spec = self.resolve(model_id)
        unit = self._ensure_resident(mid)
        if unit.shared and unit.claims is not None:
            # claim BEFORE submit: the window this example coalesces
            # into drains its membership from the same FIFO
            unit.claims.claim(mid, 1)
        fut = unit.gateway.predict(
            example, deadline_ms=deadline_ms, trace_id=trace_id
        )
        if not unit.shared:
            return fut
        return _chain(fut, lambda out: out[mid])

    def predict_many(
        self,
        example: Any,
        model_ids: Optional[Sequence[str]] = None,
        deadline_ms: Optional[float] = None,
    ) -> Future:
        """Fan one example out to several models (default: all) —
        resolves to ``{model_id: output}``. The example must be a
        valid input for EVERY target model (fan-out is an ensemble of
        same-schema models, not a broadcast across unrelated ones).
        Models co-hosted in one shared-prefix unit cost ONE window
        slot and one featurize; solo models are admitted
        independently and the results are joined. This is the
        ensemble/shadow path the CSE plane optimizes."""
        want = tuple(model_ids or self.registry.ids())
        for mid in want:
            self.registry.get(mid)
        by_unit: Dict[Tuple[str, ...], List[str]] = {}
        for mid in want:
            unit = self._ensure_resident(mid)
            by_unit.setdefault(unit.ids, []).append(mid)
        parts: List[Tuple[List[str], bool, Future]] = []
        for unit_ids, members in by_unit.items():
            unit = self._units.get(unit_ids) or self._by_model[
                members[0]
            ]
            if unit.shared and unit.claims is not None:
                # one window row serves every requested member: its
                # ownership splits evenly among them (the shared
                # prefix's fair-split input)
                share = 1.0 / len(members)
                for mid in members:
                    unit.claims.claim(mid, share)
            fut = unit.gateway.predict(
                example, deadline_ms=deadline_ms
            )
            parts.append((members, unit.shared, fut))
        out: Future = Future()
        combined: Dict[str, Any] = {}
        pending = [len(parts)]
        plock = threading.Lock()

        def arm(members: List[str], shared: bool):
            def done(f: Future) -> None:
                try:
                    result = f.result()
                except Exception as e:
                    try:
                        out.set_exception(e)
                    except Exception:
                        pass
                    return
                with plock:
                    for mid in members:
                        combined[mid] = (
                            result[mid] if shared else result
                        )
                    pending[0] -= 1
                    finished = pending[0] == 0
                if finished:
                    try:
                        out.set_result(dict(combined))
                    except Exception:
                        pass

            return done

        for members, shared, fut in parts:
            fut.add_done_callback(arm(members, shared))
        return out

    @property
    def ready(self) -> bool:
        """At least one unit resident and every resident unit
        admitting — the zoo-level ``/readyz`` signal."""
        with self._lock:
            units = list(self._units.values())
        return bool(units) and all(u.gateway.ready for u in units)

    def total_load(self) -> int:
        """Queued + in-lane requests across every resident unit — the
        zoo's ``X-Keystone-Load`` routing-load number."""
        with self._lock:
            units = list(self._units.values())
        return sum(
            u.gateway.admission.queue_depth
            + u.gateway.pool.total_load()
            for u in units
        )

    def rebucket(self, force: bool = False) -> Dict[str, bool]:
        """One lifecycle iteration on every resident unit (``/swap``
        in zoo mode). Returns ``{unit-name: swapped}``."""
        with self._lock:
            units = list(self._units.values())
        return {
            "+".join(u.ids): u.gateway.rebucket(force=force)
            for u in units
        }

    # -- attribution & drift plane -----------------------------------------

    def apply_plan(
        self,
        plan: PlacementPlan,
        budget: Optional[ChipBudget] = None,
        profiles: Optional[Sequence[ModelProfile]] = None,
    ) -> None:
        """Adopt a placement plan: future page-ins use its placements,
        the budget is retained for the drift audit's re-plan, and each
        planning profile's histogram is pinned as that model's DRIFT
        BASELINE — the distribution the plan assumed, which is exactly
        what live traffic is scored against."""
        self.plan = plan
        self.plan_budget = budget
        for prof in profiles or ():
            if prof.histogram:
                self.drift.set_baseline(prof.model_id, prof.histogram)

    def observe_request(
        self, model_id: Optional[str], size: int
    ) -> None:
        """Feed one live request's row count into the drift detector
        (the HTTP frontend calls this per /predict request with its
        instance count; benches call it directly)."""
        try:
            mid, _spec = self.resolve(model_id)
        except UnknownModel:
            return
        self.drift.observe(mid, size)

    def live_profiles(self) -> List[ModelProfile]:
        """Planning profiles with each histogram replaced by the drift
        window's LIVE one (where live observations exist) — the
        re-plan-on-drift input."""
        out = []
        for prof in self.profiles():
            live = self.drift.live_histogram(prof.model_id)
            if live:
                prof = dataclasses.replace(prof, histogram=live)
            out.append(prof)
        return out

    def _refresh_staging(self) -> None:
        """Point-in-time per-model staging bytes: each unit's live
        host staging pools (absent until a pipelined lane ran), split
        evenly over the unit's members."""
        with self._lock:
            units = list(self._units.values())
        seen = set()
        for unit in units:
            total = 0
            have = False
            for lane in unit.gateway.pool.lanes:
                nbytes = lane.engine.metrics.staging_bytes
                if nbytes is not None:
                    total += nbytes
                    have = True
            share = total / len(unit.ids) if have else None
            for mid in unit.ids:
                self.attribution.set_staging_bytes(mid, share)
                seen.add(mid)
        for mid in self.registry.ids():
            if mid not in seen:
                self.attribution.set_staging_bytes(mid, None)

    def attributionz(self, top_k: int = 10) -> Dict[str, Any]:
        """The ``GET /attributionz`` document: the per-model ledger
        with device-seconds shares, normalized unit cost, and the
        top-k spender table."""
        self._refresh_staging()
        return attribution_document(self.attribution, top_k=top_k)

    def driftz(self) -> Dict[str, Any]:
        """The ``GET /driftz`` document: per-model PSI scores plus —
        once any model crossed the threshold and a plan is applied —
        the audit: ``plan_placement`` re-run on the LIVE profiles and
        the diff of what would change. Recommendation-only; nothing is
        auto-applied."""
        doc = self.drift.document()
        doc["plan_applied"] = self.plan is not None
        recommendation = None
        if doc["drifted"] and self.plan is not None:
            budget = self.plan_budget or ChipBudget(
                hbm_bytes=self.plan.hbm_budget_bytes,
                lane_budget=self.plan.lane_budget,
            )
            try:
                proposed = plan_placement(self.live_profiles(), budget)
                recommendation = {
                    "note": (
                        "recommendation only — re-plan is never "
                        "auto-applied"
                    ),
                    "changes": diff_plans(self.plan, proposed),
                    "proposed_plan": proposed.to_dict(),
                }
            except Exception as e:  # audit must not 500 /driftz
                recommendation = {"error": str(e)}
        doc["recommendation"] = recommendation
        return doc

    # -- planning inputs + status ------------------------------------------

    def profiles(self, build: bool = False) -> List[ModelProfile]:
        """Assemble the optimizer's inputs from live state: observed
        request-size histograms and warmup-extracted cost models for
        resident models, the spec's ``expected_sizes`` hint otherwise.
        ``params_nbytes`` is measured off built artifacts
        (``build=True`` forces building cold models' params — what
        ``--optimize`` does at plan time)."""
        profiles = []
        for spec in self.registry:
            with self._lock:
                unit = self._by_model.get(spec.model_id)
            hist: Dict[int, int] = dict(spec.expected_sizes)
            cost: Dict[int, Dict[str, float]] = {}
            if unit is not None:
                live = unit.gateway.observed_sizes()
                if live:
                    hist = live
                for lane in unit.gateway.pool.lanes:
                    for b, m in lane.engine.metrics.cost_models.items():
                        cost.setdefault(b, dict(m))
            nbytes = 0
            if build or spec.model_id in self._artifacts:
                try:
                    fitted = self._built(spec.model_id).fitted
                    nbytes = params_nbytes(named_params(fitted))
                except Exception:
                    logger.info(
                        "zoo: could not size %s params",
                        spec.model_id, exc_info=True,
                    )
            profiles.append(
                ModelProfile(
                    model_id=spec.model_id,
                    histogram=hist,
                    cost_models=cost,
                    params_nbytes=nbytes,
                    fallback_buckets=spec.buckets,
                    pinned=spec.pinned,
                )
            )
        return profiles

    def planz(self) -> Dict[str, Any]:
        """The ``/planz`` document: the applied plan (None when the
        zoo runs on spec flags) next to every model's ACTUAL shape —
        resident or cold, lanes/buckets served, shared-prefix
        membership."""
        with self._lock:
            units = {u.ids: u for u in self._units.values()}
        actual: Dict[str, Any] = {}
        for spec in self.registry:
            row: Dict[str, Any] = {
                "resident": False,
                "pinned": spec.pinned,
                "spec_buckets": list(spec.buckets),
                "spec_lanes": spec.lanes,
            }
            for ids, unit in units.items():
                if spec.model_id in ids:
                    row.update(
                        resident=True,
                        shared_with=[
                            m for m in ids if m != spec.model_id
                        ],
                        **unit.gateway.pool.status(),
                    )
                    break
            actual[spec.model_id] = row
        return {
            "default_model": self.registry.default_id,
            "max_resident": self.max_resident,
            "plan": (
                self.plan.to_dict() if self.plan is not None else None
            ),
            "actual": actual,
        }

    # -- online lifecycle --------------------------------------------------

    def attach_lifecycle(self, manager) -> None:
        """Adopt a ``LifecycleManager`` whose controllers drive this
        zoo's per-model gateways. The HTTP frontend resolves its
        lifecycle surface (``/feedback/<model>``, ``/lifecyclez``)
        through this attribute in zoo mode, so per-model streaming
        refit works identically with many resident models. NOTE:
        controllers only work over SOLO units — a model in a
        cross-model CSE group serves through a shared engine the
        lifecycle cannot rebuild from one fitted
        (``Gateway.swap_model`` raises on those)."""
        self.lifecycle = manager

    def lifecycle_status(self) -> Optional[Dict[str, Any]]:
        """The attached manager's ``/lifecyclez`` document (None when
        no lifecycle plane is attached)."""
        return (
            self.lifecycle.status()
            if self.lifecycle is not None else None
        )

    # -- shutdown ----------------------------------------------------------

    def close(self, timeout: Optional[float] = 10.0) -> None:
        """Drain every unit concurrently (one slow model must not
        serialize the others' drains behind it)."""
        if self.lifecycle is not None:
            # the refit/tick plane dies first: a tick mid-drain would
            # race swap_model against the unit drains below
            try:
                self.lifecycle.close()
            except Exception:
                logger.exception("zoo lifecycle close failed")
        with self._lock:
            if self._closed:
                units = []
            else:
                self._closed = True
                units = list(self._units.values())
                self._units.clear()
                self._by_model.clear()
        threads = [
            threading.Thread(
                target=_retire, args=(u, timeout),
                name=f"keystone-zoo-close-{u.ids[0]}", daemon=True,
            )
            for u in units
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
        for u in units:
            for mid in u.ids:
                self._resident_g.set(0.0, (mid,))

    def __enter__(self) -> "ModelZoo":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = ["ModelZoo", "UnknownModel"]
