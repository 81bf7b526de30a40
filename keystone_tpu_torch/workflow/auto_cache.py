"""Profile-driven automatic cache placement (counterpart of
``keystone_tpu/workflow/auto_cache.py``).

Reference: workflow/AutoCacheRule.scala:12-664 — profile nodes by executing
the graph on sample scales (partitionScales = Seq(2, 4), numTrials = 1),
timing wall clock and measuring memory; fit per-node linear models of time
and memory against scale (generalizeProfiles); estimate the total runtime
a candidate cache set implies through per-node run counts weighted by each
consumer's ``weight`` (the passes an operator makes over its input); then
either AggressiveCache (cache anything used more than once, :503) or
GreedyCache under a memory budget of 75 % of what remains (greedyCache
:559-602, selectNext :542); finally insert ``Cacher`` nodes
(addCachesToPipeline :492).

The rule only inserts ``Cacher`` nodes, which are identities: it frees
nothing, and the executor already keeps every node's result for the run.

Here device memory is the bytes of tensors on a CUDA device; tensors on
the CPU, host column blocks and other host objects count as host memory.
The default budget is 75 % of the card's free memory
(``observability/device.device_memory_stats``, the probe the weighted
solver reads too). One difference from the JAX package: the profiler runs
shallow copies of the operators, so that a stateful node (``ColumnSampler``
counts its draws) draws the same samples in the fit that follows as it
would without auto-caching.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import sys
import time
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.workflow.expressions import DatasetExpression, Expression
from keystone_tpu_torch.workflow.graph import (
    Graph,
    NodeId,
    SinkId,
    get_children,
    get_descendants,
    linearize,
)
from keystone_tpu_torch.workflow.operators import DatasetOperator
from keystone_tpu_torch.workflow.rules import PrefixMap, Rule

logger = logging.getLogger(__name__)

DEFAULT_SAMPLE_SCALES = (2, 4)  # reference: partitionScales = Seq(2, 4)
DEFAULT_BUDGET_FRACTION = 0.75  # reference: 75% of remaining memory


@dataclasses.dataclass
class Profile:
    """Per-node cost estimate (AutoCacheRule.scala:18's Profile: time,
    cluster memory and client-side memory)."""

    ns: float  # estimated execution time, nanoseconds
    device_mem: float  # bytes of output on the card
    host_mem: float  # bytes of output in host memory

    def __add__(self, other: "Profile") -> "Profile":
        return Profile(
            self.ns + other.ns,
            self.device_mem + other.device_mem,
            self.host_mem + other.host_mem,
        )


def _tensors(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _split_bytes(values: List[Any]) -> Tuple[float, float]:
    """(device bytes, host bytes) of ``values``: a tensor counts its
    ``nbytes`` where it lives, any other object its ``sys.getsizeof``."""
    device = host = 0.0
    for v in values:
        ts = _tensors(v)
        if not ts:
            host += sys.getsizeof(v)
        for t in ts:
            if t.device.type == "cpu":
                host += t.nbytes
            else:
                device += t.nbytes
    return device, host


def _measure_size(value: Any) -> Tuple[float, float]:
    """(device bytes, host bytes) of an operator's output. A host-blocks
    dataset counts its column blocks as host memory and none on the card;
    the JAX package also gives it none on the device (its items are host
    arrays), but reads them by moving every block to the device first."""
    if isinstance(value, Dataset):
        if value.is_array:
            return _split_bytes([value.padded()])
        if value.is_host:
            return 0.0, float(sum(b.nbytes for b in value.host_blocks))
        return _split_bytes(value.items())
    return _split_bytes([value])


def get_node_weights(graph: Graph) -> Dict[NodeId, int]:
    """WeightedNode.weight: the passes an operator makes over its input
    (AutoCacheRule.getNodeWeights:23)."""
    return {n: int(getattr(op, "weight", 1)) for n, op in graph.operators.items()}


def get_runs(graph: Graph, cache_set: Set[NodeId], weights: Dict[NodeId, int]) -> Dict[NodeId, int]:
    """Times each node's expression is evaluated given the cached set
    (AutoCacheRule.getRuns:57): a cached node evaluates once; otherwise
    once per pass each consumer makes. A sink read counts as one weight-1
    consumer."""
    runs: Dict[NodeId, int] = {}
    for n in reversed([g for g in linearize(graph) if isinstance(g, NodeId)]):
        total = 0
        for c in get_children(graph, n):
            if isinstance(c, SinkId):
                total += 1
            elif isinstance(c, NodeId):
                c_runs = 1 if c in cache_set else runs.get(c, 1)
                total += c_runs * weights.get(c, 1)
        runs[n] = max(total, 1)
    return runs


def estimate_cached_runtime(graph: Graph, cache_set: Set[NodeId], profiles: Dict[NodeId, Profile],
                            weights: Dict[NodeId, int]) -> float:
    """Total ns to execute everything given the cache set
    (estimateCachedRunTime:471)."""
    runs = get_runs(graph, cache_set, weights)
    total = 0.0
    for n, p in profiles.items():
        effective = 1 if n in cache_set else runs[n]
        total += p.ns * effective
    return total


def _sync(value: Any) -> None:
    """Wait for the card to finish ``value`` (a dataset's tensors)."""
    if isinstance(value, Dataset) and value.is_array:
        for dev in {t.device for t in _tensors(value.padded()) if t.device.type == "cuda"}:
            torch.cuda.synchronize(dev)


class _SourceDependent(Exception):
    pass


class _ScaledProfiler:
    """Executes the graph with dataset constants cut to n/scale examples,
    timing each operator and measuring its output (profileNodes:153-465).
    Each operator runs as a shallow copy, so the graph's own operators keep
    their state."""

    def __init__(self, graph: Graph, scale: int):
        self.graph = graph
        self.scale = scale
        self.times: Dict[NodeId, float] = {}
        self.sizes: Dict[NodeId, Tuple[float, float]] = {}
        self.sample_n: Dict[NodeId, int] = {}
        self._memo: Dict[NodeId, Expression] = {}

    def execute(self, nid: NodeId) -> Expression:
        if nid in self._memo:
            return self._memo[nid]
        op = self.graph.operators[nid]
        if isinstance(op, DatasetOperator):
            ds = op.dataset
            k = max(1, ds.n // self.scale)
            self.sample_n[nid] = k
            sample = Dataset.from_items(ds.take(k))
            expr: Expression = DatasetExpression.of(sample)
            self.sizes[nid] = _measure_size(sample)
            self.times[nid] = 0.0
        else:
            deps = [self.execute(d) for d in self.graph.dependencies[nid]
                    if isinstance(d, NodeId)]
            if len(deps) != len(self.graph.dependencies[nid]):
                raise _SourceDependent()  # reads a pipeline source: not profilable
            t0 = time.perf_counter()
            expr = copy.copy(op).execute(deps)
            value = expr.get()  # force
            _sync(value)
            self.times[nid] = (time.perf_counter() - t0) * 1e9
            self.sizes[nid] = _measure_size(value)
        self._memo[nid] = expr
        return expr


def profile_nodes(graph: Graph, nodes: List[NodeId], scales=DEFAULT_SAMPLE_SCALES
                  ) -> Dict[NodeId, Profile]:
    """Profile at each scale and extrapolate linearly to the full size
    (generalizeProfiles:104: per-node least squares of time and memory
    against scale). Each scale's pass is timed by a ``PhaseTimer``
    published into the global ``MetricsRegistry``
    (``keystone_phase_seconds_total{timer="auto_cache_profile"}``) and
    wrapped in a tracer span."""
    from keystone_tpu_torch.observability.tracing import get_tracer
    from keystone_tpu_torch.utils.profiling import PhaseTimer

    timer = PhaseTimer("auto_cache_profile")
    per_scale: Dict[int, _ScaledProfiler] = {}
    for scale in scales:
        prof = _ScaledProfiler(graph, scale)
        with timer.phase(f"scale_{scale}"), get_tracer().span(
            "auto_cache.profile", scale=scale, nodes=len(nodes)
        ):
            for n in nodes:
                try:
                    prof.execute(n)
                except _SourceDependent:
                    continue
        # keep the measurements, free the outputs before the next scale
        prof._memo.clear()
        per_scale[scale] = prof
    timer.publish()

    profiles: Dict[NodeId, Profile] = {}
    for n in nodes:
        xs, ts, dm, hm = [], [], [], []
        for scale, prof in per_scale.items():
            if n in prof.times:
                xs.append(1.0 / scale)  # fraction of the full data
                ts.append(prof.times[n])
                d, h = prof.sizes[n]
                dm.append(d)
                hm.append(h)
        if not xs:
            continue
        profiles[n] = Profile(_extrapolate(xs, ts), _extrapolate(xs, dm), _extrapolate(xs, hm))
    return profiles


def _extrapolate(fractions: List[float], values: List[float]) -> float:
    """Fit value = a + b·fraction and evaluate it at fraction 1."""
    if len(set(fractions)) == 1:
        return values[0] / fractions[0]
    b, a = np.polyfit(fractions, values, 1)
    return float(max(a + b, 0.0))


class AutoCacheRule(Rule):
    def __init__(self, strategy: str = "greedy", mem_budget_bytes: Optional[int] = None,
                 scales=DEFAULT_SAMPLE_SCALES):
        self.strategy = strategy
        self.mem_budget_bytes = mem_budget_bytes
        self.scales = scales

    # -- cache-set selection ----------------------------------------------

    def _budget(self) -> float:
        if self.mem_budget_bytes is not None:
            return float(self.mem_budget_bytes)
        from keystone_tpu_torch.observability.device import device_memory_stats

        stats = device_memory_stats()
        if stats is not None:
            return DEFAULT_BUDGET_FRACTION * (stats["bytes_limit"] - stats["bytes_in_use"])
        return DEFAULT_BUDGET_FRACTION * 8e9  # no card: the JAX package's host figure

    def aggressive_cache(self, graph: Graph, weights: Dict[NodeId, int]) -> Set[NodeId]:
        """Cache every node whose direct output is consumed more than once
        (the sum over its direct children of the child's weight, a sink
        counting 1), leaving out descendants of sources (test-time data;
        AutoCacheRule.aggressiveCache:503-518). Not the transitive run
        count: a node feeding one hot consumer is not cached, its consumer
        is."""
        source_desc: Set[NodeId] = set()
        for src in graph.sources:
            source_desc |= {d for d in get_descendants(graph, src) if isinstance(d, NodeId)}
        selected: Set[NodeId] = set()
        for n in graph.operators:
            if n in source_desc:
                continue
            total = 0
            for c in get_children(graph, n):
                total += weights.get(c, 1) if isinstance(c, NodeId) else 1
            if total > 1:
                selected.add(n)
        return selected

    def greedy_cache(self, graph: Graph, profiles: Dict[NodeId, Profile],
                     weights: Dict[NodeId, int]) -> Set[NodeId]:
        """Cache the node with the best runtime improvement, again and
        again, until nothing improves or the budget is spent
        (greedyCache:559-602, selectNext:542)."""
        budget = self._budget()
        cached: Set[NodeId] = set()
        used = 0.0
        while True:
            base = estimate_cached_runtime(graph, cached, profiles, weights)
            best, best_rt = None, base
            runs = get_runs(graph, cached, weights)
            for n, p in profiles.items():
                # only nodes still evaluated more than once that fit what
                # is left of the budget
                if n in cached or runs.get(n, 1) <= 1 or p.device_mem + used > budget:
                    continue
                rt = estimate_cached_runtime(graph, cached | {n}, profiles, weights)
                if rt < best_rt:
                    best, best_rt = n, rt
            if best is None:
                return cached
            cached.add(best)
            used += profiles[best].device_mem

    # -- graph surgery ----------------------------------------------------

    @staticmethod
    def add_caches(graph: Graph, cache_set: Set[NodeId]) -> Graph:
        """Insert a ``Cacher`` downstream of each selected node
        (addCachesToPipeline:492)."""
        from keystone_tpu_torch.ops.util.cacher import Cacher

        for n in sorted(cache_set):
            graph, cacher = graph.add_node(Cacher(), ())
            graph = graph.replace_dependency(n, cacher)
            graph = graph.set_dependencies(cacher, (n,))
        return graph

    def apply(self, graph: Graph, prefixes: PrefixMap) -> Tuple[Graph, PrefixMap]:
        from keystone_tpu_torch.ops.util.cacher import Cacher

        weights = get_node_weights(graph)
        already = {n for n, op in graph.operators.items() if isinstance(op, Cacher)}
        # candidates: nodes not cached already and not feeding a Cacher
        candidates = [
            n for n in sorted(graph.operators)
            if n not in already and not any(
                isinstance(c, NodeId) and isinstance(graph.operators.get(c), Cacher)
                for c in get_children(graph, n)
            )
        ]
        if self.strategy == "aggressive":
            to_cache = self.aggressive_cache(graph, weights) - already
            to_cache = {n for n in to_cache if n in candidates}
        else:
            profiles = profile_nodes(graph, candidates, self.scales)
            if logger.isEnabledFor(logging.INFO):
                for n in sorted(profiles):
                    p = profiles[n]
                    logger.info(
                        "auto-cache profile node %s [%s]: %.1f ms, %.0f device bytes, weight %d",
                        n, graph.operators[n].label, p.ns / 1e6, p.device_mem, weights.get(n, 1),
                    )
            to_cache = self.greedy_cache(graph, profiles, weights)
        logger.info("auto-cache decision (%s): caching %s", self.strategy,
                    sorted(to_cache) or "nothing")
        if not to_cache:
            return graph, prefixes
        return self.add_caches(graph, to_cache), prefixes
