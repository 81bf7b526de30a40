"""Cross-model featurize CSE: compute shared prefixes once per window
(counterpart of ``keystone_tpu/zoo/cse.py``).

KeystoneML's rule engine deduplicates common subexpressions across a
training DAG; the serving-plane analogue is co-hosted models whose
fused featurize chains are the SAME chain. Detection is by content,
not by name: two models share a prefix iff their featurize pipelines'
``featurize_token``s — the SHA-256 digest of operator classes, wiring,
and every parameter tensor (``serving/featurize.pipeline_token``) — are
equal (``featurize_groups``).

``SharedPrefixEngine`` then hosts one whole group behind one engine:
each bucket's ``_run_bucket`` computes ``feat = featurize(raw)`` ONCE
and fans the activations out to every member's head, in sorted model
order —

    {model_a: head_a(feat), model_b: head_b(feat), ...}

— and on the card that whole function is captured as ONE CUDA graph per
bucket (``serving/engine.py``), so a shared replay launches the
featurize chain's kernels (B1, B2) as often as one solo flagship replay
does. Dict outputs ride the window plumbing: the engine clones every
leaf of the graph's static output, the lanes copy every leaf to the
host, and each request's future resolves to its own row of every head;
the zoo picks (or fans out) from it. The engine's own compile/dispatch
counters are the measurement seam: one capture per bucket and one
dispatch per window for the whole group, where solo hosting pays one of
each PER MODEL.

``split_cost_model`` returns ``(prefix_flops, {model: head_flops})`` for
a bucket, as the JAX package's does: the bucket's counted run (the warm
pass, ``observability/device.CostCounter``) counts the prefix and each
head in a ``cost_section`` of their own, where JAX lowers them apart.
Per-model attribution over a shared engine then weighs each window by
that split (``observability/attribution.EngineAttribution``); before a
bucket's counted run it is None and the weights are row shares. The AOT store is
kept off here, as in the JAX package (a group's entries would key on
one head's token). ``param_sharding`` binds one pipeline and raises,
as in the JAX package; ``head_sharding`` (``{model: param_sharding}``)
shards the heads that ask, each through its own ``ParamBinder`` on
params the engine placed, over the process mesh.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

from keystone_tpu_torch.observability.attribution import RowClaimQueue
from keystone_tpu_torch.observability.device import cost_section
from keystone_tpu_torch.serving.engine import CompiledPipeline
from keystone_tpu_torch.serving.featurize import featurize_token

logger = logging.getLogger(__name__)


def featurize_groups(
    featurizers: Dict[str, Any]
) -> List[Tuple[str, ...]]:
    """Group model ids by identical featurize token. ``featurizers``
    maps model id -> fitted featurize pipeline (models without one
    simply aren't candidates — pass only those that have one). Returns
    sorted id tuples, groups of one included: the caller decides that
    only len >= 2 groups earn a shared engine."""
    by_token: Dict[str, List[str]] = {}
    for model_id in sorted(featurizers):
        fitted = featurizers[model_id]
        try:
            token = featurize_token(fitted)
        except Exception:
            # an unfingerprintable chain can't PROVE it equals another,
            # so it never shares
            logger.info(
                "cse: featurize of %s not fingerprintable; hosting "
                "solo", model_id, exc_info=True,
            )
            token = f"_unhashable:{model_id}"
        by_token.setdefault(token, []).append(model_id)
    return sorted(
        tuple(ids) for ids in by_token.values()
    )


class SharedPrefixEngine(CompiledPipeline):
    """One engine serving a whole CSE group. ``heads`` maps model id
    -> fitted head pipeline; ``featurize`` is the group's (verified
    identical) fused prefix. Outputs are dicts keyed by model id, one
    entry per head, from one CUDA graph per bucket (eagerly on the
    CPU)."""

    def __init__(
        self,
        featurize,
        heads: Dict[str, Any],
        buckets: Sequence[int],
        head_sharding: Optional[Dict[str, Any]] = None,
        **kwargs,
    ):
        if featurize is None:
            raise ValueError(
                "SharedPrefixEngine needs the shared featurize prefix"
            )
        if len(heads) < 1:
            raise ValueError("need at least one head")
        # deterministic head order: the captured graph's output dict
        # must not depend on dict insertion order at the call site
        self.heads = {mid: heads[mid] for mid in sorted(heads)}
        kwargs.pop("aot_store", None)
        # param sharding binds ONE pipeline's params; host sharded
        # models solo instead of silently sharding only the primary head
        if kwargs.get("param_sharding"):
            raise ValueError(
                "SharedPrefixEngine does not compose with "
                "param_sharding; host sharded models solo"
            )
        kwargs.pop("param_sharding", None)
        super().__init__(
            next(iter(self.heads.values())),
            buckets,
            featurize=featurize,
            aot_store=None,
            **kwargs,
        )
        # model -> (binder, placed params) of every sharded head
        self._head_binders: Dict[str, Tuple[Any, Dict[str, Any]]] = {}
        for mid, spec in (head_sharding or {}).items():
            if spec and mid in self.heads:
                from keystone_tpu_torch.serving import sharding as sharding_lib

                mesh = sharding_lib.current_mesh()
                binder = sharding_lib.ParamBinder(self.heads[mid])
                specs = sharding_lib.resolve_param_sharding(
                    spec, self.heads[mid], params=binder.params
                )
                fns = sharding_lib.make_shard_fns(specs, mesh, self.device)
                self._head_binders[mid] = (
                    binder, {n: fn(binder.params[n]) for n, fn in fns.items()}
                )
        # bucket -> (prefix flops, {model: head flops}) of its counted run
        self._split_costs: Dict[int, Tuple[float, Dict[str, float]]] = {}
        # row claims enqueued at submit time (by the zoo, or directly
        # when the engine is driven standalone), drained FIFO per
        # dispatched window; the zoo replaces this with a UNIT-level
        # queue shared across lanes
        self.claims = RowClaimQueue()

    # -- attribution seams -------------------------------------------------

    def claim_rows(self, model_id: str, rows: float) -> None:
        """Declare that ``rows`` of upcoming window traffic belong to
        ``model_id``."""
        self.claims.claim(model_id, rows)

    def drain_claims(self, n_valid: float) -> Dict[str, float]:
        """Consume claims covering ``n_valid`` dispatched rows ->
        ``{model: rows}`` (see ``RowClaimQueue.drain``)."""
        return self.claims.drain(n_valid)

    def split_cost_model(
        self, bucket: int
    ) -> Optional[Tuple[float, Dict[str, float]]]:
        """``(prefix_flops, {model: head_flops})`` for one bucket, or None
        before its counted run (attribution then splits by row share)."""
        return self._split_costs.get(bucket)

    def _set_cost_model(self, bucket: int, counter) -> None:
        super()._set_cost_model(bucket, counter)
        prefix = counter.sections.get("prefix", {}).get("flops", 0.0)
        heads = {mid: counter.sections.get(("head", mid), {}).get("flops", 0.0)
                 for mid in self.heads}
        if prefix > 0 and any(heads.values()):
            self._split_costs[bucket] = (prefix, heads)

    def _run_bucket(self, staged: Any) -> Any:
        """The shared prefix once, then every head on its output (each a
        ``cost_section`` of a counted run)."""
        with cost_section("prefix"):
            feat = self.featurize._batch_run(staged)
        out = {}
        for mid, head in self.heads.items():
            bound = self._head_binders.get(mid)
            with cost_section(("head", mid)):
                out[mid] = bound[0].run(bound[1], feat) if bound else head._batch_run(feat)
        return out


__all__ = ["SharedPrefixEngine", "featurize_groups"]
