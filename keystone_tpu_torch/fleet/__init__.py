"""Fleet tier: cross-host serving over N gateway processes (counterpart
of ``keystone_tpu/fleet``).

The single-host request plane (bucketed CUDA-graph engines behind
micro-batchers, shared-nothing ``EnginePool`` lanes, admission control,
one HTTP gateway) lives in ``gateway/`` and ``serving/``. This package is the first
multi-process layer above it — the ``EnginePool`` topology lifted to
HTTP distance, where a replica is a whole ``serve-gateway`` process:

- ``ReplicaRegistry`` / ``Replica`` (registry.py): membership (static
  ``--replica`` URLs + ``POST /registerz`` self-registration),
  background ``/readyz`` health probes (burn-state body and the
  ``X-Keystone-Load`` header included), scraped load, and request-path
  health with half-open recovery mirroring ``Lane.healthy``.
- ``RouterServer`` (router.py): least-loaded routing with
  retry-once-on-another-replica, typed ``Overloaded`` propagation
  (429/504/503 semantics survive the extra hop), **SLO federation**
  (``/metrics`` merges every replica's scrape so ``le``-bucket
  quantiles are true fleet quantiles; ``/slz`` burns a fleet-wide
  latency SLO over the merged buckets), the ``/fleetz`` roster, and
  the ``router.replica.blackhole`` chaos point on the forward path.

CLI: ``python -m keystone_tpu_torch serve-router --replica URL ...``;
on the card, ``chip_smoke.py`` phase 15 drives a router over two
``serve-gateway`` replicas and a zoo.
"""

from keystone_tpu_torch.fleet.registry import Replica, ReplicaRegistry
from keystone_tpu_torch.fleet.router import (
    ReplicaUnavailable,
    RouterMetrics,
    RouterServer,
)

__all__ = [
    "Replica",
    "ReplicaRegistry",
    "ReplicaUnavailable",
    "RouterMetrics",
    "RouterServer",
]
