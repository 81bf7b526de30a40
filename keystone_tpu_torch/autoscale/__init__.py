"""Fleet elasticity (counterpart of ``keystone_tpu/autoscale``): the
control loop over the fleet tier's primitives — the
``--register``/``{"listening": ...}`` handshake makes a replica
spawnable and routable without port races, the router's federated
``/metrics`` and ``/slz`` say how the FLEET is doing, the per-request
phase decomposition says *where* latency goes, and a shared AOT store
(``serving/aot.py``) gives a new replica its kernel libraries and
bucket entries:

- ``supervisor.py`` — replica processes as a managed set: spawn
  ``serve-gateway`` subprocesses (or in-process replicas for the
  tests), retire through the graceful deregister → drain → exit
  protocol, replace the dead.
- ``policy.py`` — the pure decision engine: SLO burn, fleet p99,
  per-replica load and phase attribution (scale out only when
  ``queue_wait`` dominates), with hysteresis, per-direction cooldowns,
  min/max bounds, and a scale-down ban while any replica is half-open.
- ``controller.py`` — the tick: scrape, decide, converge; every
  decision a structured event, ``keystone_autoscale_*`` series and an
  ``autoscale.decision`` span.
- ``planner.py`` — ``serve-capacity-plan``: replay a workload ×1..×N
  against 1..K replicas, fit replicas against offered load, derive the
  policy's thresholds.
- ``cli.py`` — ``serve-autoscale``: router, supervisor and loop in one
  command.

On one H100 every replica shares the card: the fleet scales the host's
request path (HTTP, JSON decode), which PERF.md measures.

Exports resolve lazily (``__getattr__``): importing the package loads
no submodule.
"""

_LAZY = {
    "Decision": "policy",
    "FleetObservation": "policy",
    "PolicyConfig": "policy",
    "PolicyEngine": "policy",
    "phase_shares": "policy",
    "InprocLauncher": "supervisor",
    "SubprocessLauncher": "supervisor",
    "Supervisor": "supervisor",
    "deregister_replica": "supervisor",
    "Autoscaler": "controller",
    "AutoscaleMetrics": "controller",
    "RouterScraper": "controller",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"keystone_tpu_torch.autoscale.{target}"), name)
