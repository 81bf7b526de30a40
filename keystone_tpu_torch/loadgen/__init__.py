"""Trace-driven load generation and the chaos harness (counterpart of
``keystone_tpu/loadgen``).

- ``trace`` — parse the gateway's ``--request-log`` JSONL into
  replayable events; synthesize open-loop workloads (Poisson /
  heavy-tail lognormal / Pareto arrivals, step ramps, request-size
  mixtures, deadline distributions). numpy only.
- ``runner`` — open-loop replay against a live gateway (HTTP, or a
  ``Gateway`` object in-process), preserving recorded inter-arrival
  gaps with a ``speed`` factor and arming a chaos timeline as it runs.
- ``faults`` — the process-global ``FaultInjector``: named fault points
  compiled into the hot paths as default-off no-ops, armable via code,
  ``KEYSTONE_FAULTS`` or ``POST /chaosz``.
- ``invariants`` — the verdict: every admitted request resolves,
  failures are typed sheds only, readiness and p99 recover after the
  fault clears, shed rate stays in bounds.

``python -m keystone_tpu_torch serve-loadgen`` is the CLI
(``loadgen/cli.py``).

Import weight: the serving hot paths (``gateway/pool.py``,
``serving/engine.py``, ``serving/pipeline.py``,
``observability/otlp.py``) import this package for ``faults`` alone, so
only ``faults`` loads eagerly — the driver half (trace parsing, the
runner, the checker, the CLI) resolves lazily through the module's
``__getattr__`` and never rides along into a serving process that does
not use it.
"""

from keystone_tpu_torch.loadgen import faults
from keystone_tpu_torch.loadgen.faults import (
    FAULT_POINTS,
    FaultInjected,
    FaultInjector,
    FaultSpec,
)

# lazy attribute -> owning submodule (the driver half of the package)
_LAZY = {
    "trace": None,
    "runner": None,
    "invariants": None,
    "cli": None,
    "TraceEvent": "trace",
    "collapse_posts": "trace",
    "load_trace": "trace",
    "parse_request_log": "trace",
    "synthesize": "trace",
    "FaultPlan": "runner",
    "HttpTarget": "runner",
    "InprocTarget": "runner",
    "LoadGenerator": "runner",
    "LoadReport": "runner",
    "RequestRecord": "runner",
    "InvariantChecker": "invariants",
    "InvariantResult": "invariants",
    "Verdict": "invariants",
}

__all__ = sorted(
    ["FAULT_POINTS", "FaultInjected", "FaultInjector", "FaultSpec",
     "faults"] + list(_LAZY)
)


def __getattr__(name):
    target = _LAZY.get(name, "missing")
    if target == "missing":
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        )
    import importlib

    module = importlib.import_module(
        f"keystone_tpu_torch.loadgen.{target or name}"
    )
    return module if target is None else getattr(module, name)
