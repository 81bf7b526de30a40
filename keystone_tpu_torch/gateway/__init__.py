"""Request gateway: the serving plane's front door (counterpart of
``keystone_tpu/gateway``, single-model mode).

- ``AdmissionController`` (admission.py): bounded queue, per-request
  deadline propagation, and load shedding with a typed ``Overloaded``
  error — beyond-capacity traffic is rejected immediately instead of
  collapsing latency for everyone.
- ``EnginePool`` (pool.py): N shared-nothing replica lanes (one
  micro-batcher + CUDA-graph engine pair each), least-loaded routing,
  per-lane health with half-open recovery, and retry-to-another-lane on
  lane failure.
- ``Gateway`` (lifecycle.py): build + warm lanes, the live autoscale
  loop (observed size histogram -> ``suggest_buckets`` -> warm
  replacement -> atomic swap -> drain), graceful shutdown on
  ``close()``/SIGTERM.
- ``GatewayServer`` (http.py): stdlib HTTP frontend — ``POST
  /predict``, ``GET /readyz``, ``GET /metrics``, ``POST /swap``,
  ``POST /drain`` and the rest of the JAX gateway's single-model routes.

Everything publishes through the observability plane:
``keystone_gateway_shed_total``, ``keystone_gateway_retries_total``,
``keystone_gateway_engine_swaps_total``, native-histogram queue-wait
and request-latency series, and ``gateway.admit`` spans parenting the
``microbatch.coalesce`` -> ``serving.dispatch`` chain.

The model zoo (``keystone_tpu_torch/zoo``), fleet registration
(``http.register_with_router``) and the online lifecycle's hooks
(``EnginePool.set_mirror``/``set_canary``, ``Gateway.build_model_batcher``
/``swap_model``, ``POST /feedback`` and ``/lifecyclez``) are ported;
model sharding and the AOT store are not.
"""

from keystone_tpu_torch.gateway.admission import AdmissionController, Overloaded
from keystone_tpu_torch.gateway.http import GatewayServer
from keystone_tpu_torch.gateway.lifecycle import Gateway
from keystone_tpu_torch.gateway.metrics import GatewayMetrics
from keystone_tpu_torch.gateway.pool import EnginePool, Lane

__all__ = [
    "AdmissionController",
    "EnginePool",
    "Gateway",
    "GatewayMetrics",
    "GatewayServer",
    "Lane",
    "Overloaded",
]
