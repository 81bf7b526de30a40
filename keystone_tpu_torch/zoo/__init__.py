"""Model-zoo serving plane: many named models behind one port
(counterpart of ``keystone_tpu/zoo``).

The paper's query-optimizer ideas pointed at serving (ROADMAP
"multi-model serving with a cost-based placement optimizer"):

- ``zoo/registry.py`` — ``ModelSpec``/``ModelRegistry``: named model
  specs (pipeline factory, buckets, lanes, SLO, optional featurize/
  sharding) plus the JSON spec format ``serve-gateway --zoo`` loads.
- ``zoo/host.py`` — ``ModelZoo``: hosts one ``Gateway`` per model (or
  per CSE group) with LRU resident-set paging with pinning, and
  ``model``-labeled zoo metrics.
- ``zoo/optimizer.py`` — the pure placement planner: per-bucket cost
  models + request-size histograms + the per-card memory budget in,
  ``PlacementPlan`` (buckets / lanes / replicated-vs-sharded) out.
- ``zoo/cse.py`` — cross-model featurize CSE: co-hosted models whose
  fused featurize chains carry identical ``featurize_token``s share ONE
  multi-head engine that computes the prefix once per window, one CUDA
  graph per bucket.
"""

from keystone_tpu_torch.zoo.cse import SharedPrefixEngine, featurize_groups
from keystone_tpu_torch.zoo.host import ModelZoo
from keystone_tpu_torch.zoo.optimizer import (
    ChipBudget,
    ModelPlacement,
    ModelProfile,
    PlacementPlan,
    plan_placement,
)
from keystone_tpu_torch.zoo.registry import (
    BuiltModel,
    ModelRegistry,
    ModelSpec,
    UnknownModel,
    load_zoo_spec,
)

__all__ = [
    "BuiltModel",
    "ChipBudget",
    "ModelPlacement",
    "ModelProfile",
    "ModelRegistry",
    "ModelSpec",
    "ModelZoo",
    "PlacementPlan",
    "SharedPrefixEngine",
    "UnknownModel",
    "featurize_groups",
    "load_zoo_spec",
    "plan_placement",
]
