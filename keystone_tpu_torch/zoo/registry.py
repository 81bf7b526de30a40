"""ModelSpec + ModelRegistry: the zoo's naming plane (counterpart of
``keystone_tpu/zoo/registry.py``).

A ``ModelSpec`` is everything the zoo needs to host one named model:
a build callable (deferred — params materialize when the spec is
first hosted, not when the registry is assembled), bucket list, lane
count, SLO, optional device-side featurize and param sharding, and
the placement hints the optimizer reads (an expected request-size
histogram, pinning). The ``ModelRegistry`` is an insertion-ordered,
duplicate-rejecting id -> spec map with one DEFAULT model (bare
``/predict`` keeps serving it, so a single-model deployment upgrades
to a zoo without breaking its clients).

``load_zoo_spec`` parses the JSON file ``serve-gateway --zoo`` takes:

    {"models": [
        {"name": "alpha", "d": 64, "hidden": 128, "depth": 2,
         "seed": 1, "buckets": [8, 32], "lanes": 2, "default": true,
         "pinned": true, "slo_latency_ms": 250,
         "expected_sizes": {"1": 500, "8": 120}},
        {"name": "beta-flagship", "device_featurize": "flagship",
         "img": 34, "hidden": 64, "depth": 2, "buckets": [4, 8]}
    ]}

Each entry builds the same demo pipelines the bench/CLI stack already
serves (``serving/bench.build_pipeline``, ``serving/featurize``), with
the JAX package's seeds, so a spec file builds the same parameters in
both packages; real deployments register their own fitted pipelines
through the Python API instead of the JSON shorthand. ``load_zoo_spec``
takes the ``device`` the models are built on (``None`` means ``cuda``,
resolved when a model is first built); the warmup examples are torch
tensors of the JAX package's shapes and dtypes.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np

# a model id rides in URL paths (/predict/<model>), Prometheus label
# values, and AOT store namespaces — one conservative charset covers
# all three
_ID_RE = re.compile(r"[A-Za-z0-9][A-Za-z0-9_.-]{0,63}")


class UnknownModel(KeyError):
    """A model id the registry doesn't know. Carries the registered
    ids so the HTTP layer can return the typed 404 body without a
    second registry round-trip."""

    def __init__(self, model_id: str, registered: Tuple[str, ...]):
        self.model_id = model_id
        self.registered = tuple(registered)
        super().__init__(
            f"unknown model {model_id!r} (registered: "
            f"{', '.join(registered) or 'none'})"
        )


@dataclasses.dataclass(eq=False)
class BuiltModel:
    """What ``ModelSpec.build()`` returns: the fitted model head and
    (optionally) the fitted featurize chain fused in front of it. One
    callable returns both because they couple — the head's input dim
    IS the featurizer's output dim."""

    fitted: Any
    featurize: Any = None


@dataclasses.dataclass(eq=False)
class ModelSpec:
    """One named model's hosting contract.

    ``build`` runs when the model first pages in (and only then —
    registering a 100-model zoo must not materialize 100 parameter
    sets). ``expected_sizes`` seeds the placement optimizer before any
    live histogram exists; ``pinned`` exempts the model from LRU
    eviction. ``param_sharding`` (the spec's ``shard_model``) shards
    the model's params over the process mesh (``serving/sharding.py``;
    on one card, placed whole)."""

    model_id: str
    build: Callable[[], BuiltModel]
    buckets: Tuple[int, ...] = (8, 32, 128)
    lanes: int = 2
    input_dtype: Any = np.float32
    warmup_example: Any = None
    param_sharding: Any = None
    slo_latency_s: Optional[float] = None
    max_delay_ms: float = 5.0
    pipeline_depth: int = 2
    pinned: bool = False
    default: bool = False
    expected_sizes: Dict[int, int] = dataclasses.field(
        default_factory=dict
    )

    def __post_init__(self):
        if not _ID_RE.fullmatch(self.model_id or ""):
            raise ValueError(
                f"model id {self.model_id!r} must match "
                f"{_ID_RE.pattern} (it names URL routes, metric "
                "labels, and AOT namespaces)"
            )
        self.buckets = tuple(sorted(set(int(b) for b in self.buckets)))
        if not self.buckets or any(b <= 0 for b in self.buckets):
            raise ValueError(
                f"model {self.model_id}: buckets must be positive, "
                f"got {self.buckets}"
            )
        if self.lanes < 1:
            raise ValueError(
                f"model {self.model_id}: need at least one lane"
            )
        self.expected_sizes = {
            int(k): int(v) for k, v in self.expected_sizes.items()
        }


class ModelRegistry:
    """Insertion-ordered id -> ``ModelSpec`` map. The DEFAULT model —
    the first spec flagged ``default=True``, else the first registered
    — is what bare ``/predict`` serves."""

    def __init__(self, specs: Tuple[ModelSpec, ...] = ()):
        self._specs: Dict[str, ModelSpec] = {}
        for spec in specs:
            self.register(spec)

    def register(self, spec: ModelSpec) -> ModelSpec:
        if spec.model_id in self._specs:
            raise ValueError(
                f"model {spec.model_id!r} already registered"
            )
        if spec.default and any(
            s.default for s in self._specs.values()
        ):
            raise ValueError(
                f"model {spec.model_id!r}: a default model is already "
                "registered"
            )
        self._specs[spec.model_id] = spec
        return spec

    def get(self, model_id: str) -> ModelSpec:
        spec = self._specs.get(model_id)
        if spec is None:
            raise UnknownModel(model_id, self.ids())
        return spec

    def ids(self) -> Tuple[str, ...]:
        return tuple(self._specs)

    @property
    def default_id(self) -> Optional[str]:
        for spec in self._specs.values():
            if spec.default:
                return spec.model_id
        return next(iter(self._specs), None)

    def __len__(self) -> int:
        return len(self._specs)

    def __iter__(self) -> Iterator[ModelSpec]:
        return iter(self._specs.values())

    def __contains__(self, model_id: str) -> bool:
        return model_id in self._specs


# -- the serve-gateway --zoo JSON format -----------------------------------

def _entry_to_spec(entry: Dict[str, Any], device=None) -> ModelSpec:
    import torch

    name = entry.get("name")
    if not name:
        raise ValueError(f"zoo spec entry missing 'name': {entry}")
    d = int(entry.get("d", 64))
    hidden = int(entry.get("hidden", 128))
    depth = int(entry.get("depth", 2))
    seed = int(entry.get("seed", 0))
    feat_kind = entry.get("device_featurize")
    img = int(entry.get("img", 16))
    if feat_kind not in (None, "demo", "flagship"):
        raise ValueError(
            f"model {name}: device_featurize must be 'demo' or "
            f"'flagship', got {feat_kind!r}"
        )

    def build() -> BuiltModel:
        # deferred: assembling a registry touches no device; params
        # materialize at page-in
        from keystone_tpu_torch.serving.bench import build_pipeline
        from keystone_tpu_torch.serving.featurize import (
            build_featurize_pipeline,
            build_flagship_featurize_pipeline,
        )

        featurize = None
        model_d = d
        if feat_kind == "demo":
            featurize, model_d = build_featurize_pipeline(
                img=img, device=device
            )
        elif feat_kind == "flagship":
            featurize, model_d = build_flagship_featurize_pipeline(
                img=img, device=device
            )
        fitted = build_pipeline(
            d=model_d, hidden=hidden, depth=depth, seed=seed,
            device=device,
        )
        return BuiltModel(fitted=fitted, featurize=featurize)

    if feat_kind is not None:
        warmup = torch.zeros((img, img, 3), dtype=torch.uint8)
        input_dtype = np.uint8
    else:
        warmup = torch.zeros((d,), dtype=torch.float32)
        input_dtype = np.float32
    slo_ms = entry.get("slo_latency_ms")
    return ModelSpec(
        model_id=str(name),
        build=build,
        buckets=tuple(entry.get("buckets", (8, 32, 128))),
        lanes=int(entry.get("lanes", 2)),
        input_dtype=input_dtype,
        warmup_example=warmup,
        param_sharding=(
            True if entry.get("shard_model") else None
        ),
        slo_latency_s=(
            float(slo_ms) / 1e3 if slo_ms is not None else None
        ),
        max_delay_ms=float(entry.get("max_delay_ms", 5.0)),
        pipeline_depth=int(entry.get("pipeline_depth", 2)),
        pinned=bool(entry.get("pinned", False)),
        default=bool(entry.get("default", False)),
        expected_sizes=dict(entry.get("expected_sizes", {})),
    )


def load_zoo_spec(path: str, device=None) -> ModelRegistry:
    """Parse a ``--zoo`` JSON spec file into a ``ModelRegistry`` whose
    models build on ``device`` (``None`` means ``cuda``)."""
    with open(path) as f:
        doc = json.load(f)
    models = doc.get("models")
    if not models:
        raise ValueError(f"zoo spec {path}: no 'models' entries")
    reg = ModelRegistry()
    for entry in models:
        reg.register(_entry_to_spec(entry, device))
    return reg


__all__ = [
    "BuiltModel",
    "ModelRegistry",
    "ModelSpec",
    "UnknownModel",
    "load_zoo_spec",
]
