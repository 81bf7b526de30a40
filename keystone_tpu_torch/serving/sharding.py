"""Declarative sharding of fitted-pipeline parameters (counterpart of
``keystone_tpu/serving/sharding.py``).

A **rule layer** maps regex patterns over the fitted pipeline's *named
parameters* to ``PartitionSpec``s, so any fitted pipeline gets a
partitioning without hand-written per-model specs:

- ``named_params`` walks the pipeline's topo-ordered operators and
  extracts every tensor- or array-valued field under a stable
  ``"<topo#>/<OpClass>/<field>"`` name — the namespace the rules match
  against (the same fields ``featurize.pipeline_token`` hashes);
- ``match_partition_rules(rules, params)`` resolves each named param to
  the first matching rule's spec. Scalars and one-element params always
  stay replicated. Unmatched params raise by default, or fall back to
  replicated under an explicit ``unmatched="replicate"``;
- ``make_shard_fns`` / ``make_gather_fns`` turn a spec tree into
  per-param placement callables, validating axis names, spec length and
  divisibility up front, by the param's name;
- ``DEFAULT_RULES``: 2-D weight matrices named ``W`` split on their
  last (output) axis over ``MODEL_AXIS``, everything else replicated;
- ``ParamBinder`` runs an engine-private copy of the pipeline with the
  placed params in place of the stored ones; the caller's fitted
  pipeline is never touched;
- ``sharding_token`` digests the resolved spec tree and the mesh shape
  for the AOT store's fingerprint (``aot.bucket_key``): a sharded
  engine never shares an entry with a replicated one.

**One card.** The port has no ``jax.sharding``: ``Mesh``, ``make_mesh``,
``set_mesh``, ``current_mesh`` and ``PartitionSpec`` (a tuple of mesh
axis names, or None, per dimension) are the port's own, from
``parallel/mesh.py``. The engine runs on one card, so its model axis
has size 1: every spec resolves and is validated against that size, and
each param is placed whole on the card, as a copy the engine owns. A
mesh asking for more devices than it is given raises (``make_mesh``);
an engine on a model axis wider than 1 raises too (``make_shard_fns``).
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from keystone_tpu_torch.parallel import mesh as mesh_lib
from keystone_tpu_torch.parallel.mesh import (  # noqa: F401  (the serving names)
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    PartitionSpec,
    current_mesh,
    make_mesh,
    set_mesh,
)


def local_devices() -> List[torch.device]:
    """The cards of this host, or the CPU when it has none."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


# regex -> PartitionSpec, first match wins, against the
# "<topo#>/<OpClass>/<field>" names of ``named_params``
PartitionRules = Sequence[Tuple[str, PartitionSpec]]

# every fitted linear map stores its weights as one (d_in, d_out)
# matrix named W: split the output axis over the model axis; the
# trailing catch-all replicates everything else
DEFAULT_RULES: PartitionRules = (
    (r"/W$", PartitionSpec(None, MODEL_AXIS)),
    (r".*", PartitionSpec()),
)


def _is_array(value: Any) -> bool:
    return isinstance(value, (torch.Tensor, np.ndarray, np.generic))


def _shape(value: Any) -> Tuple[int, ...]:
    return tuple(value.shape) if isinstance(value, torch.Tensor) else np.shape(value)


def _array_fields(op) -> List[Tuple[str, Any]]:
    """The array-valued parameter fields of one operator, in sorted
    field order: the declared dataclass fields (else ``__dict__``)
    without the underscore-prefixed caches."""
    from keystone_tpu_torch.serving.featurize import operator_state

    return [
        (name, value)
        for name, value in sorted(operator_state(op).items())
        if _is_array(value)
    ]


def _iter_param_sites(fitted):
    """``(op, field, name, value)`` for every array-valued operator
    field — the one walk behind ``named_params`` and ``ParamBinder``."""
    for i, nid in enumerate(fitted._topo):
        op = fitted.graph.operators[nid]
        for field, value in _array_fields(op):
            yield op, field, f"{i}/{type(op).__name__}/{field}", value


def named_params(fitted) -> Dict[str, Any]:
    """The fitted pipeline's parameters as a flat
    ``{"<topo#>/<OpClass>/<field>": tensor}`` dict, keyed by topo
    position (so two pipelines of one structure name theirs alike).
    Non-array fields (nested model objects, config scalars) are not
    extracted."""
    return {name: value for _, _, name, value in _iter_param_sites(fitted)}


def params_nbytes(params: Dict[str, Any]) -> int:
    """Total parameter bytes — what a replicated engine holds on the
    card (the number the placement plan's budget check compares)."""
    return sum(
        int(v.nbytes) if isinstance(v, torch.Tensor) else int(np.asarray(v).nbytes)
        for v in params.values()
    )


def match_partition_rules(
    rules: PartitionRules,
    params: Dict[str, Any],
    *,
    unmatched: str = "error",
) -> Dict[str, PartitionSpec]:
    """Resolve each named param to the first rule whose regex
    ``re.search``-matches its name. Scalars and one-element params are
    always replicated. Params no rule matches raise a ``ValueError``
    naming them (``unmatched="error"``) or are replicated
    (``unmatched="replicate"``)."""
    if unmatched not in ("error", "replicate"):
        raise ValueError(
            f"unmatched must be 'error' or 'replicate', got {unmatched!r}"
        )
    compiled = [(re.compile(pat), spec) for pat, spec in rules]
    specs: Dict[str, PartitionSpec] = {}
    missing: List[str] = []
    for name, value in params.items():
        shape = _shape(value)
        if len(shape) == 0 or int(np.prod(shape)) <= 1:
            specs[name] = PartitionSpec()
            continue
        for pat, spec in compiled:
            if pat.search(name) is not None:
                specs[name] = PartitionSpec(*spec)
                break
        else:
            if unmatched == "replicate":
                specs[name] = PartitionSpec()
            else:
                missing.append(name)
    if missing:
        raise ValueError(
            "no partition rule matched param(s) "
            f"{missing} — add a rule, or pass unmatched='replicate' "
            "to fall back to replication explicitly"
        )
    return specs


def _validate_spec(name: str, shape: Tuple[int, ...], spec, mesh: Mesh) -> None:
    """Axis names, spec length and divisibility, checked by the param's
    name."""
    entries = tuple(spec)
    if len(entries) > len(shape):
        raise ValueError(
            f"partition spec {spec} for {name} has more entries than "
            f"the param has dims ({shape})"
        )
    for dim, entry in enumerate(entries):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = 1
        for axis in axes:
            if axis not in mesh.shape:
                raise ValueError(
                    f"partition spec {spec} for {name} names mesh "
                    f"axis {axis!r}, but the mesh has {tuple(mesh.axis_names)}"
                )
            n *= mesh.shape[axis]
        if shape[dim] % n:
            raise ValueError(
                f"param {name} dim {dim} (size {shape[dim]}) does not "
                f"divide over {n} shards of mesh axis {entry!r} — "
                "pad the model dim or change the rule"
            )


def _spec_split(spec, mesh: Mesh) -> int:
    """How many pieces ``spec`` cuts a param into on ``mesh``."""
    n = 1
    for entry in spec:
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                n *= mesh.shape[axis]
    return n


def make_shard_fns(
    specs: Dict[str, PartitionSpec],
    mesh: Optional[Mesh] = None,
    device: Optional[torch.device] = None,
) -> Dict[str, Callable[[Any], torch.Tensor]]:
    """Per-param placement callables: each validates its spec against
    ``mesh`` and returns the param as a tensor of the engine's own on
    ``device`` (default: this process's device in the mesh). With a model axis of
    1 — one card — a spec cuts nothing and the param is placed whole;
    a spec that would cut a param across cards raises, since the port's
    engine runs one card."""
    mesh = mesh or current_mesh()
    dev = device if device is not None else mesh_lib.local_device(mesh)

    def make(name: str, spec: PartitionSpec):
        def shard_fn(value: Any) -> torch.Tensor:
            _validate_spec(name, _shape(value), spec, mesh)
            if _spec_split(spec, mesh) > 1:
                raise ValueError(
                    f"param {name}: spec {spec} splits it over "
                    f"{_spec_split(spec, mesh)} devices, but the port's "
                    "engine runs on one card (use a model axis of 1)"
                )
            t = value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
            return t.detach().to(dev, copy=True).contiguous()

        return shard_fn

    return {name: make(name, spec) for name, spec in specs.items()}


def make_gather_fns(
    specs: Dict[str, PartitionSpec],
    mesh: Optional[Mesh] = None,
) -> Dict[str, Callable[[Any], torch.Tensor]]:
    """The inverse placement: each callable hands its param back whole
    (here, on one card, the placed tensor is already whole: a copy on
    the same device)."""

    def make(name: str):
        def gather_fn(value: Any) -> torch.Tensor:
            return value.detach().clone()

        return gather_fn

    return {name: make(name) for name in specs}


def placed_shard_bytes(placed: Dict[str, torch.Tensor]) -> Dict[Any, int]:
    """Measured parameter bytes per device of a placed param tree,
    read off the tensors."""
    per_device: Dict[Any, int] = {}
    for t in placed.values():
        per_device[t.device] = per_device.get(t.device, 0) + int(t.nbytes)
    return per_device


def sharding_token(specs: Dict[str, PartitionSpec], mesh: Optional[Mesh] = None) -> str:
    """Content digest of a resolved partitioning: the spec of every
    named param and the mesh topology (axis names and sizes). The AOT
    store's fingerprint component for sharded engines."""
    mesh = mesh or current_mesh()
    h = hashlib.sha256()
    h.update(
        b"mesh<"
        + repr(tuple((str(a), int(s)) for a, s in mesh.shape.items())).encode()
        + b">"
    )
    for name in sorted(specs):
        h.update(f"p<{name}|{PartitionSpec(*specs[name])}>".encode())
    return h.hexdigest()


def _scrub_caches(op) -> None:
    """Drop an operator's underscore-prefixed caches (what it attached
    on first use); declared fields are untouched."""
    d = getattr(op, "__dict__", None)
    if not d:
        return
    for key in [k for k in d if k.startswith("_")]:
        del d[key]


class ParamBinder:
    """Runs a fitted pipeline with the named param values given in
    place of the stored ones: ``run(params, batch)``.

    The binder works on a PRIVATE copy of the pipeline (the same graph,
    shallow-copied operators without their caches): substitution sets
    operator fields, and the caller's fitted pipeline — shared by other
    lanes, and what ``pipeline_token`` fingerprints — must never see
    them change. Concurrent runs serialize on the binder's lock. Unlike
    the JAX binder, the caches a run fills are kept: on the card a
    bucket's warm pass fills them and its CUDA graph capture, which
    follows, must find no host work."""

    def __init__(self, fitted):
        ops = {nid: copy.copy(op) for nid, op in fitted.graph.operators.items()}
        for op in ops.values():
            _scrub_caches(op)
        graph = dataclasses.replace(fitted.graph, operators=ops)
        self._pipeline = type(fitted)(graph, fitted.source, fitted.sink)
        self._sites: List[Tuple[Any, str, str]] = []
        self.params: Dict[str, Any] = {}
        for op, field, name, value in _iter_param_sites(self._pipeline):
            self._sites.append((op, field, name))
            self.params[name] = value
        self._lock = threading.Lock()

    def run(self, params: Dict[str, Any], arr: Any) -> Any:
        """The pipeline's batched apply path with ``params`` substituted;
        the stored values are restored afterwards."""
        with self._lock:
            try:
                for op, field, name in self._sites:
                    setattr(op, field, params[name])
                return self._pipeline._batch_run(arr)
            finally:
                for op, field, name in self._sites:
                    setattr(op, field, self.params[name])


def resolve_param_sharding(
    param_sharding: Any,
    fitted,
    *,
    params: Optional[Dict[str, Any]] = None,
    unmatched: str = "error",
) -> Dict[str, PartitionSpec]:
    """An engine's ``param_sharding=`` as a resolved ``{name:
    PartitionSpec}``: ``True`` means ``DEFAULT_RULES``, a sequence of
    ``(regex, PartitionSpec)`` rules is matched against the named
    params, and a dict of resolved specs passes through (validated
    against the real names; unnamed params replicated)."""
    if params is None:
        params = named_params(fitted)
    if param_sharding is True:
        return match_partition_rules(DEFAULT_RULES, params, unmatched=unmatched)
    if isinstance(param_sharding, dict):
        unknown = sorted(set(param_sharding) - set(params))
        if unknown:
            raise ValueError(
                f"param_sharding names unknown params {unknown} "
                f"(have {sorted(params)})"
            )
        specs = {name: PartitionSpec() for name in params}
        specs.update({k: PartitionSpec(*v) for k, v in param_sharding.items()})
        return specs
    return match_partition_rules(param_sharding, params, unmatched=unmatched)


__all__ = [
    "DATA_AXIS",
    "DEFAULT_RULES",
    "MODEL_AXIS",
    "Mesh",
    "ParamBinder",
    "PartitionSpec",
    "current_mesh",
    "make_gather_fns",
    "make_mesh",
    "make_shard_fns",
    "match_partition_rules",
    "named_params",
    "params_nbytes",
    "placed_shard_bytes",
    "resolve_param_sharding",
    "set_mesh",
    "sharding_token",
]
