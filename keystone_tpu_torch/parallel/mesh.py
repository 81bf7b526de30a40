"""The device mesh and its collectives (counterpart of
``keystone_tpu/parallel/mesh.py``).

The port runs one process per device (SPMD, as the JAX package runs one
process per host): ``runtime.initialize`` joins the processes into one
``torch.distributed`` group, NCCL on the cards and gloo on the CPU. A
``Mesh`` is a grid of those processes' global ranks, each with its
device, under JAX's axis names:

- ``DATA_AXIS`` ("data"): examples are sharded along this axis, the
  reference's RDD partitioning of rows (workflow/Transformer.scala:46);
- ``MODEL_AXIS`` ("model"): the feature/model-block axis (VectorSplitter);
- ``DCN_AXIS`` ("dcn", ``runtime.make_multislice_mesh``): the node axis.
  The example axis shards over ("dcn", "data") jointly.

Each axis line has its own process group, made on first use by every
rank in the same order (``group``). A reduction over the example axis
sums on each rank, then ``all_reduce``s over ``example_group``; the small
solves after it run on every rank from the same reduced bytes (the JAX
package's "replicated small computation", ``runtime.py:11-12``).

By default the mesh spans every rank of the process group, and one
process that joined no group is a 1 x 1 mesh of its own device, where
every collective here is the identity. A mesh can also hold several
devices of one process (``make_mesh(devices=...)``): the serving engine's
partition specs are validated against it, but rows shard only over
distinct processes (``shard_index``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
DCN_AXIS = "dcn"

# the ROADMAP item a model axis across processes waits for
MODEL_AXIS_ITEM = "ROADMAP A9, the model axis across processes"
# and the one the fits of one whole sample on sharded rows wait for
ONE_SAMPLE_ITEM = "ROADMAP A12, the one-sample fits on sharded rows"


class PartitionSpec(tuple):
    """Per-dimension mesh axis names (``None`` = not split), as
    ``jax.sharding.PartitionSpec``: ``PartitionSpec()`` is replicated,
    ``PartitionSpec(None, "model")`` splits the last of two dims over
    the model axis."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec({', '.join(repr(e) for e in self)})"

    __str__ = __repr__


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A partition spec over a mesh (``jax.sharding.NamedSharding``)."""

    mesh: "Mesh"
    spec: PartitionSpec


def _nested(a: np.ndarray):
    return tuple(_nested(x) for x in a) if a.ndim > 1 else tuple(a.tolist())


class Mesh:
    """A grid of processes: ``ranks[i][j]...`` is the global rank at that
    position and ``devices[i][j]...`` its device, one grid axis per name
    in ``axis_names``. ``ranks=None`` puts every position in this
    process."""

    def __init__(self, devices, axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS),
                 ranks=None):
        from keystone_tpu_torch.parallel import runtime

        dev = np.asarray(devices, dtype=object)
        if ranks is None:
            ranks = np.full(dev.shape, runtime.process_index(), dtype=np.int64)
        self._ranks = np.asarray(ranks, dtype=np.int64).reshape(dev.shape)
        if dev.ndim != len(axis_names):
            raise ValueError(f"a mesh of {dev.ndim} dims needs as many axis names, got {axis_names}")
        self.axis_names = tuple(axis_names)
        self.devices = _nested(dev)
        self._groups: Dict[Tuple[str, ...], Tuple[Optional[object], List[int]]] = {}

    @property
    def ranks(self):
        return _nested(self._ranks)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self._ranks.shape))

    @property
    def size(self) -> int:
        return int(self._ranks.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.ranks})"


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    devices: Optional[Sequence[torch.device]] = None,
    ranks: Optional[Sequence[int]] = None,
) -> Mesh:
    """A (data, model) mesh. By default over every rank of the process
    group, each with its device (one process that joined none: its own
    device); ``ranks`` picks some of them; ``devices`` alone builds a
    mesh of this process's devices. Raises when they cannot fill it."""
    from keystone_tpu_torch.parallel import runtime

    if devices is None:
        every = runtime.process_devices()
        ranks = list(range(len(every))) if ranks is None else list(ranks)
        devices = [every[r] for r in ranks]
    devs = list(devices)
    if n_model < 1:
        raise ValueError(f"model axis must be >= 1, got {n_model}")
    if n_model > len(devs):
        raise ValueError(
            f"a model axis of {n_model} needs {n_model} devices; this host "
            f"has {len(devs)} ({', '.join(str(d) for d in devs)})"
        )
    if n_data is None:
        n_data = len(devs) // n_model
    if n_data * n_model != len(devs):
        raise ValueError(f"mesh {n_data}x{n_model} != {len(devs)} devices")
    grid = np.empty((n_data, n_model), dtype=object)
    grid.reshape(-1)[:] = devs
    rgrid = None if ranks is None else np.asarray(ranks).reshape(n_data, n_model)
    return Mesh(grid, (DATA_AXIS, MODEL_AXIS), rgrid)


_current_mesh: Optional[Mesh] = None


def current_mesh() -> Mesh:
    """The active mesh: the one ``use_mesh``/``set_mesh`` set, else every
    rank on the data axis."""
    global _current_mesh
    if _current_mesh is None:
        _current_mesh = make_mesh()
    return _current_mesh


@contextlib.contextmanager
def use_mesh(mesh: Mesh) -> Iterator[Mesh]:
    global _current_mesh
    prev = _current_mesh
    _current_mesh = mesh
    try:
        yield mesh
    finally:
        _current_mesh = prev


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _current_mesh
    _current_mesh = mesh


def _example_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The axes the example dimension shards over: ("dcn", "data") on a
    multi-node mesh, ("data",) otherwise."""
    return (DCN_AXIS, DATA_AXIS) if DCN_AXIS in mesh.axis_names else (DATA_AXIS,)


def data_sharding(mesh: Optional[Mesh] = None, ndim: int = 2) -> NamedSharding:
    """The leading (example) axis over the data axes, the rest replicated."""
    mesh = mesh or current_mesh()
    axes = _example_axes(mesh)
    spec = PartitionSpec(axes if len(axes) > 1 else axes[0], *([None] * (ndim - 1)))
    return NamedSharding(mesh, spec)


def replicated_sharding(mesh: Optional[Mesh] = None) -> NamedSharding:
    mesh = mesh or current_mesh()
    return NamedSharding(mesh, PartitionSpec())


def n_data_shards(mesh: Optional[Mesh] = None) -> int:
    mesh = mesh or current_mesh()
    shape = mesh.shape
    return int(np.prod([shape[a] for a in _example_axes(mesh)]))


# -- this process's place in a mesh -----------------------------------------


def _my_positions(mesh: Mesh) -> np.ndarray:
    from keystone_tpu_torch.parallel import runtime

    me = runtime.process_index()
    pos = np.argwhere(mesh._ranks == me)
    if not len(pos):
        raise ValueError(f"process {me} is not in {mesh}")
    return pos


def local_device(mesh: Optional[Mesh] = None) -> torch.device:
    """This process's device in ``mesh`` (its first position)."""
    mesh = mesh or current_mesh()
    idx = tuple(_my_positions(mesh)[0])
    d = mesh.devices
    for i in idx:
        d = d[i]
    return d


def require_data_parallel(mesh: Mesh) -> None:
    """Raise unless rows can shard over ``mesh``: a model axis of 1 (the
    model axis across processes is the next slice)."""
    if mesh.shape.get(MODEL_AXIS, 1) > 1:
        raise NotImplementedError(
            f"a collective fit over a model axis of {mesh.shape[MODEL_AXIS]} is not "
            f"ported yet ({MODEL_AXIS_ITEM}); use a mesh with a model axis of 1"
        )


def shard_index(mesh: Optional[Mesh] = None) -> int:
    """This process's shard along the example axes ("dcn"-major). Raises
    when it holds more than one: rows shard over processes, one device
    each (launch one process per card)."""
    mesh = mesh or current_mesh()
    axes = [mesh.axis_names.index(a) for a in _example_axes(mesh)]
    coords = {tuple(p[axes]) for p in _my_positions(mesh)}
    if len(coords) > 1:
        raise ValueError(
            f"this process holds {len(coords)} shards of {mesh}; the port runs one "
            "process per device (torchrun --nproc-per-node N, or parallel.virtual.launch)"
        )
    (coord,) = coords
    sizes = [mesh._ranks.shape[a] for a in axes]
    return int(np.ravel_multi_index(coord, sizes))


def group(mesh: Mesh, axes: Sequence[str]):
    """This process's group along ``axes`` and that line's ranks in mesh
    order. Every line's group is made the first time any rank asks (all
    ranks ask in the same order: SPMD); a line over the whole world in
    rank order is the default group. ``(None, [rank])`` without a process
    group."""
    from keystone_tpu_torch.parallel import runtime

    axes = tuple(axes)
    if axes in mesh._groups:
        return mesh._groups[axes]
    me = runtime.process_index()
    if not dist.is_initialized():
        line = [me] * int(np.prod([mesh.shape[a] for a in axes]))
        mesh._groups[axes] = (None, line)
        return mesh._groups[axes]
    idx = [mesh.axis_names.index(a) for a in axes]
    rest = [i for i in range(len(mesh.axis_names)) if i not in idx]
    lines = np.transpose(mesh._ranks, rest + idx).reshape(-1, int(np.prod([mesh._ranks.shape[i] for i in idx])))
    world = dist.get_world_size()
    mine = None
    for line in lines.tolist():
        if len(set(line)) != len(line):
            raise ValueError(f"a process appears twice along {axes} of {mesh}")
        g = dist.group.WORLD if line == list(range(world)) else dist.new_group(sorted(line))
        if me in line:
            mine = (g, line)
    if mine is None:
        raise ValueError(f"process {me} is not in {mesh}")
    mesh._groups[axes] = mine
    return mine


def example_group(mesh: Mesh):
    """The group of this process's line along the example axes."""
    return group(mesh, _example_axes(mesh))


# -- collectives over the example axes --------------------------------------

# calls, bytes and the largest call's bytes of each collective this
# process ran (read by chip_smoke.py)
STATS: Dict[str, List[int]] = {}


def _count(name: str, t: torch.Tensor) -> None:
    s = STATS.setdefault(name, [0, 0, 0])
    nbytes = t.numel() * t.element_size()
    s[0] += 1
    s[1] += nbytes
    s[2] = max(s[2], nbytes)


def count_rows(t: torch.Tensor) -> None:
    """Count rows of a tensor this process holds that ``Dataset.rows_piece``
    places in a piece for another process (STATS ``rows``: the one way rows
    cross processes in an ``all_reduce``)."""
    if dist.is_initialized():
        _count("rows", t)


def reset_stats() -> None:
    STATS.clear()


def all_reduce_sum_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``t`` in place over the example axes (the identity without a
    process group)."""
    g, _ = example_group(mesh)
    if dist.is_initialized():
        _count("all_reduce", t)
        dist.all_reduce(t, group=g)
    return t


def _group_order(line: List[int]) -> List[int]:
    """For each rank of a group, in group-rank order (sorted global
    ranks), its position along the mesh line."""
    return [line.index(r) for r in sorted(line)]


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every shard's ``t`` concatenated along dim 0 in shard order (equal
    shapes on every rank; ``t`` itself without a process group)."""
    g, line = example_group(mesh)
    if not dist.is_initialized():
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in line]
    _count("all_gather", t)
    dist.all_gather(parts, t, group=g)
    order = _group_order(line)
    by_pos = [None] * len(line)
    for gi, pos in enumerate(order):
        by_pos[pos] = parts[gi]
    return torch.cat(by_pos, dim=0)


def all_to_all_shards(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` (n_shards, ...) with entry j bound for shard j; returns
    (n_shards, ...) with entry i from shard i (``t`` itself without a
    process group)."""
    g, line = example_group(mesh)
    if not dist.is_initialized():
        return t
    order = _group_order(line)
    send = t[order].contiguous() if order != sorted(order) else t.contiguous()
    recv = torch.empty_like(send)
    _count("all_to_all", send)
    dist.all_to_all_single(recv, send, group=g)
    if order == sorted(order):
        return recv
    out = torch.empty_like(recv)
    out[order] = recv
    return out


def all_gather_objects(obj, mesh: Mesh) -> list:
    """Every shard's picklable ``obj`` in shard order."""
    g, line = example_group(mesh)
    if not dist.is_initialized():
        return [obj]
    got = [None] * len(line)
    dist.all_gather_object(got, obj, group=g)
    by_pos = [None] * len(line)
    for gi, pos in enumerate(_group_order(line)):
        by_pos[pos] = got[gi]
    return by_pos
