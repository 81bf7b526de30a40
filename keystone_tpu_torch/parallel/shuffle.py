"""Shuffle and repartition over the mesh's shards (counterpart of
``keystone_tpu/parallel/shuffle.py``).

Reference: the Spark shuffle behind ``Shuffler`` (nodes/util/Shuffler.scala,
repartition) and the HashPartitioner ``groupBy`` of the per-class
solvers. As in the JAX package a shuffle is one collective: each shard
packs its rows into fixed-capacity per-destination buckets, one
``all_to_all_single`` over the example axes exchanges them, and the
receivers unpack. Buckets have a fixed capacity; rows that overflow
theirs are dropped and counted (callers size the capacity so the count
is zero; ``device_shuffle``'s slot-exact routing needs no slack).

The payload and destinations are this process's rows of a row-sharded
array (``Dataset.shard``), every shard the same count; the shard count
is ``n_data_shards(mesh)``. In one process that joined no group the mesh
is one shard and the exchange is the identity. Each function runs on its
input's device (NCCL needs it on the card).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from keystone_tpu_torch.parallel import mesh as mesh_lib


def _pack_buckets(payload: tuple, dest: torch.Tensor, n_shards: int, capacity: int):
    """Pack rows into per-destination buckets. ``payload`` is a tuple of
    tensors sharing their leading dim; ``dest`` is a row destination in
    ``[0, n_shards)``, or ``>= n_shards`` to discard the row. Returns the
    buckets ``(n_shards, capacity, ...)``, the validity mask ``(n_shards,
    capacity)`` and the number of kept rows that overflowed their
    bucket."""
    m = dest.shape[0]
    d = torch.where(dest < n_shards, dest, n_shards).to(torch.int64)
    counts = torch.bincount(d, minlength=n_shards + 1)
    offsets = torch.cumsum(counts, 0) - counts
    order = torch.sort(d, stable=True).indices
    ds = d[order]
    pos = torch.arange(m, device=d.device) - offsets[ds]
    keep = (ds < n_shards) & (pos < capacity)
    row_idx, slot = ds[keep], pos[keep]

    def pack(x):
        buf = x.new_zeros((n_shards, capacity) + tuple(x.shape[1:]))
        buf[row_idx, slot] = x[order[keep]]
        return buf

    buckets = tuple(pack(x) for x in payload)
    valid = torch.zeros((n_shards, capacity), dtype=torch.int32, device=d.device)
    valid[row_idx, slot] = 1
    overflowed = counts[:n_shards].sum() - valid.sum()
    return buckets, valid, overflowed


def all_to_all_repartition(
    payload: tuple, dest: torch.Tensor, capacity: int,
    mesh: Optional[mesh_lib.Mesh] = None,
) -> Tuple[tuple, torch.Tensor, torch.Tensor]:
    """Route this shard's rows to the shard named per row (``>=
    n_shards`` discards the row). Returns ``(n_shards * capacity, ...)``
    received rows (source-major), an int32 validity mask and the global
    overflow count — ``0`` when ``capacity`` was enough."""
    mesh = mesh or mesh_lib.current_mesh()
    n_shards = mesh_lib.n_data_shards(mesh)
    buckets, valid, over = _pack_buckets(payload, dest, n_shards, capacity)
    recv = tuple(mesh_lib.all_to_all_shards(b, mesh) for b in buckets)
    recv_valid = mesh_lib.all_to_all_shards(valid, mesh)
    over = mesh_lib.all_reduce_sum_(over.reshape(1), mesh)[0]
    flat = tuple(b.reshape((n_shards * capacity,) + tuple(b.shape[2:])) for b in recv)
    return flat, recv_valid.reshape(-1), over


def repartition_by_key(payload: tuple, keys: torch.Tensor, capacity: int,
                       mesh: Optional[mesh_lib.Mesh] = None):
    """Hash-partition rows onto shards by ``key % n_shards`` — the
    HashPartitioner ``groupBy`` analogue (negative keys discard)."""
    mesh = mesh or mesh_lib.current_mesh()
    n_shards = mesh_lib.n_data_shards(mesh)
    dest = torch.where(keys >= 0, keys % n_shards, n_shards)
    return all_to_all_repartition(payload, dest, capacity, mesh)


def device_shuffle(x: torch.Tensor, n: int, seed: int = 0,
                   mesh: Optional[mesh_lib.Mesh] = None) -> torch.Tensor:
    """Exact random permutation of the first ``n`` (valid) rows of a padded
    row-sharded array, on its devices: ``out[j] = x[perm[j]]`` with ``perm =
    default_rng(seed).permutation(n)``, the host ``Shuffler``'s rows. ``x``
    is this shard's rows; every row goes to its permuted global slot
    (destination shard and local slot) in one exchange, and this shard's
    rows of the result come back. Pad rows come out zero."""
    mesh = mesh or mesh_lib.current_mesh()
    n_shards = mesh_lib.n_data_shards(mesh)
    rows_per_shard = x.shape[0]
    n_pad = rows_per_shard * n_shards
    shard = mesh_lib.shard_index(mesh)

    perm = np.random.default_rng(seed).permutation(n)
    target = np.full((n_pad,), n_pad, np.int64)  # pad rows -> discard
    target[:n] = np.argsort(perm)  # row g lands at out slot inv[g]
    dest_h = np.where(target < n_pad, target // rows_per_shard, n_shards)
    # the permutation is known on the host, so each (src, dst) bucket is
    # sized at its exact occupancy (~rows_per_shard / n_shards for a random
    # permutation), never rows_per_shard
    src = np.arange(n_pad) // rows_per_shard
    pair_counts = np.zeros((n_shards, n_shards + 1), np.int64)
    np.add.at(pair_counts, (src, dest_h), 1)
    capacity = max(int(pair_counts[:, :n_shards].max()), 1)

    mine = slice(shard * rows_per_shard, (shard + 1) * rows_per_shard)
    dest = torch.as_tensor(dest_h[mine], device=x.device)
    slot = torch.as_tensor(target[mine] % rows_per_shard, device=x.device)
    (rows, slots), valid, over = all_to_all_repartition((x, slot), dest, capacity, mesh)
    out = x.new_zeros(x.shape)
    live = valid > 0
    out[slots[live]] = rows[live]
    over_count = int(over)
    if over_count:
        raise RuntimeError(
            f"device_shuffle dropped {over_count} rows: the input's rows are not "
            "contiguously block-sharded over the mesh"
        )
    return out
