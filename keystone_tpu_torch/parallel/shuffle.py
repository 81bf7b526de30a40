"""Shuffle and repartition on one device (counterpart of
``keystone_tpu/parallel/shuffle.py`` at one-device scope).

Reference: the Spark shuffle behind ``Shuffler`` (nodes/util/Shuffler.scala,
repartition) and the HashPartitioner ``groupBy`` of the per-class
solvers. The JAX package packs each shard's rows into fixed-capacity
per-destination buckets and exchanges them in one ``lax.all_to_all``; on
one device there is one shard, so the exchange is the identity and what
remains is the packing: rows sorted stably by destination into buckets
of a fixed capacity, a validity mask, and a count of the rows that
overflowed their bucket (callers size the capacity so that it is zero).
Each function runs on its input's device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# shards on one device
N_SHARDS = 1


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
    payload: tuple, dest: torch.Tensor, capacity: int
) -> Tuple[tuple, torch.Tensor, torch.Tensor]:
    """Route rows to the shard named per row (``>= N_SHARDS`` discards
    the row). Returns ``(N_SHARDS * capacity, ...)`` received rows
    (source-major), an int32 validity mask and the overflow count — ``0``
    when ``capacity`` was enough."""
    buckets, valid, over = _pack_buckets(payload, dest, N_SHARDS, capacity)
    flat = tuple(b.reshape((N_SHARDS * capacity,) + tuple(b.shape[2:])) for b in buckets)
    return flat, valid.reshape(-1), over


def repartition_by_key(payload: tuple, keys: torch.Tensor, capacity: int):
    """Hash-partition rows onto shards by ``key % N_SHARDS`` — the
    HashPartitioner ``groupBy`` analogue (negative keys discard)."""
    dest = torch.where(keys >= 0, keys % N_SHARDS, N_SHARDS)
    return all_to_all_repartition(payload, dest, capacity)


def device_shuffle(x: torch.Tensor, n: int, seed: int = 0) -> torch.Tensor:
    """Exact random permutation of the first ``n`` (valid) rows of a padded
    array, on its device: ``out[j] = x[perm[j]]`` with ``perm =
    default_rng(seed).permutation(n)``, the host ``Shuffler``'s rows. Each
    row goes to its permuted slot through the repartition; pad rows come
    out zero."""
    n_pad = x.shape[0]
    perm = np.random.default_rng(seed).permutation(n)
    target = np.full((n_pad,), n_pad, np.int64)  # pad rows -> discard
    target[:n] = np.argsort(perm)  # row g lands at out slot inv[g]
    dest = torch.as_tensor(np.where(target < n_pad, 0, N_SHARDS), device=x.device)
    slot = torch.as_tensor(target % n_pad, device=x.device)
    (rows, slots), valid, over = all_to_all_repartition((x, slot), dest, max(n, 1))
    out = x.new_zeros(x.shape)
    live = valid > 0
    out[slots[live]] = rows[live]
    over_count = int(over)
    if over_count:
        raise RuntimeError(f"device_shuffle dropped {over_count} rows")
    return out
