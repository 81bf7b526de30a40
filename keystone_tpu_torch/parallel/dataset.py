"""``Dataset`` — the framework's N-example collection type.

Three physical modes, as in ``keystone_tpu/parallel/dataset.py``:

- **array mode**: a tensor, or a tuple of tensors, with a leading example
  axis, possibly zero-padded past the valid count ``n``. Transformers
  become batched tensor ops over it. There is no mesh: the tensors live
  on whatever single device they were put on. The tensor may be a sparse
  row matrix (the JAX package's BCOO ``(n, d)`` array): a
  ``torch.sparse_csr`` tensor with int64 indices, its rows' columns in
  ascending order and no duplicates (a COO tensor given to ``from_array``
  is coalesced first, which sums duplicate entries as BCOO's products
  do). CSR and not COO because the sparse solvers need both ``X·W`` and
  ``Xᵀ·R``: a CSR matrix and a CSR of its transpose (``csr_transpose``,
  made once per fit) give both as cuSPARSE SpMM on the card, while a COO
  transpose is not coalesced and a CSC operand is not what SpMM reads
  fastest. Pad rows of a sparse matrix hold no entries; its items are
  1-D sparse COO rows.
- **items mode**: a host-side list of per-example Python objects.
- **host-blocks mode**: a feature matrix column-blocked into host-RAM
  tensors (each (padded_n, w_i), contiguous, on the CPU), and the device
  the blocks stream to. This is the training substrate for feature matrices
  larger than the card: the reference caches features in cluster RAM and
  streams them block by block through the block solvers
  (BlockLinearMapper.scala:50-73; AutoCacheRule.scala:559-602 budgets 75%
  of cluster memory for the cache). Here host RAM is the cache tier and
  the block solver uploads each slab per pass, so a fit's feature
  footprint is bounded by host RAM, not by the card.

Padding discipline: ``n`` is the valid example count; rows past ``n`` are
zeros. Reductions that care divide by ``n`` or use ``mask()``.

**Sharded rows** (``shard``, or ``from_array``/``from_host_blocks`` given
a ``mesh``; JAX's ``dataset.py:330-344``). The port runs one process per
device (``parallel/runtime.py``), and a sharded dataset holds this
process's contiguous range of rows, padded so that every shard of the
mesh's example axes holds the same count, on its own device. ``n`` and
``padded_n`` stay global; ``local()`` is this process's rows and
``mask()`` covers them. The estimators that reduce over examples work
on the local rows and add their sums over the shards with ``all_sum``
(``Dataset.all_sum``, ``Dataset.row_sum``): one ``all_reduce`` for all
the sums a step needs, the identity when the rows are not sharded, so
that one code path serves both. Where an algorithm needs rows another
process holds (a kernel block's training rows), ``global_rows`` moves
just those rows. The whole-array views (``padded()``,
``array()``, ``items()``, ``first()``) gather every shard's rows with
``all_gather`` (``_gathered``, the one place that does), so every process
must ask for them together.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from keystone_tpu_torch.parallel import mesh as mesh_lib


def _leading_dim(tree: Any) -> int:
    if isinstance(tree, (tuple, list)):
        if not tree:
            raise ValueError("empty array tuple")
        return _leading_dim(tree[0])
    return tree.shape[0]


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` over the leaves of a tree of tuples and dicts (a shared
    prefix's outputs are a dict keyed by model id), keeping its shape."""
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, t) for k, t in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a tree of (nested) tuples and dicts, in order (a
    dict's in its key order, as ``_tree_map`` rebuilds it)."""
    if isinstance(tree, dict):
        tree = tuple(tree.values())
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def _as_tensor(a: Any) -> Any:
    if isinstance(a, tuple):
        return tuple(_as_tensor(x) for x in a)
    if isinstance(a, torch.Tensor):
        if a.layout == torch.sparse_coo and a.dim() == 2:
            return a.coalesce().to_sparse_csr()
        return a
    return torch.as_tensor(np.asarray(a))


def shape_groups(items: Sequence[torch.Tensor]) -> List[List[int]]:
    """The positions of ``items`` grouped by (shape, dtype, device), the
    groups and the positions within each in dataset order."""
    groups: Dict[tuple, List[int]] = {}
    for i, x in enumerate(items):
        groups.setdefault((tuple(x.shape), x.dtype, x.device), []).append(i)
    return list(groups.values())


def _host_tensor(a: Any) -> torch.Tensor:
    """``a`` (a tensor on any device, or an array) as a contiguous CPU
    tensor; a numpy array of ``ml_dtypes.bfloat16`` (JAX's bf16) becomes
    a bf16 tensor without a copy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().contiguous()
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _device_of(tree: Any) -> torch.device:
    if isinstance(tree, tuple):
        return _device_of(tree[0])
    return tree.device


def is_sparse(a: Any) -> bool:
    """Whether ``a`` is a sparse row matrix (a ``torch.sparse_csr`` tensor)."""
    return isinstance(a, torch.Tensor) and a.layout == torch.sparse_csr


def csr_from_parts(crow: Any, col: Any, values: Any, shape: Sequence[int],
                   device=None) -> torch.Tensor:
    """A CSR matrix from its row pointers, column ids and values, taken as
    they are: each row's columns must be ascending and distinct (the native
    text featurizer and ``torch``'s own conversions write them so)."""
    crow, col, values = (torch.as_tensor(np.asarray(a)) if not isinstance(a, torch.Tensor)
                         else a for a in (crow, col, values))
    return torch.sparse_csr_tensor(
        crow.to(device=device, dtype=torch.int64), col.to(device=device, dtype=torch.int64),
        values.to(device=device, dtype=torch.float32), tuple(shape),
    )


def csr_from_coo(rows: Any, cols: Any, values: Any, shape: Sequence[int],
                 device=None) -> torch.Tensor:
    """A CSR matrix from (row, column, value) triplets in any order;
    duplicate positions are summed, as a BCOO matrix's products sum them.
    Sorted and summed with numpy on the host."""
    rows = np.asarray(rows, np.int64).reshape(-1)
    cols = np.asarray(cols, np.int64).reshape(-1)
    vals = np.asarray(values, np.float32).reshape(-1)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if rows.size:
        first = np.ones(rows.size, bool)
        first[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
        starts = np.flatnonzero(first)
        if starts.size < rows.size:
            vals = np.add.reduceat(vals, starts)
            rows, cols = rows[starts], cols[starts]
    crow = np.zeros(shape[0] + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=shape[0]), out=crow[1:])
    return csr_from_parts(crow, cols, vals, shape, device=device)


def csr_transpose(a: torch.Tensor) -> torch.Tensor:
    """The CSR matrix of ``aᵀ``: one stable sort of the entries by column,
    so each of its rows keeps its column ids (``a``'s rows) ascending."""
    crow, col = a.crow_indices(), a.col_indices()
    rows = torch.repeat_interleave(torch.arange(a.shape[0], device=col.device), crow.diff())
    order = torch.argsort(col, stable=True)
    t_crow = torch.zeros(a.shape[1] + 1, dtype=torch.int64, device=col.device)
    torch.cumsum(torch.bincount(col, minlength=a.shape[1]), 0, out=t_crow[1:])
    return torch.sparse_csr_tensor(t_crow, rows[order], a.values()[order],
                                   (a.shape[1], a.shape[0]))


def csr_head(a: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` rows of a CSR matrix (one host read of the end)."""
    if n == a.shape[0]:
        return a
    crow = a.crow_indices()[: n + 1]
    end = int(crow[-1])
    return torch.sparse_csr_tensor(crow, a.col_indices()[:end], a.values()[:end],
                                   (n, a.shape[1]))


def csr_pad_rows(a: torch.Tensor, pn: int) -> torch.Tensor:
    """A CSR matrix grown to ``pn`` rows by rows with no entries."""
    crow = a.crow_indices()
    pad = crow[-1:].expand(pn - a.shape[0])
    return torch.sparse_csr_tensor(torch.cat([crow, pad]), a.col_indices(), a.values(),
                                   (pn, a.shape[1]))


def csr_rows(a: torch.Tensor, n: int) -> List[torch.Tensor]:
    """The first ``n`` rows of a CSR matrix as 1-D sparse COO vectors."""
    crow = a.crow_indices().tolist()
    col, val, d = a.col_indices(), a.values(), a.shape[1]
    return [
        torch.sparse_coo_tensor(col[crow[i]:crow[i + 1]][None], val[crow[i]:crow[i + 1]],
                                (d,), is_coalesced=True)
        for i in range(n)
    ]


def csr_stack(rows: Sequence[torch.Tensor]) -> torch.Tensor:
    """1-D sparse vectors of one length as the rows of a CSR matrix."""
    rows = [r.coalesce() for r in rows]
    counts = torch.tensor([r._nnz() for r in rows], dtype=torch.int64)
    crow = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(counts, 0)])
    dev = rows[0].device
    col = torch.cat([r.indices()[0] for r in rows]).to(torch.int64)
    val = torch.cat([r.values() for r in rows])
    return torch.sparse_csr_tensor(crow.to(dev), col, val, (len(rows), rows[0].shape[0]))


def spmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for a CSR matrix ``a`` and a dense matrix ``b`` in float32
    on ``a``'s device (cuSPARSE SpMM on the card; float32 arithmetic, as
    the JAX package's BCOO products)."""
    return torch.matmul(a, b.to(device=a.device, dtype=torch.float32).contiguous())


def all_sum(mesh: Optional[mesh_lib.Mesh], *parts: torch.Tensor) -> List[torch.Tensor]:
    """``parts``, each this process's sum over its own rows, summed over
    ``mesh``'s example axes: one ``all_reduce`` for all of them (one per
    dtype), returned as views of the reduced buffer in their shapes. With
    no mesh (rows not sharded) the parts themselves, untouched."""
    if mesh is None:
        return list(parts)
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, p in enumerate(parts):
        by_dtype.setdefault(p.dtype, []).append(i)
    for idxs in by_dtype.values():
        flat = mesh_lib.all_reduce_sum_(
            torch.cat([parts[i].reshape(-1) for i in idxs]), mesh)
        at = 0
        for i in idxs:
            out[i] = flat[at : at + parts[i].numel()].view(parts[i].shape)
            at += parts[i].numel()
    return out


def on_every_shard(mesh: Optional[mesh_lib.Mesh], flag: bool, device=None) -> bool:
    """Whether ``flag`` holds on every process of ``mesh``'s example axes
    (one ``all_reduce``; ``flag`` itself without a mesh): a choice that
    decides which collectives follow must be the same on every process."""
    if mesh is None:
        return bool(flag)
    dev = device if device is not None else mesh_lib.local_device(mesh)
    (votes,) = all_sum(mesh, torch.full((1,), float(bool(flag)), device=dev))
    return int(votes) == mesh_lib.n_data_shards(mesh)


def require_unsharded(data: Any, what: str) -> None:
    """Raise where a fit of one whole sample (the reference collects it to
    one node: the k-means++ seeding, the GMM) is given rows sharded over
    processes, rather than gather them."""
    if isinstance(data, Dataset) and data.is_sharded:
        raise NotImplementedError(
            f"{what} fits one whole sample; on rows sharded over processes it is not "
            f"ported ({mesh_lib.ONE_SAMPLE_ITEM}): fit it on an unsharded sample")


def _head(a: torch.Tensor, n: int) -> torch.Tensor:
    return csr_head(a, n) if is_sparse(a) else a[:n]


class Dataset:
    def __init__(
        self,
        *,
        arrays: Any = None,
        items: Optional[List[Any]] = None,
        host_blocks: Optional[List[torch.Tensor]] = None,
        n: Optional[int] = None,
        device: Optional[torch.device] = None,
        mesh: Optional[mesh_lib.Mesh] = None,
    ):
        modes = sum(x is not None for x in (arrays, items, host_blocks))
        if modes != 1:
            raise ValueError(
                "exactly one of arrays/items/host_blocks required"
            )
        self._arrays = arrays
        self._items = items
        self._host_blocks = host_blocks
        self._device = device
        self._cached = False
        self._mesh = mesh
        if mesh is not None:
            if items is not None:
                raise ValueError("items cannot be sharded: shard() makes them an array first")
            mesh_lib.require_data_parallel(mesh)
        if arrays is not None:
            self._n = int(n) if n is not None else self.padded_n
        elif host_blocks is not None:
            if not host_blocks:
                raise ValueError("host_blocks must be non-empty")
            rows = {b.shape[0] for b in host_blocks}
            if len(rows) != 1:
                raise ValueError(
                    f"host blocks disagree on row count: {sorted(rows)}"
                )
            self._n = int(n) if n is not None else self.padded_n
        else:
            self._n = len(items)
        if mesh is not None and self._n > self.padded_n:
            raise ValueError(f"n = {self._n} valid rows but only {self.padded_n} rows")

    # -- constructors ------------------------------------------------------

    @staticmethod
    def of(data: Any) -> "Dataset":
        """Lift a list/array into a Dataset (lists -> items mode, arrays ->
        array mode; numpy arrays become CPU tensors)."""
        if isinstance(data, Dataset):
            return data
        if isinstance(data, list):
            return Dataset(items=list(data))
        return Dataset(arrays=_as_tensor(data))

    @staticmethod
    def from_array(arrays: Any, n: Optional[int] = None,
                   mesh: Optional[mesh_lib.Mesh] = None) -> "Dataset":
        """An array-mode dataset; with ``mesh``, ``arrays`` are this
        process's rows of one sharded over the mesh (every shard the same
        count, rows past ``n`` zero) and ``n`` the global count."""
        return Dataset(arrays=_as_tensor(arrays), n=n, mesh=mesh)

    @staticmethod
    def from_items(items: Sequence[Any]) -> "Dataset":
        return Dataset(items=list(items))

    @staticmethod
    def from_host_blocks(
        blocks: Sequence[Any], n: Optional[int] = None, device=None,
        mesh: Optional[mesh_lib.Mesh] = None,
    ) -> "Dataset":
        """A column-blocked feature matrix in host RAM whose slabs stream
        to ``device`` (``None`` means ``cuda``) (the cluster-RAM feature
        cache of BlockLinearMapper.scala:50-73). Each block is
        (padded_n, w_i); the solvers upload one slab at a time. Blocks
        are made C-contiguous here, once, so every upload is a straight
        copy. With ``mesh``, the blocks hold this process's rows, as
        ``from_array``'s."""
        from keystone_tpu_torch._device import resolve_device

        return Dataset(
            host_blocks=[_host_tensor(b) for b in blocks],
            n=n, device=resolve_device(device), mesh=mesh,
        )

    @staticmethod
    def from_host_array(
        arr: Any, block_size: int, n: Optional[int] = None, device=None
    ) -> "Dataset":
        """One matrix split into contiguous host column blocks of
        ``block_size`` (the last may be narrower)."""
        arr = _host_tensor(arr)
        blocks = [
            arr[:, s : s + block_size]
            for s in range(0, arr.shape[1], block_size)
        ]
        return Dataset.from_host_blocks(blocks, n=n, device=device)

    @staticmethod
    def host_blocks_from_batches(
        batches, block_size: int, n: Optional[int] = None, device=None
    ) -> "Dataset":
        """Row batches of features (a featurize stream's output, one
        (rows_i, D) tensor or array per loader batch, on the card or the
        host) gathered into host-RAM column blocks of ``block_size``:
        the glue between an out-of-core input pipeline and the block
        solver (the reference's featurize -> cache in cluster RAM ->
        solve flow, ImageNetSiftLcsFV.scala:106-142), without the
        features ever being resident on the card or as one host matrix.
        Device batches are copied to the host here. Peak host memory is
        the features plus one column block's copy."""
        per_block: List[List[torch.Tensor]] = []
        total = 0
        width: Optional[int] = None
        for batch in batches:
            host = _host_tensor(batch)
            total += host.shape[0]
            d = host.shape[1]
            if width is None:
                if d == 0:
                    raise ValueError("zero-width feature batch")
                width = d
                per_block = [[] for _ in range(-(-d // block_size))]
            elif d != width:
                raise ValueError(
                    f"feature width changed mid-stream: {d} vs {width}"
                )
            for bi in range(len(per_block)):
                s = bi * block_size
                # slice views; the per-block concatenate below copies once
                per_block[bi].append(host[:, s : s + block_size])
        if width is None:
            raise ValueError("empty feature stream")
        blocks = []
        for bi in range(len(per_block)):
            blocks.append(torch.cat(per_block[bi], dim=0))
            per_block[bi] = []  # free the row chunks as we go
        return Dataset.from_host_blocks(
            blocks, n=n if n is not None else total, device=device
        )

    # -- inspection --------------------------------------------------------

    @property
    def n(self) -> int:
        return self._n

    def __len__(self) -> int:
        return self._n

    @property
    def is_array(self) -> bool:
        return self._arrays is not None

    @property
    def is_host(self) -> bool:
        return self._host_blocks is not None

    @property
    def host_blocks(self) -> List[torch.Tensor]:
        if self._host_blocks is None:
            raise ValueError("not a host-blocks dataset")
        return self._host_blocks

    @property
    def block_widths(self) -> List[int]:
        return [b.shape[1] for b in self.host_blocks]

    @property
    def device(self) -> torch.device:
        """The device of the arrays, or the one host blocks stream to."""
        if self.is_host:
            return self._device
        return _device_of(self.to_array_mode()._arrays)

    @property
    def is_sharded(self) -> bool:
        return self._mesh is not None

    @property
    def mesh(self) -> Optional[mesh_lib.Mesh]:
        """The mesh whose example axes the rows shard over (None: not
        sharded)."""
        return self._mesh

    @property
    def local_n(self) -> int:
        """This process's rows, padding included (``padded_n`` when not
        sharded)."""
        if self.is_array:
            return _leading_dim(self._arrays)
        if self.is_host:
            return self._host_blocks[0].shape[0]
        return self._n

    @property
    def padded_n(self) -> int:
        if self.is_sharded:
            return self.local_n * mesh_lib.n_data_shards(self._mesh)
        return self.local_n

    @property
    def offset(self) -> int:
        """The global index of this process's first row (0 when not
        sharded)."""
        if not self.is_sharded:
            return 0
        return mesh_lib.shard_index(self._mesh) * self.local_n

    @property
    def local_valid(self) -> int:
        """How many of this process's rows are valid: the first ones (a
        shard past ``n`` holds none)."""
        return max(0, min(self.local_n, self._n - self.offset))

    # -- views -------------------------------------------------------------

    def local(self) -> Any:
        """This process's rows, padded (the whole padded tensors when not
        sharded)."""
        return self.to_array_mode()._arrays

    def _gathered(self) -> Any:
        """Every shard's rows in order: the one place a sharded dataset's
        rows cross processes whole (an ``all_gather`` per tensor)."""
        local = self.local()
        if not self.is_sharded:
            return local
        if any(is_sparse(a) for a in tree_leaves(local)):
            raise ValueError("a sharded sparse matrix cannot be gathered")
        return _tree_map(lambda a: mesh_lib.all_gather_rows(a, self._mesh), local)

    def padded(self) -> Any:
        """Tensors with the (possibly padded) leading axis; a sharded
        dataset's are gathered (``_gathered``)."""
        return self._gathered()

    def array(self) -> Any:
        """Tensors sliced to exactly ``n`` valid rows (gathered when
        sharded)."""
        arrs = self._gathered()
        if _leading_dim(arrs) == self._n:
            return arrs
        return _tree_map(lambda a: _head(a, self._n), arrs)

    def mask(self) -> torch.Tensor:
        """float32 validity mask of this process's rows (``local_n``; all
        ``padded_n`` rows when not sharded), on the dataset's device."""
        lo = self.offset
        idx = torch.arange(lo, lo + self.local_n, device=self.device)
        return (idx < self._n).to(torch.float32)

    # -- sums over the rows of every shard ----------------------------------

    def all_sum(self, *parts: torch.Tensor) -> List[torch.Tensor]:
        """``parts``, each a sum over this process's rows (a Gram, Xᵀ·R, a
        loss), summed over every shard in one ``all_reduce`` (module
        ``all_sum``); the parts themselves when the rows are not sharded."""
        return all_sum(self._mesh, *parts)

    def row_sum(self, *xs: torch.Tensor) -> List[torch.Tensor]:
        """Σ over the valid rows of every shard of each ``x`` (a tensor of
        this process's ``local_n`` rows, such as ``local()`` or one made
        from it): ``Σ mask()·x`` here, then ``all_sum``."""
        mask = self.mask()
        return self.all_sum(*(
            torch.sum(x * mask.to(x.device, x.dtype).view((-1,) + (1,) * (x.ndim - 1)), dim=0)
            for x in xs))

    def rows_piece(self, t: torch.Tensor, start: int, stop: int) -> torch.Tensor:
        """This process's share of the global rows ``start .. stop`` of a
        tensor whose local rows ``t`` holds: those rows it holds, in place,
        zeros elsewhere, so that ``all_sum`` of the pieces is the rows
        themselves (a slice of ``t`` when not sharded)."""
        if not self.is_sharded:
            return t[start:stop]
        lo = self.offset
        out = t.new_zeros((stop - start,) + tuple(t.shape[1:]))
        a, b = max(start, lo), min(stop, lo + self.local_n)
        if a < b:
            out[a - start : b - start] = t[a - lo : b - lo]
            mesh_lib.count_rows(out[a - start : b - start])
        return out

    def global_rows(self, t: torch.Tensor, start: int, stop: int) -> torch.Tensor:
        """The global rows ``start .. stop`` of a tensor whose local rows
        ``t`` holds, on every process: only those rows cross processes."""
        return self.all_sum(self.rows_piece(t, start, stop))[0]

    def local_like(self, other: "Dataset") -> Any:
        """This dataset's rows beside ``other``'s local ones (labels beside
        features): this process's when ``other`` is sharded, all of them
        padded to ``other``'s rows otherwise."""
        ds = self.to_array_mode()
        if other.is_sharded:
            return ds.shard_like(other).local()
        if ds.padded_n != other.padded_n:
            ds = ds._pad_to(other.padded_n)
        return ds.padded()

    def items(self) -> List[Any]:
        if self._items is not None:
            return self._items
        arrs = self.array()
        if is_sparse(arrs):
            return csr_rows(arrs, self._n)
        return [_tree_map(lambda a, i=i: a[i], arrs) for i in range(self._n)]

    def __iter__(self):
        return iter(self.items())

    def first(self) -> Any:
        if self._items is not None:
            return self._items[0]
        if self.is_sharded:  # row 0 of shard 0, without gathering the rest
            return _tree_map(lambda a: mesh_lib.all_gather_rows(a[:1], self._mesh)[0],
                             self.local())
        arrs = self.array()
        if is_sparse(arrs):
            return csr_rows(arrs, 1)[0]
        return _tree_map(lambda a: a[0], arrs)

    def take(self, k: int) -> List[Any]:
        return self.items()[:k]

    # -- conversions -------------------------------------------------------

    def to_array_mode(self) -> "Dataset":
        if self.is_array:
            return self
        if self.is_host:
            # the whole feature matrix on the device: what host-blocks
            # mode exists to avoid, for small sets (tests, cross-checks)
            full = torch.cat(
                [b.to(self._device) for b in self._host_blocks],
                dim=1,
            )
            return Dataset(arrays=full, n=self._n, mesh=self._mesh)
        first = self._items[0]
        if isinstance(first, torch.Tensor) and first.layout == torch.sparse_coo:
            return Dataset(arrays=csr_stack(self._items), n=self._n)
        if isinstance(first, tuple):
            stacked = tuple(
                torch.stack([_as_tensor(x[j]) for x in self._items])
                for j in range(len(first))
            )
        else:
            stacked = torch.stack([_as_tensor(x) for x in self._items])
        return Dataset(arrays=stacked, n=self._n)

    def map(self, fn: Callable[[Any], Any]) -> "Dataset":
        """Per-example host map (items mode result)."""
        return Dataset(items=[fn(x) for x in self.items()])

    def map_arrays(self, fn: Callable[[Any], Any]) -> "Dataset":
        """Whole-batch array transform; ``fn`` must preserve the leading axis
        and map zero pad rows to values safe to keep as padding. A sharded
        dataset's rows are mapped where they are."""
        return Dataset(arrays=fn(self.local()), n=self._n, mesh=self._mesh)

    def flat_map(self, fn: Callable[[Any], Sequence[Any]]) -> "Dataset":
        out: List[Any] = []
        for x in self.items():
            out.extend(fn(x))
        return Dataset(items=out)

    def filter(self, pred: Callable[[Any], bool]) -> "Dataset":
        return Dataset(items=[x for x in self.items() if pred(x)])

    def zip(self, other: "Dataset") -> "Dataset":
        if self.n != other.n:
            raise ValueError(f"zip length mismatch: {self.n} vs {other.n}")
        if self.is_sharded or other.is_sharded:
            like = self if self.is_sharded else other
            pair = (self.shard_like(like).local(), other.shard_like(like).local())
            return Dataset(arrays=pair, n=self.n, mesh=like.mesh)
        if self.is_array and other.is_array:
            pn = max(self.padded_n, other.padded_n)
            a = self._pad_to(pn)._arrays
            b = other._pad_to(pn)._arrays
            return Dataset(arrays=(a, b), n=self.n)
        return Dataset(items=list(zip(self.items(), other.items())))

    def cache(self) -> "Dataset":
        """The identity (reference: Cacher / rdd.cache): the arrays already
        live on their device, and the executor's memo keeps them. A sparse
        row matrix is cached as it is too."""
        self._cached = True
        return self

    @property
    def is_cached(self) -> bool:
        return self.__dict__.get("_cached", False)

    def _pad_to(self, pn: int) -> "Dataset":
        if self.is_sharded:
            if pn != self.padded_n:
                raise ValueError(f"cannot repad a sharded dataset of {self.padded_n} rows to {pn}")
            return self.to_array_mode()
        arrs = self.to_array_mode()._arrays
        cur = _leading_dim(arrs)
        if cur == pn:
            return self.to_array_mode()
        if cur > pn:
            raise ValueError("cannot shrink padding")
        pad = pn - cur
        padded = _tree_map(
            lambda a: csr_pad_rows(a, pn) if is_sparse(a) else torch.cat(
                [a, a.new_zeros((pad,) + tuple(a.shape[1:]))]
            ),
            arrs,
        )
        return Dataset(arrays=padded, n=self._n)

    # -- placement ---------------------------------------------------------

    def shard(self, mesh: Optional[mesh_lib.Mesh] = None) -> "Dataset":
        """Pad to a multiple of the mesh's data shards and keep this
        process's contiguous range of rows (JAX's ``dataset.py:330-344``),
        on its device in the mesh once the process joined a group (one
        process alone keeps the rows where they are). ``n`` stays global.
        Host blocks shard the same way (their rows, still on the host);
        items become an array first. A model axis above 1 raises
        ``NotImplementedError`` (ROADMAP A)."""
        mesh = mesh or mesh_lib.current_mesh()
        if self._mesh is mesh:
            return self
        if self.is_sharded:  # onto another mesh: gathered, then split again
            return Dataset(arrays=self.padded(), n=self._n).shard(mesh)
        ns = mesh_lib.n_data_shards(mesh)
        per = -(-self.padded_n // ns)
        lo = mesh_lib.shard_index(mesh) * per
        joined = torch.distributed.is_initialized()
        if self.is_host:
            def cut(b):
                if b.shape[0] < per * ns:
                    b = torch.cat([b, b.new_zeros((per * ns - b.shape[0], b.shape[1]))])
                return b[lo : lo + per]

            dev = mesh_lib.local_device(mesh) if joined else self._device
            return Dataset(host_blocks=[cut(b) for b in self._host_blocks], n=self._n,
                           device=dev, mesh=mesh)
        ds = self.to_array_mode()
        if any(is_sparse(a) for a in tree_leaves(ds._arrays)):
            raise ValueError("sparse rows cannot be sharded yet")
        ds = ds._pad_to(per * ns)
        dev = mesh_lib.local_device(mesh) if joined else ds.device
        local = _tree_map(lambda a: a[lo : lo + per].to(dev), ds._arrays)
        return Dataset(arrays=local, n=self._n, mesh=mesh)

    def shard_like(self, other: "Dataset") -> "Dataset":
        """This dataset's rows sharded as ``other``'s (same mesh, same
        padded count; labels beside features)."""
        if not other.is_sharded:
            return self
        if self._mesh is other.mesh and self.padded_n == other.padded_n:
            return self
        whole = Dataset(arrays=self.padded(), n=self._n) if self.is_sharded else self
        return whole._pad_to(other.padded_n).shard(other.mesh)

    def __repr__(self) -> str:
        where = "" if self._mesh is None else f", sharded over {self._mesh.shape}"
        if self.is_host:
            return (
                f"Dataset(host_blocks, n={self._n}, "
                f"widths={self.block_widths}, device={self._device}{where})"
            )
        if self.is_array:
            shapes = _tree_map(lambda a: tuple(a.shape), self._arrays)
            return f"Dataset(array, n={self._n}, shapes={shapes}{where})"
        return f"Dataset(items, n={self._n})"


def _first_leaf(tree: Any) -> torch.Tensor:
    return _first_leaf(tree[0]) if isinstance(tree, tuple) else tree


def _is_on(t: torch.Tensor, dev: torch.device) -> bool:
    return t.device.type == dev.type and dev.index in (None, t.device.index)


def on_device(ds: Dataset, dev: torch.device) -> Dataset:
    """A dataset on ``dev``, the same dataset when it is there already, so
    that the pipeline's branches and its solver share one source node.
    A sparse row matrix (or items that are sparse rows) moves as one CSR
    matrix; a tuple of arrays (ELL's indices and values) moves whole.
    Items of one shape (labels, images of one size) become one array;
    items of several shapes (images as ``ImageNetLoader`` decodes them)
    stay items, moved one stack per shape."""
    if not ds.is_array:
        first = ds.first()
        if isinstance(first, torch.Tensor) and first.layout == torch.sparse_coo:
            return Dataset.from_array(ds.to_array_mode().padded().to(dev))
        items = [torch.as_tensor(x) for x in ds.items()]
        groups = shape_groups(items)
        if len(groups) == 1:
            return Dataset.from_array(torch.stack(items).to(dev))
        if all(isinstance(x, torch.Tensor) and _is_on(x, dev) for x in ds.items()):
            return ds
        out = [None] * len(items)
        for idxs in groups:
            moved = torch.stack([items[i] for i in idxs]).to(dev)
            for i, x in zip(idxs, moved.unbind(0)):
                out[i] = x
        return Dataset.from_items(out)
    if ds.is_sharded:  # the rows stay on their own device
        return ds
    x = ds.array()
    if _is_on(_first_leaf(x), dev) and ds.padded_n == ds.n:
        return ds
    return Dataset.from_array(_tree_map(lambda a: a.to(dev), x))
