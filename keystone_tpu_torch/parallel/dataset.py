"""``Dataset`` — the framework's N-example collection type, on one device.

Three physical modes, as in ``keystone_tpu/parallel/dataset.py``:

- **array mode**: a tensor, or a tuple of tensors, with a leading example
  axis, possibly zero-padded past the valid count ``n``. Transformers
  become batched tensor ops over it. There is no mesh: the tensors live
  on whatever single device they were put on.
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
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


def _leading_dim(tree: Any) -> int:
    if isinstance(tree, (tuple, list)):
        if not tree:
            raise ValueError("empty array tuple")
        return _leading_dim(tree[0])
    return tree.shape[0]


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, t) for t in tree)
    return fn(tree)


def _as_tensor(a: Any) -> Any:
    if isinstance(a, tuple):
        return tuple(_as_tensor(x) for x in a)
    if isinstance(a, torch.Tensor):
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


class Dataset:
    def __init__(
        self,
        *,
        arrays: Any = None,
        items: Optional[List[Any]] = None,
        host_blocks: Optional[List[torch.Tensor]] = None,
        n: Optional[int] = None,
        device: Optional[torch.device] = None,
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
        if arrays is not None:
            self._n = int(n) if n is not None else _leading_dim(arrays)
        elif host_blocks is not None:
            if not host_blocks:
                raise ValueError("host_blocks must be non-empty")
            rows = {b.shape[0] for b in host_blocks}
            if len(rows) != 1:
                raise ValueError(
                    f"host blocks disagree on row count: {sorted(rows)}"
                )
            self._n = int(n) if n is not None else host_blocks[0].shape[0]
        else:
            self._n = len(items)

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
    def from_array(arrays: Any, n: Optional[int] = None) -> "Dataset":
        return Dataset(arrays=_as_tensor(arrays), n=n)

    @staticmethod
    def from_items(items: Sequence[Any]) -> "Dataset":
        return Dataset(items=list(items))

    @staticmethod
    def from_host_blocks(
        blocks: Sequence[Any], n: Optional[int] = None, device=None
    ) -> "Dataset":
        """A column-blocked feature matrix in host RAM whose slabs stream
        to ``device`` (``None`` means ``cuda``) (the cluster-RAM feature
        cache of BlockLinearMapper.scala:50-73). Each block is
        (padded_n, w_i); the solvers upload one slab at a time. Blocks
        are made C-contiguous here, once, so every upload is a straight
        copy."""
        from keystone_tpu_torch._device import resolve_device

        return Dataset(
            host_blocks=[_host_tensor(b) for b in blocks],
            n=n, device=resolve_device(device),
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
    def padded_n(self) -> int:
        if self.is_array:
            return _leading_dim(self._arrays)
        if self.is_host:
            return self._host_blocks[0].shape[0]
        return self._n

    # -- views -------------------------------------------------------------

    def padded(self) -> Any:
        """Tensors with the (possibly padded) leading axis."""
        return self.to_array_mode()._arrays

    def array(self) -> Any:
        """Tensors sliced to exactly ``n`` valid rows."""
        arrs = self.to_array_mode()._arrays
        if _leading_dim(arrs) == self._n:
            return arrs
        return _tree_map(lambda a: a[: self._n], arrs)

    def mask(self) -> torch.Tensor:
        """(padded_n,) float32 validity mask on the dataset's device."""
        idx = torch.arange(self.padded_n, device=self.device)
        return (idx < self._n).to(torch.float32)

    def items(self) -> List[Any]:
        if self._items is not None:
            return self._items
        arrs = self.array()
        return [_tree_map(lambda a, i=i: a[i], arrs) for i in range(self._n)]

    def __iter__(self):
        return iter(self.items())

    def first(self) -> Any:
        if self._items is not None:
            return self._items[0]
        return _tree_map(lambda a: a[0], self.array())

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
            return Dataset(arrays=full, n=self._n)
        first = self._items[0]
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

    def zip(self, other: "Dataset") -> "Dataset":
        if self.n != other.n:
            raise ValueError(f"zip length mismatch: {self.n} vs {other.n}")
        if self.is_array and other.is_array:
            pn = max(self.padded_n, other.padded_n)
            a = self._pad_to(pn)._arrays
            b = other._pad_to(pn)._arrays
            return Dataset(arrays=(a, b), n=self.n)
        return Dataset(items=list(zip(self.items(), other.items())))

    def cache(self) -> "Dataset":
        """The identity (reference: Cacher / rdd.cache): the arrays already
        live on their device, and the executor's memo keeps them."""
        return self

    def _pad_to(self, pn: int) -> "Dataset":
        arrs = self.to_array_mode()._arrays
        cur = _leading_dim(arrs)
        if cur == pn:
            return self.to_array_mode()
        if cur > pn:
            raise ValueError("cannot shrink padding")
        pad = pn - cur
        padded = _tree_map(
            lambda a: torch.cat(
                [a, a.new_zeros((pad,) + tuple(a.shape[1:]))]
            ),
            arrs,
        )
        return Dataset(arrays=padded, n=self._n)

    def __repr__(self) -> str:
        if self.is_host:
            return (
                f"Dataset(host_blocks, n={self._n}, "
                f"widths={self.block_widths}, device={self._device})"
            )
        if self.is_array:
            shapes = _tree_map(lambda a: tuple(a.shape), self._arrays)
            return f"Dataset(array, n={self._n}, shapes={shapes})"
        return f"Dataset(items, n={self._n})"


def _is_on(t: torch.Tensor, dev: torch.device) -> bool:
    return t.device.type == dev.type and dev.index in (None, t.device.index)


def on_device(ds: Dataset, dev: torch.device) -> Dataset:
    """A dataset on ``dev``, the same dataset when it is there already, so
    that the pipeline's branches and its solver share one source node.
    Items of one shape (labels, images of one size) become one array;
    items of several shapes (images as ``ImageNetLoader`` decodes them)
    stay items, moved one stack per shape."""
    if not ds.is_array:
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
    x = ds.array()
    if _is_on(x, dev) and ds.padded_n == ds.n:
        return ds
    return Dataset.from_array(x.to(dev))
