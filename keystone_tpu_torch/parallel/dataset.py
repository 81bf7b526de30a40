"""``Dataset`` — the framework's N-example collection type, on one device.

Two physical modes (``keystone_tpu/parallel/dataset.py`` has a third,
host blocks, which waits for the training slice):

- **array mode**: a tensor, or a tuple of tensors, with a leading example
  axis, possibly zero-padded past the valid count ``n``. Transformers
  become batched tensor ops over it. There is no mesh: the tensors live
  on whatever single device they were put on.
- **items mode**: a host-side list of per-example Python objects.

Padding discipline: ``n`` is the valid example count; rows past ``n`` are
zeros. Reductions that care divide by ``n`` or use ``mask()``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

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
        n: Optional[int] = None,
    ):
        if (arrays is None) == (items is None):
            raise ValueError("exactly one of arrays/items required")
        self._arrays = arrays
        self._items = items
        if arrays is not None:
            self._n = int(n) if n is not None else _leading_dim(arrays)
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
    def padded_n(self) -> int:
        if self.is_array:
            return _leading_dim(self._arrays)
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
        """(padded_n,) float32 validity mask on the arrays' device."""
        arrs = self.to_array_mode()._arrays
        idx = torch.arange(self.padded_n, device=_device_of(arrs))
        return (idx < self._n).to(torch.float32)

    def items(self) -> List[Any]:
        if self._items is not None:
            return self._items
        arrs = self.array()
        return [_tree_map(lambda a, i=i: a[i], arrs) for i in range(self._n)]

    def __iter__(self):
        return iter(self.items())

    def take(self, k: int) -> List[Any]:
        return self.items()[:k]

    # -- conversions -------------------------------------------------------

    def to_array_mode(self) -> "Dataset":
        if self.is_array:
            return self
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
        if self.is_array:
            shapes = _tree_map(lambda a: tuple(a.shape), self._arrays)
            return f"Dataset(array, n={self._n}, shapes={shapes})"
        return f"Dataset(items, n={self._n})"
