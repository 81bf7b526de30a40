"""A bounded least-recently-used cache of per-shape operators.

The SIFT and LCS extractors build their sampling operators once per image
shape on the device. Images at their native sizes come in many shapes, so
the caches keep at most ``capacity`` shapes and drop the one used longest
ago. A CUDA graph that reads a dropped operator keeps its own reference
(``_cuda.keep_alive``), so dropping one never frees memory a replay reads.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Hashable

OPERATOR_SHAPES = 64

# one lock for every cache: a cache lives in a node's __dict__, which must
# stay picklable
_lock = threading.Lock()


class LRUCache:
    """At most ``capacity`` entries; a lookup makes its entry the newest."""

    def __init__(self, capacity: int = OPERATOR_SHAPES):
        if capacity < 1:
            raise ValueError("capacity must be at least 1")
        self.capacity = capacity
        self._entries: "OrderedDict[Hashable, Any]" = OrderedDict()

    def get_or_make(self, key: Hashable, make: Callable[[], Any]) -> Any:
        """The entry of ``key``, made by ``make()`` (outside the lock) when
        there is none; the oldest entries go past ``capacity``."""
        with _lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                return hit
        value = make()
        with _lock:
            value = self._entries.setdefault(key, value)
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
        return value

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self):
        return list(self._entries)

    def get(self, key: Hashable) -> Any:
        """The entry of ``key``, or None; does not make one."""
        with _lock:
            return self._entries.get(key)

    def put(self, key: Hashable, value: Any) -> None:
        """Set ``key``'s entry (what the AOT store hands back), the newest."""
        with _lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
