"""LifecycleManager: the model-id → controller map both serving modes
share (counterpart of ``keystone_tpu/lifecycle/manager.py``).

Single-model gateways hold one controller under the model's name (the
bare ``/feedback`` and ``/lifecyclez`` routes resolve to it); the zoo
attaches the same manager (``ModelZoo.attach_lifecycle``) so
``/feedback/<model>`` and the per-model ``/lifecyclez`` document work
identically with many resident models. Deliberately tiny and
dependency-light — the HTTP layer imports this module, not the
controller stack."""

from __future__ import annotations

import threading
from typing import Dict, List, Optional


class LifecycleManager:
    """Thread-safe registry of per-model lifecycle controllers."""

    def __init__(self):
        self._lock = threading.Lock()
        self._controllers: Dict[str, object] = {}  # guarded-by: _lock
        self._default: Optional[str] = None  # guarded-by: _lock

    def add(self, controller, default: bool = False) -> None:
        with self._lock:
            name = controller.name
            if name in self._controllers:
                raise ValueError(f"duplicate lifecycle model {name!r}")
            self._controllers[name] = controller
            if default or self._default is None:
                self._default = name

    def get(self, model_id: Optional[str] = None):
        """The controller for ``model_id`` (None -> the default), or
        None when nothing matches."""
        with self._lock:
            if model_id is None:
                model_id = self._default
            return self._controllers.get(model_id)

    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._controllers)

    def status(self) -> Dict:
        """The ``/lifecyclez`` document: every model's controller
        status keyed by model id."""
        with self._lock:
            controllers = list(self._controllers.values())
            default = self._default
        return {
            "default_model": default,
            "models": {c.name: c.status() for c in controllers},
        }

    def tick_all(self) -> Dict:
        with self._lock:
            controllers = list(self._controllers.values())
        return {c.name: c.tick() for c in controllers}

    def close(self) -> None:
        with self._lock:
            controllers = list(self._controllers.values())
            self._controllers.clear()
        for c in controllers:
            c.close()


__all__ = ["LifecycleManager"]
