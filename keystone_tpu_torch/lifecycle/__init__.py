"""Online model lifecycle: streaming refit → shadow → canary → swap
with auto-rollback (counterpart of ``keystone_tpu/lifecycle``).

Only the dependency-light modules are eager (``policy`` is pure
dataclasses, ``manager`` is a dict behind a lock) — the controller
stack pulls in torch and the serving engines and is imported by the
processes that actually run a lifecycle, not by everyone who routes to
one."""

from keystone_tpu_torch.lifecycle.manager import LifecycleManager
from keystone_tpu_torch.lifecycle.policy import (
    GateInputs,
    PolicyState,
    PromotionConfig,
    tick,
)

__all__ = [
    "GateInputs",
    "LifecycleManager",
    "PolicyState",
    "PromotionConfig",
    "tick",
]
