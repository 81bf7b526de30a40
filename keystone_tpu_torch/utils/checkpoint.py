"""Loop-state checkpointing for long-running block solvers (counterpart
of ``keystone_tpu/utils/checkpoint.py``).

Reference: KernelRidgeRegression.scala:200-210 checkpoints the model RDDs'
lineage every 25 column blocks so a Spark executor failure doesn't replay
the whole Gauss-Seidel history. The equivalent here is a periodic atomic
host snapshot of the *compact* loop state (the block models — large
intermediates like the residual are recomputed from them on resume, which
is what lineage truncation buys Spark), which a re-run picks up after a
crash or a preempted job.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch


class LoopCheckpointer:
    """Cadenced atomic ``.npz`` snapshots of a solver loop's state.

    ``tick(state_fn)`` is called once per completed step; every ``every``
    steps it materializes ``state_fn()`` (a dict of arrays/scalars) and
    writes it atomically (tmp file + ``os.replace``), so a crash mid-write
    never corrupts the last good snapshot.

    ``fingerprint`` (solver config + data shape digest) is stamped into
    every snapshot; ``load`` discards a snapshot whose stamp differs — a
    re-run with a changed hyperparameter, block layout, or dataset must
    start fresh, not silently mix stale partial state into a new fit.
    """

    FP_KEY = "__fingerprint__"

    def __init__(self, path: str, every: int = 25,
                 fingerprint: Optional[str] = None):
        if every < 1:
            raise ValueError(f"checkpoint cadence must be >= 1, got {every}")
        self.path = path
        self.every = every
        self.fingerprint = fingerprint
        self._count = 0

    def tick(self, state_fn: Callable[[], Dict[str, np.ndarray]]) -> bool:
        self._count += 1
        if self._count % self.every == 0:
            self.save(state_fn())
            return True
        return False

    def save(self, state: Dict[str, np.ndarray]) -> None:
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        tmp = self.path + ".tmp"
        out = {k: np.asarray(v) for k, v in state.items()}
        if self.fingerprint is not None:
            out[self.FP_KEY] = np.frombuffer(
                self.fingerprint.encode(), np.uint8
            )
        with open(tmp, "wb") as f:
            np.savez(f, **out)
        os.replace(tmp, self.path)

    def load(self) -> Optional[Dict[str, np.ndarray]]:
        if not os.path.exists(self.path):
            return None
        try:
            with np.load(self.path, allow_pickle=False) as z:
                state = {k: z[k] for k in z.files}
        except Exception as e:  # torn write on non-atomic mounts, or a
            # pre-existing non-npz file: recovery must not crash recovery
            import logging

            logging.getLogger(__name__).warning(
                "checkpoint %s is unreadable (%s); starting fresh",
                self.path, e,
            )
            return None
        saved_fp = state.pop(self.FP_KEY, None)
        if self.fingerprint is not None:
            got = (
                bytes(saved_fp).decode() if saved_fp is not None else None
            )
            if got != self.fingerprint:
                import logging

                logging.getLogger(__name__).warning(
                    "checkpoint %s was written by a different solver "
                    "config/dataset (stamp %r != %r); starting fresh",
                    self.path, got, self.fingerprint,
                )
                return None
        return state

    def clear(self) -> None:
        for p in (self.path, self.path + ".tmp"):
            if os.path.exists(p):
                os.remove(p)


def data_probe(X: torch.Tensor, Y: torch.Tensor) -> str:
    """Cheap dataset digest for checkpoint fingerprints: full sums plus a
    row-index-weighted sum and a few strided row sums of each operand, so
    a re-run on data that shares row 0 but differs elsewhere (re-labeled
    targets, shuffled tail, ...) invalidates the snapshot instead of
    silently resuming from it. Float32 accumulation without a float32
    copy of a bf16 ``X``; one host transfer per operand."""
    fmt = lambda v: ",".join(f"{p:.6e}" for p in v.cpu().numpy())
    return f"{fmt(_probe_one(X))}|{fmt(_probe_one(Y))}"


def _probe_one(A: torch.Tensor) -> torch.Tensor:
    n = A.shape[0]
    rows = [0, n // 3, (2 * n) // 3, n - 1]
    # the row-index weights make the digest order-sensitive (plain sums
    # are permutation-invariant, and sampled rows can all land outside a
    # reordered span); they are integers below 98, exact in bf16
    w = (torch.arange(n, device=A.device) % 97 + 1).to(A.dtype)
    wsum = torch.sum(torch.matmul(w, A) if A.ndim == 2 else w * A, dtype=torch.float32)
    return torch.stack(
        [torch.sum(A, dtype=torch.float32), wsum]
        + [torch.sum(A[r], dtype=torch.float32) for r in rows]
    )


def two_level_schedule(n_outer: int, n_inner: int, start=(0, 0)):
    """Iterate a resumable (sweep, block) double loop from ``start``,
    yielding ``(outer, inner, next_start)`` — ``next_start`` is the state
    to stamp into a snapshot taken after this step completes (wraps to
    ``(outer + 1, 0)`` at the end of a sweep). Shared by every
    checkpointable block solver so the wraparound/resume-offset idioms
    live in exactly one place."""
    so, sp = start
    for outer in range(so, n_outer):
        for inner in range(sp if outer == so else 0, n_inner):
            nxt = (outer, inner + 1) if inner + 1 < n_inner \
                else (outer + 1, 0)
            yield outer, inner, nxt
