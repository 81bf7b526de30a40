"""Streaming refit: labeled feedback → incremental normal equations →
a re-solved head (counterpart of ``keystone_tpu/lifecycle/refit.py``).

The served demo model ends in a ``tanh(x @ W + b)`` head over a frozen
feature base (``serving/bench.build_split_pipeline``). Because the
normal-equations state is ADDITIVE, "refit" is never a full refit: each
labeled chunk folds into ``(G, AY, n)`` once and a candidate head is one
regularized PSD solve over the running state (``_psd_solve_device``, the
block solver's factor-and-refine solve).

Math: serving outputs are ``y = tanh(z)`` with ``z = h @ W + b`` over
base features ``h``, so labels are mapped to pre-activation targets
``z = arctanh(clip(y))`` and the head is the ridge solution of the
AUGMENTED system ``[h, 1] @ W_aug = z`` — the ones column carries the
bias, and a 0/1 validity mask zeroes padded rows so every chunk runs
through one fixed-shape update: two products and a concatenation on the
gateway's device, float32 with TF32 off (``_device`` sets it), as the
JAX package runs them through XLA outside any Pallas kernel.

Held-out labels: every ``holdout_every``-th feedback row is diverted to
a bounded holdout buffer and NEVER accumulated — the accuracy gate
compares candidate vs incumbent on data neither was solved from. The
``lifecycle.refit.poison`` chaos point corrupts an accumulated chunk's
targets (the holdout stays clean), which is how the rollback drill
proves the accuracy gate fires.
"""

from __future__ import annotations

import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

from keystone_tpu_torch._device import resolve_device
from keystone_tpu_torch.loadgen import faults
from keystone_tpu_torch.ops.learning.block_ls import _psd_solve_device

# labels are tanh outputs in (-1, 1); clip before arctanh so a label
# AT the rail maps to a large-but-finite pre-activation target
_CLIP = 1.0 - 1e-5


def _accum_update(G, AY, H, Z, mask):
    Ha = torch.cat([H * mask[:, None], mask[:, None]], dim=1)
    return G + Ha.T @ Ha, AY + Ha.T @ (Z * mask[:, None])


class RefitAccumulator:
    """Incremental ``(G, AY, n)`` over a frozen feature base, plus the
    clean holdout buffer the accuracy gate reads. ``device`` is where
    the base's parameters live and the state accumulates (``None`` means
    ``cuda``)."""

    def __init__(
        self,
        base,
        feature_dim: int,
        out_dim: int,
        *,
        name: str = "default",
        lam: float = 1e-3,
        chunk: int = 64,
        holdout_every: int = 8,
        holdout_cap: int = 512,
        metrics=None,  # LifecycleMetrics; duck-typed
        device=None,
    ):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self._base = base
        self.name = name
        self.lam = float(lam)
        self.chunk = int(chunk)
        self.out_dim = int(out_dim)
        self.device = resolve_device(device)
        self._holdout_every = max(0, int(holdout_every))
        self._holdout_cap = int(holdout_cap)
        self._metrics = metrics
        self._lock = threading.Lock()
        d = int(feature_dim) + 1  # augmented with the bias column
        # guarded-by: _lock (the four below)
        self._G = torch.zeros((d, d), dtype=torch.float32, device=self.device)
        self._AY = torch.zeros((d, out_dim), dtype=torch.float32, device=self.device)
        self._n = 0
        self._seen = 0
        self._hold_x: list = []  # guarded-by: _lock
        self._hold_y: list = []  # guarded-by: _lock

    # -- accumulation ------------------------------------------------------

    @property
    def n_accumulated(self) -> int:
        with self._lock:
            return self._n

    @property
    def n_holdout(self) -> int:
        with self._lock:
            return len(self._hold_x)

    def add(self, instances: Any, labels: Any) -> int:
        """Fold one labeled batch in. Returns the rows ACCUMULATED
        (holdout-diverted rows don't count). Chunk-size independent:
        any split of the same rows lands on the same ``(G, AY, n)``."""
        X = np.asarray(instances, np.float32)
        Y = np.asarray(labels, np.float32)
        if X.ndim != 2 or Y.ndim != 2 or X.shape[0] != Y.shape[0]:
            raise ValueError(
                f"need matching 2-D instances/labels, got {X.shape} "
                f"vs {Y.shape}"
            )
        if Y.shape[1] != self.out_dim:
            raise ValueError(
                f"labels are {Y.shape[1]}-dim, model serves "
                f"{self.out_dim}"
            )
        with self._lock:
            # split the holdout rows out FIRST (a global every-k-th
            # row counter), so the accuracy gate's data never touches
            # the normal equations — poisoned or not
            idx = np.arange(X.shape[0]) + self._seen
            self._seen += X.shape[0]
            if self._holdout_every > 0:
                hold = (idx % self._holdout_every) == 0
            else:
                hold = np.zeros(X.shape[0], bool)
            # cap the buffer; hold-pattern rows past the cap fold
            # into the normal equations like any other row (labels
            # are scarce — none get dropped)
            room = max(0, self._holdout_cap - len(self._hold_x))
            kept = np.where(hold)[0][:room]
            for xi, yi in zip(X[kept], Y[kept]):
                self._hold_x.append(xi)
                self._hold_y.append(yi)
            keep = np.ones(X.shape[0], bool)
            keep[kept] = False
            X, Y = X[keep], Y[keep]
            accumulated = int(X.shape[0])
            for start in range(0, X.shape[0], self.chunk):
                self._accumulate_chunk_locked(
                    X[start:start + self.chunk],
                    Y[start:start + self.chunk],
                )
        return accumulated

    def _accumulate_chunk_locked(
        self, xs: np.ndarray, ys: np.ndarray
    ) -> None:
        n = xs.shape[0]
        if n == 0:
            return
        # chaos point: an armed lifecycle.refit.poison corrupts THIS
        # chunk's targets before they fold into (G, AY) — the model
        # the next solve produces is garbage while the holdout buffer
        # (split off above) stays clean, so the accuracy gate must
        # catch it and the controller must roll back. Unarmed: one
        # attribute read, the ctx dict is never built.
        poisoned = faults.armed() and faults.fire(
            "lifecycle.refit.poison", {"model": self.name}
        ) is not None
        pad = self.chunk - n
        if pad:
            xs = np.concatenate(
                [xs, np.zeros((pad, xs.shape[1]), np.float32)]
            )
            ys = np.concatenate(
                [ys, np.zeros((pad, ys.shape[1]), np.float32)]
            )
        mask = np.zeros(self.chunk, np.float32)
        mask[:n] = 1.0
        z = np.arctanh(np.clip(ys, -_CLIP, _CLIP))
        if poisoned:
            z = -40.0 * z
        dev = self.device
        with torch.no_grad():
            H = self._base._batch_run(torch.as_tensor(xs, device=dev))[: self.chunk]
            self._G, self._AY = _accum_update(
                self._G, self._AY, H, torch.as_tensor(z, device=dev),
                torch.as_tensor(mask, device=dev),
            )
        self._n += n
        if self._metrics is not None:
            self._metrics.record_refit_chunk(n)

    # -- solve / holdout ---------------------------------------------------

    def solve(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """One ridge solve over the running state -> ``(W, b)`` for a
        candidate head, on the accumulator's device. Raises if nothing
        was accumulated yet."""
        with self._lock:
            if self._n == 0:
                raise RuntimeError("no feedback accumulated yet")
            # the solve adds lam·I to the Gram in place: a copy keeps
            # the running state (and its snapshots) intact
            W_aug = _psd_solve_device(
                self._G.clone(), self._AY, self.lam * self._n
            )
        return W_aug[:-1], W_aug[-1]

    def holdout_errors(
        self, candidate, incumbent
    ) -> Tuple[Optional[float], Optional[float]]:
        """Held-out MSE of two full fitted pipelines (raw instances
        in, served outputs out). ``(None, None)`` until the holdout
        buffer has samples."""
        with self._lock:
            if not self._hold_x:
                return None, None
            X = np.stack(self._hold_x)
            Y = np.stack(self._hold_y)
        out = []
        with torch.no_grad():
            for fitted in (candidate, incumbent):
                pred = fitted._batch_run(torch.as_tensor(X, device=self.device))
                pred = pred[: X.shape[0]].cpu().numpy()
                out.append(float(np.mean((pred - Y) ** 2)))
        return out[0], out[1]

    # -- rollback support --------------------------------------------------

    def snapshot(self) -> tuple:
        """The accumulated state at solve time — ``restore`` discards
        everything folded in since (a poisoned cycle must not leak
        into the NEXT candidate). Updates build new tensors, so a
        snapshot is never written through."""
        with self._lock:
            return (self._G, self._AY, self._n, self._seen)

    def restore(self, snap: tuple) -> None:
        with self._lock:
            self._G, self._AY, self._n, self._seen = snap


__all__ = ["RefitAccumulator"]
