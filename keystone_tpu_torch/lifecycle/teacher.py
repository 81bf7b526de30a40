"""Synthetic ground truth for labeled-load drills — numpy only
(counterpart of ``keystone_tpu/lifecycle/teacher.py``).

``teacher_labels`` reproduces the demo pipeline's forward math
(``serving/bench.build_pipeline``: ``tanh(x @ W + b)`` per layer, the
identical ``default_rng`` draw order) without importing torch or the
serving stack, so ``serve-loadgen`` can synthesize labeled feedback
traffic against a live gateway from nothing but the model's shape
spec. ``head_seed`` redraws the FINAL layer from its own rng stream:
the served incumbent (head from ``seed``'s stream) is then a STALE
model of this teacher, which is exactly the drill setup — streaming
refit learns the teacher's head from feedback, and the candidate
must beat the incumbent on held-out teacher labels.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np


def teacher_weights(
    d: int, hidden: int, depth: int, seed: int = 0,
    head_seed: Optional[int] = None,
):
    """The demo chain's per-layer ``(W, b)`` list; with ``head_seed``
    the last layer is redrawn from ``default_rng(head_seed)``."""
    rng = np.random.default_rng(seed)
    dims = [d] + [hidden] * (depth - 1) + [d]
    layers = []
    for i in range(depth):
        w = rng.standard_normal((dims[i], dims[i + 1])).astype(
            np.float32
        ) / np.sqrt(dims[i])
        layers.append((w, np.zeros(dims[i + 1], np.float32)))
    if head_seed is not None:
        hrng = np.random.default_rng(head_seed)
        w = hrng.standard_normal((dims[depth - 1], dims[depth])).astype(
            np.float32
        ) / np.sqrt(dims[depth - 1])
        layers[-1] = (w, np.zeros(dims[depth], np.float32))
    return layers


def teacher_labels(
    X,
    d: int,
    hidden: int,
    depth: int,
    seed: int = 0,
    head_seed: Optional[int] = None,
) -> np.ndarray:
    """Ground-truth outputs for instances ``X`` under the (optionally
    head-redrawn) demo model — float32, same tanh chain as serving."""
    h = np.asarray(X, np.float32)
    if h.ndim != 2 or h.shape[1] != d:
        raise ValueError(f"want (n, {d}) instances, got {h.shape}")
    for w, b in _cached_weights(d, hidden, depth, seed, head_seed):
        h = np.tanh(h @ w + b).astype(np.float32)
    return h


# one draw per teacher: a labeled drill labels a row or a few at a time,
# and redrawing hidden² normals for each batch costs far more than the
# forward pass
_cached_weights = functools.lru_cache(maxsize=8)(teacher_weights)


__all__ = ["teacher_weights", "teacher_labels"]
