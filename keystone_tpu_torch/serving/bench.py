"""The demo model the gateway serves without a featurize chain
(counterpart of ``keystone_tpu/serving/bench.py``'s ``_Affine``,
``build_pipeline``, ``affine_head`` and ``build_split_pipeline``).

``build_pipeline(d, hidden, depth, seed)`` is a chain of ``depth``
``tanh(x @ W + b)`` nodes whose weights come from
``np.random.default_rng(seed)`` in the JAX package's order, so both
packages serve the same model from one seed. The benchmark rows of the
JAX module are not ported here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import numpy as np
import torch

from keystone_tpu_torch._device import resolve_device
from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.workflow.api import Transformer


@dataclasses.dataclass(eq=False)
class _Affine(Transformer):
    """Per-example tanh(x @ W + b)."""

    W: Any
    b: Any

    def apply(self, x):
        return torch.tanh(x @ self.W + self.b)

    def apply_batch(self, ds: Dataset) -> Dataset:
        if not ds.is_array:
            return self._bucketed_batch(ds)
        return Dataset.from_array(self.apply(ds.padded()), n=ds.n)


def _draws(d: int, hidden: int, depth: int, seed: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The (W, b) of every layer, drawn as the JAX package draws them."""
    rng = np.random.default_rng(seed)
    dims = [d] + [hidden] * (depth - 1) + [d]
    return [
        ((rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32)
          / np.sqrt(dims[i])),
         np.zeros(dims[i + 1], np.float32))
        for i in range(depth)
    ]


def _param(a, dev) -> torch.Tensor:
    """A float32 copy of ``a`` (numpy, or a tensor on any device) on ``dev``."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=dev, dtype=torch.float32).clone()
    return torch.tensor(np.asarray(a, np.float32), device=dev)


def affine_chain(layers, device=None):
    """A fitted chain of ``tanh(x @ W + b)`` nodes from ``(W, b)`` pairs
    (numpy, or tensors: a refit's solved head), on ``device`` (``None``
    means ``cuda``)."""
    dev = resolve_device(device)
    pipe = None
    for W, b in layers:
        node = _Affine(_param(W, dev), _param(b, dev))
        pipe = node.to_pipeline() if pipe is None else pipe.and_then(node)
    return pipe.to_pipeline().fit()


def build_pipeline(d: int = 256, hidden: int = 512, depth: int = 4, seed: int = 0,
                   device=None):
    """An estimator-free chain of ``depth`` affine+tanh nodes ->
    FittedPipeline, on ``device`` (``None`` means ``cuda``)."""
    return affine_chain(_draws(d, hidden, depth, seed), device)


def affine_head(W, b, device=None):
    """One ``tanh(x @ W + b)`` node as a standalone FittedPipeline;
    ``base.and_then(affine_head(W, b))`` composes it back onto a base."""
    return affine_chain([(W, b)], device)


def build_split_pipeline(d: int = 256, hidden: int = 512, depth: int = 4, seed: int = 0,
                         device=None):
    """``build_pipeline`` split at the last layer: ``(base, W, b)`` with
    ``base`` the first ``depth - 1`` layers and ``(W, b)`` the last one's
    numpy weights; ``base.and_then(affine_head(W, b))`` is the same model."""
    if depth < 2:
        raise ValueError(f"split needs depth >= 2, got {depth}")
    layers = _draws(d, hidden, depth, seed)
    head_w, head_b = layers[-1]
    return affine_chain(layers[:-1], device), head_w, head_b
