"""Operator ABI — the untyped execution contract of graph nodes.

Reference semantics: workflow/Operator.scala — ``execute(deps) -> Expression``
with concrete operators for constant datasets/datums, transformers (dual
single/batch paths), estimators (fit -> transformer), the delegating operator
(applies a fit transformer expression), and constant-expression operators
(loaded saved state).

Equality drives common-subexpression elimination (EquivalentNodeMergeRule):
operators compare by ``eq_key()`` which defaults to identity; dataclass-style
nodes should override (the Transformer/Estimator base classes in api.py do).
"""

from __future__ import annotations

from typing import Any, Sequence

from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.workflow.expressions import (
    DatasetExpression,
    DatumExpression,
    Expression,
    TransformerExpression,
)


# The caches nodes attach to themselves on first use, left out of a
# pickle (FittedPipeline.save) and rebuilt on first use after a load: the
# eq_key digests (api.py) hold tensor references keyed by id(), the SIFT
# and LCS operators and GrayScaler's weights are device tensors, and an
# LRU cache's lock cannot be pickled
LAZY_CACHES = ("_arr_digest_cache", "_operator_cache", "_weight_cache")


def cached_on(node, name: str, make, device):
    """``make()`` (a tensor) on ``device``, made once per (name, device)
    and kept in the node's ``_weight_cache``: a dispatch then copies
    nothing from the host, which a CUDA graph capture refuses."""
    cache = node.__dict__.setdefault("_weight_cache", {})
    key = (name, str(device))
    t = cache.get(key)
    if t is None:
        t = cache[key] = make().to(device)
    return t


class Operator:
    label: str = ""

    def execute(self, deps: Sequence[Expression]) -> Expression:
        raise NotImplementedError

    def eq_key(self) -> Any:
        """Key for CSE equality. Default: object identity."""
        return id(self)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Operator) and self.eq_key() == other.eq_key()

    def __hash__(self) -> int:
        return hash(self.eq_key())

    def __getstate__(self):
        state = dict(self.__dict__)
        for name in LAZY_CACHES:
            state.pop(name, None)
        return state


class DatasetOperator(Operator):
    """Constant dataset (reference: DatasetOperator wrapping an RDD)."""

    def __init__(self, dataset: Dataset, label: str = "dataset"):
        self.dataset = Dataset.of(dataset)
        self.label = label

    def eq_key(self):
        # Same underlying Dataset object => same operator (the reference's
        # case-class equality over a shared RDD reference), so prefixes built
        # from the same data compare equal across pipelines.
        return ("dataset", id(self.dataset))

    def execute(self, deps: Sequence[Expression]) -> Expression:
        if deps:
            raise AssertionError(
                f"DatasetOperator takes no dependencies, got {len(deps)}"
            )
        return DatasetExpression.of(self.dataset)


class DatumOperator(Operator):
    """Constant single datum."""

    def __init__(self, datum: Any, label: str = "datum"):
        self.datum = datum
        self.label = label

    def eq_key(self):
        return ("datum", id(self.datum))

    def execute(self, deps: Sequence[Expression]) -> Expression:
        if deps:
            raise AssertionError(
                f"DatumOperator takes no dependencies, got {len(deps)}"
            )
        return DatumExpression.of(self.datum)


class TransformerOperator(Operator):
    """A data -> data operator with single-datum and batch paths."""

    def single_transform(self, inputs: Sequence[Any]) -> Any:
        raise NotImplementedError

    def batch_transform(self, inputs: Sequence[Dataset]) -> Dataset:
        raise NotImplementedError

    def execute(self, deps: Sequence[Expression]) -> Expression:
        if any(isinstance(d, DatasetExpression) for d in deps):
            return DatasetExpression(
                lambda: self.batch_transform([d.get() for d in deps])
            )
        return DatumExpression(
            lambda: self.single_transform([d.get() for d in deps])
        )


class EstimatorOperator(Operator):
    """fit(datasets) -> TransformerOperator."""

    def fit_datasets(self, datasets: Sequence[Dataset]) -> TransformerOperator:
        raise NotImplementedError

    def execute(self, deps: Sequence[Expression]) -> Expression:
        return TransformerExpression(
            lambda: self.fit_datasets([d.get() for d in deps])
        )


class DelegatingOperator(Operator):
    """Applies a fit transformer (dep 0) to the remaining deps.

    This is the node an ``Estimator.with_data`` splice leaves downstream of
    the estimator; Pipeline.fit() swaps it for the concrete fit transformer.
    """

    label = "delegate"

    def execute(self, deps: Sequence[Expression]) -> Expression:
        transformer_expr = deps[0]
        data_deps = deps[1:]
        if not data_deps:
            raise AssertionError(
                "delegating operator needs data dependencies"
            )
        if any(isinstance(d, DatasetExpression) for d in data_deps):
            return DatasetExpression(
                lambda: transformer_expr.get().batch_transform(
                    [d.get() for d in data_deps]
                )
            )
        return DatumExpression(
            lambda: transformer_expr.get().single_transform(
                [d.get() for d in data_deps]
            )
        )


class ExpressionOperator(Operator):
    """Constant pre-computed expression (loaded saved state)."""

    label = "saved"

    def __init__(self, expression: Expression):
        self.expression = expression

    def execute(self, deps: Sequence[Expression]) -> Expression:
        if deps:
            raise AssertionError(
                f"ExpressionOperator takes no dependencies, got {len(deps)}"
            )
        return self.expression
