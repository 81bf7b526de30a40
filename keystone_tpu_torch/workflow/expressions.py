"""Lazy memoized value wrappers passed between operators at execution time.

Reference semantics: workflow/Expression.scala (DatasetExpression /
DatumExpression / TransformerExpression) — call-by-name thunks whose value is
computed at most once.
"""

from __future__ import annotations

from typing import Any, Callable


class Expression:
    """A lazily computed, memoized value."""

    _UNSET = object()

    def __init__(self, thunk: Callable[[], Any]):
        self._thunk = thunk
        self._value: Any = Expression._UNSET

    def get(self) -> Any:
        if self._value is Expression._UNSET:
            self._value = self._thunk()
            self._thunk = None  # free captured state
        return self._value

    @property
    def is_computed(self) -> bool:
        return self._value is not Expression._UNSET

    @classmethod
    def of(cls, value: Any) -> "Expression":
        e = cls(lambda: value)
        e.get()
        return e


class DatasetExpression(Expression):
    """Wraps a (lazy) Dataset — the N-example collection type."""


class DatumExpression(Expression):
    """Wraps a (lazy) single datum."""


class TransformerExpression(Expression):
    """Wraps a (lazy) fit TransformerOperator."""
