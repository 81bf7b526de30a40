"""Lazy PEP 562 package exports: importing the package root loads no
submodule (and so no torch) until a name is asked for.
"""

from __future__ import annotations

import importlib


def make_getattr(pkg_name: str, exports: dict):
    """Module-level ``__getattr__`` for ``pkg_name``: re-export names
    from ``exports`` {name: module}, fall back to importing
    ``pkg_name.name`` submodules on demand (the eager imports used to
    bind subpackages as side effects), and keep missing-DEPENDENCY
    errors loud (only a missing submodule itself becomes
    AttributeError)."""

    def __getattr__(name):
        if name in exports:
            return getattr(importlib.import_module(exports[name]), name)
        try:
            return importlib.import_module(f"{pkg_name}.{name}")
        except ModuleNotFoundError as e:
            if e.name == f"{pkg_name}.{name}":
                raise AttributeError(
                    f"module {pkg_name!r} has no attribute {name!r}"
                ) from None
            raise  # a real missing dependency inside the submodule

    return __getattr__
