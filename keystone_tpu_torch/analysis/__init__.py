"""keystone-lint for the port: AST-driven contract analysis of
``keystone_tpu_torch/``'s own concurrency and hot-path invariants
(counterpart of ``keystone_tpu/analysis/``).

KeystoneML's core idea — a rule engine that mechanically checks and
rewrites pipeline DAGs — pointed at our own source: every rule here is
a defect class a human review actually caught (lock discipline around
the tracer ring / staging-bytes gauge / request-log close, blocking
work under the pool lock, ``-O``-strippable asserts in enforcement
paths, zeros stamped on degradable metric series, host syncs on the
serving hot path, fault-point catalog drift, dark metric families),
turned into a checked invariant so refactors keep them for free. The
port's rules know PyTorch's spellings of a host sync (``.cpu()``,
``.numpy()``, ``.tolist()``, ``.synchronize()``) and of blocking device
work under a lock (a CUDA graph capture, a stream or card sync).

Stdlib-only by design (``ast`` + ``tokenize`` comments): the linter
must run in CI images and pre-commit hooks without paying the torch
import, so nothing in this package may import torch, jax or any
keystone module that does.

Entry points: ``python -m keystone_tpu_torch keystone-lint`` (cli.py)
and ``tests/test_torch_analysis.py`` (the tier-1 gate — the analyzer
runs over ``keystone_tpu_torch/`` inside the normal test suite and
fails on any unbaselined finding). The baseline is
``keystone_tpu_torch/analysis/LINT_BASELINE.json``.
"""

from keystone_tpu_torch.analysis.core import (
    Baseline,
    FileContext,
    Finding,
    Project,
    Rule,
    run_analysis,
)
from keystone_tpu_torch.analysis.rules import ALL_RULES, default_rules

__all__ = [
    "ALL_RULES",
    "Baseline",
    "FileContext",
    "Finding",
    "Project",
    "Rule",
    "default_rules",
    "run_analysis",
]
