"""Prometheus text exposition format v0.0.4 (counterpart of
``keystone_tpu/observability/prometheus.py``: the rendering half, copied
as it is — a scrape's body from ``MetricsRegistry.collect()``).

Rules implemented:
- metric names must match ``[a-zA-Z_:][a-zA-Z0-9_:]*`` — invalid
  characters are replaced with ``_`` and a leading digit is prefixed;
- label names must match ``[a-zA-Z_][a-zA-Z0-9_]*`` (no colons);
- label VALUES may contain any UTF-8 but backslash, double-quote and
  newline must be escaped as ``\\\\``, ``\\"`` and ``\\n``;
- HELP text escapes backslash and newline (quotes are legal there);
- every family gets one ``# HELP`` + ``# TYPE`` block, and the body
  ends with a trailing newline;
- a histogram-bucket sample carrying an exemplar appends the
  OpenMetrics exemplar syntax ``# {trace_id="..."} value timestamp``,
  but ONLY in the OpenMetrics rendering (``render(...,
  openmetrics=True)``), which also ends with ``# EOF``.

The parse and merge functions of the JAX module (the fleet's federated
scrape) are not ported.
"""

from __future__ import annotations

import math
import re
from typing import Iterable

from keystone_tpu_torch.observability.registry import MetricFamily

_METRIC_INVALID = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_INVALID = re.compile(r"[^a-zA-Z0-9_]")


def sanitize_metric_name(name: str) -> str:
    name = _METRIC_INVALID.sub("_", name)
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def sanitize_label_name(name: str) -> str:
    name = _LABEL_INVALID.sub("_", name)
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def escape_label_value(value: str) -> str:
    # backslash FIRST or the other escapes' backslashes double-escape
    return (
        str(value)
        .replace("\\", r"\\")
        .replace('"', r"\"")
        .replace("\n", r"\n")
    )


def escape_help(text: str) -> str:
    return str(text).replace("\\", r"\\").replace("\n", r"\n")


def format_le(bound: float) -> str:
    """A histogram bucket bound as its canonical ``le`` label value
    (what promtool emits: ``0.005``, ``1``, ``2.5``, ``+Inf``) so the
    same bound always produces the same series identity."""
    if math.isinf(bound):
        return "+Inf" if bound > 0 else "-Inf"
    if float(bound).is_integer():
        return str(int(bound))
    return repr(float(bound))


def format_value(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int) or (isinstance(v, float) and v.is_integer()):
        return str(int(v))
    return repr(float(v))


def format_exemplar(exemplar) -> str:
    """The OpenMetrics exemplar tail of a bucket line:
    ``# {trace_id="..."} value timestamp``."""
    labelstr = ",".join(
        f'{sanitize_label_name(k)}="{escape_label_value(v)}"'
        for k, v in exemplar.labels.items()
    )
    return (
        f" # {{{labelstr}}} {format_value(exemplar.value)}"
        f" {repr(float(exemplar.timestamp_s))}"
    )


def render_family(family: MetricFamily, exemplars: bool = False) -> str:
    name = sanitize_metric_name(family.name)
    lines = []
    if family.help:
        lines.append(f"# HELP {name} {escape_help(family.help)}")
    lines.append(f"# TYPE {name} {family.mtype}")
    for s in family.samples:
        if s.labels:
            labelstr = "{" + ",".join(
                f'{sanitize_label_name(k)}="{escape_label_value(v)}"'
                for k, v in s.labels.items()
            ) + "}"
        else:
            labelstr = ""
        line = f"{name}{s.suffix}{labelstr} {format_value(s.value)}"
        if exemplars and getattr(s, "exemplar", None) is not None:
            line += format_exemplar(s.exemplar)
        lines.append(line)
    return "\n".join(lines) + "\n"


def render(
    families: Iterable[MetricFamily], openmetrics: bool = False
) -> str:
    """Families (from ``MetricsRegistry.collect()``) -> the full
    exposition body. ``openmetrics=True`` switches to the (best-effort)
    OpenMetrics rendering: exemplar tails on histogram buckets plus the
    required ``# EOF`` terminator — never emitted in the classic
    v0.0.4 rendering, whose parsers reject mid-line ``#``."""
    body = "".join(
        render_family(f, exemplars=openmetrics)
        for f in sorted(families, key=lambda f: f.name)
    )
    if openmetrics:
        body += "# EOF\n"
    return body
