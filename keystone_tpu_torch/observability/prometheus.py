"""Prometheus text exposition format v0.0.4 (counterpart of
``keystone_tpu/observability/prometheus.py``, copied as it is).

Pure string rendering over ``MetricsRegistry.collect()`` snapshots — no
sockets here (the admin endpoint serves the result; golden-string tests
cover the format without one). Reference:
https://prometheus.io/docs/instrumenting/exposition_formats/

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
  linking the aggregate bucket to one concrete traced request —
  but ONLY in the OpenMetrics rendering (``render(...,
  openmetrics=True)``; the classic v0.0.4 text parser reads the
  mid-line ``#`` as a malformed timestamp and fails the whole scrape,
  so the plain rendering never carries exemplar tails. The endpoints
  content-negotiate via ``negotiate_render``: scrapers that send
  ``Accept: application/openmetrics-text`` (a real Prometheus server
  does by default) get exemplars + the ``# EOF`` terminator.

The reverse direction lives here too: ``parse_samples`` reads an
exposition body back into (name, labels, value) rows and
``quantile_from_buckets`` reproduces PromQL's ``histogram_quantile``
interpolation — so the regression bench reads its p99 from the SAME
``/metrics`` surface operators scrape, not from bench-local counters.

The FLEET direction stacks on those: ``merge_histograms`` sums
per-replica cumulative ``le`` buckets into one fleet-wide histogram
(quantiles of the union, where quantiles-of-quantiles would lie) and
``merge_expositions`` merges whole per-replica scrape bodies into one
federated exposition — the router's ``/metrics``
(the JAX package's ``fleet/``) is exactly that merge over its replicas.
"""

from __future__ import annotations

import logging
import math
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from keystone_tpu_torch.observability.registry import MetricFamily

logger = logging.getLogger(__name__)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)

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


def negotiate_render(
    families: Iterable[MetricFamily], accept: Optional[str]
) -> Tuple[str, str]:
    """Render for a scraper's ``Accept`` header -> ``(body,
    content_type)``: the OpenMetrics rendering (exemplars) when the
    header asks for ``application/openmetrics-text`` — a real
    Prometheus server does by default — else classic v0.0.4 text."""
    if accept and "application/openmetrics-text" in accept:
        return render(families, openmetrics=True), OPENMETRICS_CONTENT_TYPE
    return render(families), CONTENT_TYPE


# -- reading an exposition back (scrape-side helpers) ----------------------

_SAMPLE_LINE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>[^\s#]+)"
)
_LABEL_PAIR = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape_label_value(value: str) -> str:
    return (
        value.replace(r"\n", "\n").replace(r"\"", '"').replace("\\\\", "\\")
    )


def _parse_value(raw: str) -> float:
    if raw == "+Inf":
        return math.inf
    if raw == "-Inf":
        return -math.inf
    if raw == "NaN":
        return math.nan
    return float(raw)


def parse_samples(
    text: str,
) -> List[Tuple[str, Dict[str, str], float]]:
    """An exposition body -> ``(name, labels, value)`` rows. Comments
    (including exemplar tails — the regex stops at ``#``) are skipped;
    this is the scrape-side half of the format the renderer above
    emits, used by the regression bench to read ``/metrics``."""
    out: List[Tuple[str, Dict[str, str], float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_LINE.match(line)
        if not m:
            continue
        labels = {
            k: _unescape_label_value(v)
            for k, v in _LABEL_PAIR.findall(m.group("labels") or "")
        }
        out.append((m.group("name"), labels, _parse_value(m.group("value"))))
    return out


def histogram_buckets(
    text: str, name: str, match_labels: Optional[Dict[str, str]] = None
) -> List[Tuple[float, float]]:
    """The cumulative ``(le, count)`` buckets of one histogram family
    in an exposition body, ``le``-ascending (``+Inf`` last), filtered
    to samples whose labels include ``match_labels``."""
    match_labels = match_labels or {}
    buckets = []
    for sample_name, labels, value in parse_samples(text):
        if sample_name != f"{name}_bucket" or "le" not in labels:
            continue
        if any(labels.get(k) != v for k, v in match_labels.items()):
            continue
        buckets.append((_parse_value(labels["le"]), value))
    return sorted(buckets, key=lambda b: b[0])


def merge_histograms(
    bucket_lists: Sequence[Sequence[Tuple[float, float]]],
) -> List[Tuple[float, float]]:
    """Sum per-replica cumulative ``(le, count)`` bucket lists (each
    the ``histogram_buckets`` output of one scrape) into one
    fleet-wide list — the SLO-federation primitive: cumulative ``le``
    buckets are the ONE latency representation that aggregates
    exactly across hosts, so ``quantile_from_buckets`` over the merge
    is the true fleet quantile (a quantile of per-host quantiles is
    not). Duplicate ``le`` entries within one list (several series of
    one family in a single scrape) collapse by summing first. Empty
    lists are skipped; all non-empty lists must agree on the bucket
    layout — summing cumulative counts across MISALIGNED bounds would
    fabricate a distribution, so a conflict raises ``ValueError``
    instead of merging anyway."""
    merged: Dict[float, float] = {}
    layout: Optional[Tuple[float, ...]] = None
    for buckets in bucket_lists:
        if not buckets:
            continue
        collapsed: Dict[float, float] = {}
        for le, count in buckets:
            collapsed[le] = collapsed.get(le, 0.0) + count
        bounds = tuple(sorted(collapsed))
        if layout is None:
            layout = bounds
        elif bounds != layout:
            raise ValueError(
                "conflicting histogram bucket layouts: "
                f"{[format_le(b) for b in layout]} vs "
                f"{[format_le(b) for b in bounds]}"
            )
        for le, count in collapsed.items():
            merged[le] = merged.get(le, 0.0) + count
    return sorted(merged.items(), key=lambda b: b[0])


_HELP_LINE = re.compile(r"^# HELP (\S+) (.*)$")
_TYPE_LINE = re.compile(r"^# TYPE (\S+) (\S+)$")
_SERIES_SUFFIXES = ("_bucket", "_count", "_sum")

# RATIO families: identical-label samples federate by MAX (worst
# case), never by sum — two replicas each at MFU 0.4 are not a fleet
# at MFU 0.8, and two burn rates of 0.9 summing to a fabricated 1.8
# would page on a healthy fleet. Everything else (counters, le
# buckets, additive gauges like queue depth / inflight / build-info
# ones) sums, which IS the fleet truth for those.
MERGE_MAX_FAMILIES = frozenset({
    "keystone_serving_mfu",
    "keystone_serving_padding_efficiency",
    "keystone_slo_burn_rate",
    "keystone_gateway_slo_pressure",
    # drift is a divergence score, not a quantity: the worst replica's
    # drift is the fleet's drift (two replicas each at 0.3 are not a
    # fleet at 0.6)
    "keystone_drift_score",
})


def merge_expositions(
    texts: Sequence[str], on_conflict: str = "raise"
) -> str:
    """Merge N exposition bodies (per-replica ``/metrics`` scrapes)
    into ONE federated body: samples with identical (name, labels)
    SUM across scrapes — exact for counters and cumulative ``le``
    buckets (replicas of one service share label sets, so their
    series line up), and deliberate for additive gauges (the
    fleet-summed queue depth / in-flight / ready count is the
    router's load truth; ``keystone_build_info`` sums to "replicas
    running this build"). RATIO families (``MERGE_MAX_FAMILIES``:
    MFU, padding efficiency, SLO burn/pressure) take the MAX instead
    — worst-case is the honest fleet aggregation for a ratio, a sum
    would fabricate values. Samples whose labels differ —
    distinctly-named gateways, per-lane engines — coexist untouched,
    one series each.

    ``# HELP``/``# TYPE`` metadata is carried from the first scrape
    that declares it; exemplar tails are comment syntax and do not
    survive the parse (the federated body is classic v0.0.4).

    A histogram family whose scrapes disagree on the ``le`` layout
    for one series cannot be summed honestly: with
    ``on_conflict="raise"`` (default) that's a ``ValueError``; with
    ``"drop"`` the whole family is dropped from the output and logged
    — a live router must keep exposing the families that DO merge."""
    if on_conflict not in ("raise", "drop"):
        raise ValueError(
            f"on_conflict must be 'raise' or 'drop', got {on_conflict!r}"
        )
    # (mtype, help) per family, first scrape that declares each wins
    meta: Dict[str, Tuple[Optional[str], Optional[str]]] = {}
    for text in texts:
        for line in text.splitlines():
            m = _HELP_LINE.match(line)
            if m:
                mtype, help_text = meta.get(m.group(1), (None, None))
                if help_text is None:
                    meta[m.group(1)] = (mtype, m.group(2))
                continue
            m = _TYPE_LINE.match(line)
            if m:
                mtype, help_text = meta.get(m.group(1), (None, None))
                if mtype is None:
                    meta[m.group(1)] = (m.group(2), help_text)
    composite = {
        name
        for name, (mtype, _) in meta.items()
        if mtype in ("histogram", "summary")
    }

    def family_of(name: str) -> str:
        for suffix in _SERIES_SUFFIXES:
            base = name[: -len(suffix)] if name.endswith(suffix) else None
            if base and base in composite:
                return base
        return name

    sums: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    layouts: Dict[Tuple[str, Tuple], Tuple] = {}
    conflicted: set = set()
    for text in texts:
        scrape_layout: Dict[Tuple[str, Tuple], List[float]] = {}
        for name, labels, value in parse_samples(text):
            key = (name, tuple(sorted(labels.items())))
            if name in MERGE_MAX_FAMILIES:
                prev = sums.get(key)
                sums[key] = value if prev is None else max(prev, value)
            else:
                sums[key] = sums.get(key, 0.0) + value
            if name.endswith("_bucket") and "le" in labels:
                base = (
                    family_of(name),
                    tuple(
                        sorted(
                            (k, v) for k, v in labels.items() if k != "le"
                        )
                    ),
                )
                scrape_layout.setdefault(base, []).append(
                    _parse_value(labels["le"])
                )
        for base, les in scrape_layout.items():
            sig = tuple(sorted(les))
            prev = layouts.get(base)
            if prev is None:
                layouts[base] = sig
            elif prev != sig:
                conflicted.add(base[0])
    if conflicted:
        detail = (
            "conflicting histogram bucket layouts across scrapes: "
            + ", ".join(sorted(conflicted))
        )
        if on_conflict == "raise":
            raise ValueError(detail)
        logger.warning("merge_expositions dropped %s", detail)
        sums = {
            key: v
            for key, v in sums.items()
            if family_of(key[0]) not in conflicted
        }

    by_family: Dict[str, List] = {}
    for (name, litems), value in sums.items():
        by_family.setdefault(family_of(name), []).append(
            (name, litems, value)
        )

    def sample_key(entry):
        name, litems, _ = entry
        return (
            name,
            tuple(
                (k, _parse_value(v)) if k == "le" else (k, v)
                for k, v in litems
            ),
        )

    lines: List[str] = []
    for family in sorted(by_family):
        mtype, help_text = meta.get(family, (None, None))
        if help_text is not None:
            lines.append(f"# HELP {family} {escape_help(help_text)}")
        if mtype is not None:
            lines.append(f"# TYPE {family} {mtype}")
        for name, litems, value in sorted(
            by_family[family], key=sample_key
        ):
            if litems:
                labelstr = "{" + ",".join(
                    f'{sanitize_label_name(k)}="{escape_label_value(v)}"'
                    for k, v in litems
                ) + "}"
            else:
                labelstr = ""
            lines.append(
                f"{sanitize_metric_name(name)}{labelstr} "
                f"{format_value(value)}"
            )
    return "\n".join(lines) + "\n" if lines else ""


def quantile_from_buckets(
    q: float, buckets: Sequence[Tuple[float, float]]
) -> Optional[float]:
    """PromQL ``histogram_quantile`` over cumulative ``(le, count)``
    buckets: linear interpolation inside the covering bucket, lower
    bound 0 for the first, and the highest finite bound when the
    quantile lands in ``+Inf``. None with no observations."""
    if not buckets:
        return None
    total = buckets[-1][1]
    if total <= 0:
        return None
    rank = q * total
    prev_le, prev_count = 0.0, 0.0
    for le, count in buckets:
        if count >= rank:
            if math.isinf(le):
                return prev_le  # PromQL clamps to the last finite bound
            if count == prev_count:
                return le
            return prev_le + (le - prev_le) * (
                (rank - prev_count) / (count - prev_count)
            )
        prev_le, prev_count = le, count
    return prev_le
