"""Compare two bench rounds: ``python -m keystone_tpu_torch bench-diff
A.json B.json`` (counterpart of ``keystone_tpu/bench_diff.py``).

Both inputs are bench-round artifacts — either the JSONL the bench
binaries print (one ``{"metric":..., "value":..., "unit":...}`` object
per line) or a JSON array of those rows (the
``BENCH_r{N}.json`` files). The diff walks the headline metric of every row
present in BOTH rounds and flags regressions beyond a per-row
tolerance, exiting nonzero when any row regressed (or vanished) — the
CI shape: ``bin/bench-diff last-green.json this-round.json``.

Direction is inferred from the row's ``unit``: latency-like units
(``ms``, ``s``, ``seconds``) regress UPWARD, rate-like units
(``examples/sec``, ``x``, ``rate``, ``tflops``, efficiency/fraction
units) regress DOWNWARD, and units this table can't classify are
reported but never gated (a diff that guessed directions would
manufacture red rounds). Tolerance resolution per row: an explicit
``--set metric=tol`` override, else the row's own ``"tolerance"``
field when the emitter embedded one, else ``--tolerance`` when given,
else the unit class's default (latency rows jitter more than counter
rows and get more slack).

stdlib-only by design, like ``analysis/``: the diff must run in CI
hooks without paying the torch import.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple

# unit -> (direction, default tolerance); direction is which way a
# REGRESSION moves: "up" = bigger is worse, "down" = smaller is worse
_LOWER_IS_BETTER = {
    "ms": 0.15,  # p99/latency rows: scheduler jitter needs slack
    "s": 0.15,
    "seconds": 0.15,
    "ms_to_first_predict": 0.15,
    "psi": 0.25,  # drift scores wander with the sampled mixture
    "bytes": 0.05,
}
_HIGHER_IS_BETTER = {
    "examples/sec": 0.10,
    "imgs/sec": 0.10,
    "examples/sec/chip": 0.10,
    "x": 0.10,  # speedups
    "rate": 0.05,
    "tflops": 0.10,
    "padding_efficiency": 0.05,
    "fraction": 0.05,
    "accuracy": 0.02,
}


def classify(unit: str) -> Optional[Tuple[str, float]]:
    """``(direction, default_tolerance)`` for a unit, or None when the
    unit carries no comparable direction (``skipped``, ad-hoc units)."""
    if unit in _LOWER_IS_BETTER:
        return "up", _LOWER_IS_BETTER[unit]
    if unit in _HIGHER_IS_BETTER:
        return "down", _HIGHER_IS_BETTER[unit]
    return None


def load_rows(path: str) -> Dict[str, Dict]:
    """One row per metric from a bench artifact: JSONL, a JSON array,
    or ``{"rows": [...]}``. Later duplicates of a metric are ignored —
    same rule as the emitters' one-row-per-metric guard."""
    with open(path) as fh:
        text = fh.read()
    rows: List[Dict] = []
    stripped = text.lstrip()
    if stripped.startswith("[") or stripped.startswith("{"):
        try:
            doc = json.loads(text)
        except json.JSONDecodeError:
            doc = None
        if isinstance(doc, list):
            rows = [r for r in doc if isinstance(r, dict)]
        elif isinstance(doc, dict) and isinstance(doc.get("rows"), list):
            rows = [r for r in doc["rows"] if isinstance(r, dict)]
    if not rows:  # JSONL (possibly with non-JSON log lines interleaved)
        for line in text.splitlines():
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(row, dict):
                rows.append(row)
    out: Dict[str, Dict] = {}
    for row in rows:
        metric = row.get("metric")
        if isinstance(metric, str) and metric not in out:
            out[metric] = row
    return out


def diff_rows(
    old: Dict[str, Dict],
    new: Dict[str, Dict],
    *,
    tolerance: Optional[float] = None,
    overrides: Optional[Dict[str, float]] = None,
) -> List[Dict]:
    """One verdict entry per metric seen in either round, sorted with
    regressions first."""
    overrides = overrides or {}
    entries: List[Dict] = []
    for metric in sorted(set(old) | set(new)):
        a, b = old.get(metric), new.get(metric)
        entry: Dict = {"metric": metric}
        if a is None:
            entry.update(verdict="new", new=b.get("value"),
                         unit=b.get("unit"))
            entries.append(entry)
            continue
        if b is None:
            entry.update(verdict="vanished", old=a.get(
                "value"), unit=a.get("unit"))
            entries.append(entry)
            continue
        va, vb = a.get("value"), b.get("value")
        unit = b.get("unit") or a.get("unit") or ""
        entry.update(old=va, new=vb, unit=unit)
        if a.get("skipped") or b.get("skipped") or va is None or vb is None:
            entry["verdict"] = "skipped"
            entries.append(entry)
            continue
        cls = classify(unit)
        if cls is None:
            entry["verdict"] = "uncomparable"
            entries.append(entry)
            continue
        direction, default_tol = cls
        tol = overrides.get(metric)
        if tol is None:
            for row in (b, a):
                if isinstance(row.get("tolerance"), (int, float)):
                    tol = float(row["tolerance"])
                    break
        if tol is None:
            tol = tolerance if tolerance is not None else default_tol
        entry["tolerance"] = tol
        if va == 0:
            change = 0.0 if vb == 0 else float("inf")
        else:
            change = (vb - va) / abs(va)
        entry["change"] = (
            round(change, 4) if change != float("inf") else None
        )
        worse = change > tol if direction == "up" else change < -tol
        better = change < -tol if direction == "up" else change > tol
        entry["verdict"] = (
            "regressed" if worse else "improved" if better else "ok"
        )
        entries.append(entry)
    order = {"regressed": 0, "vanished": 1}
    entries.sort(key=lambda e: (order.get(e["verdict"], 2), e["metric"]))
    return entries


def _format(entry: Dict) -> str:
    mark = {
        "regressed": "REGRESSED", "vanished": "VANISHED",
        "improved": "improved", "ok": "ok", "new": "new",
        "skipped": "skipped", "uncomparable": "?",
    }[entry["verdict"]]
    parts = [f"{mark:9s} {entry['metric']}"]
    if "old" in entry and "new" in entry:
        parts.append(f"{entry.get('old')} -> {entry.get('new')} "
                     f"{entry.get('unit', '')}")
    elif "new" in entry:
        parts.append(f"{entry.get('new')} {entry.get('unit', '')}")
    elif "old" in entry:
        parts.append(f"was {entry.get('old')} {entry.get('unit', '')}")
    if entry.get("change") is not None:
        parts.append(f"({entry['change'] * 100:+.1f}% vs "
                     f"tol {entry['tolerance'] * 100:.0f}%)")
    return "  ".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="keystone_tpu_torch bench-diff", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("old", help="baseline bench round (JSON/JSONL)")
    ap.add_argument("new", help="candidate bench round (JSON/JSONL)")
    ap.add_argument("--tolerance", type=float, default=None,
                    metavar="FRAC",
                    help="uniform relative tolerance for every row "
                    "(default: per-unit-class defaults; latency rows "
                    "0.15, rate rows 0.10, counters 0.05)")
    ap.add_argument("--set", action="append", default=[],
                    metavar="METRIC=FRAC", dest="sets",
                    help="per-metric tolerance override (repeatable)")
    ap.add_argument("--allow-missing", action="store_true",
                    help="a metric present in OLD but absent from NEW "
                    "is reported but does not fail the diff (for "
                    "rounds that ran different row subsets)")
    ap.add_argument("--json", action="store_true",
                    help="emit the verdict entries as one JSON "
                    "document instead of the table")
    args = ap.parse_args(argv)

    overrides: Dict[str, float] = {}
    for spec in args.sets:
        metric, _, tol = spec.partition("=")
        try:
            overrides[metric] = float(tol)
        except ValueError:
            ap.error(f"--set wants METRIC=FRAC, got {spec!r}")

    try:
        old = load_rows(args.old)
        new = load_rows(args.new)
    except OSError as e:
        print(f"bench-diff: {e}", file=sys.stderr)
        return 2
    if not old:
        print(f"bench-diff: no bench rows in {args.old}",
              file=sys.stderr)
        return 2

    entries = diff_rows(
        old, new, tolerance=args.tolerance, overrides=overrides
    )
    failing = [
        e for e in entries
        if e["verdict"] == "regressed"
        or (e["verdict"] == "vanished" and not args.allow_missing)
    ]
    if args.json:
        print(json.dumps(
            {"entries": entries,
             "regressions": [e["metric"] for e in failing]},
            indent=1,
        ))
    else:
        for entry in entries:
            print(_format(entry))
        print(
            f"{len(entries)} metrics compared, "
            f"{len(failing)} regression(s)"
        )
    return 1 if failing else 0


if __name__ == "__main__":
    raise SystemExit(main())
