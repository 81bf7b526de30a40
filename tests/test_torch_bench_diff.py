"""bench-diff in the port (``keystone_tpu_torch/bench_diff.py``) against
the JAX package's (``keystone_tpu/bench_diff.py``): the same pairs of
rounds give the same exit code and the same report, table and JSON."""

import json

import pytest

from keystone_tpu import bench_diff as jdiff
from keystone_tpu_torch import bench_diff as tdiff


def _row(metric, value, unit, **extra):
    return {"metric": metric, "value": value, "unit": unit, **extra}


UNITS = sorted(set(jdiff._LOWER_IS_BETTER) | set(jdiff._HIGHER_IS_BETTER))

# (id, old rows, new rows, extra argv); every unit class moves up, down
# and not at all, past and within its default tolerance
CASES = [
    *[(f"unit-{u.replace('/', '-')}",
       [_row(f"m_{i}", 100.0, u) for i in range(5)],
       [_row("m_0", 130.0, u), _row("m_1", 70.0, u), _row("m_2", 100.0, u),
        _row("m_3", 101.0, u), _row("m_4", 99.0, u)], [])
      for u in UNITS],
    ("uncomparable-unit", [_row("odd", 1.0, "widgets")], [_row("odd", 100.0, "widgets")], []),
    ("tolerance-default", [_row("p99", 10.0, "ms")], [_row("p99", 14.0, "ms")], []),
    ("tolerance-override", [_row("p99", 10.0, "ms")], [_row("p99", 14.0, "ms")],
     ["--set", "p99=0.5", "--tolerance", "0.01"]),
    ("tolerance-row-beats-flag", [_row("p99", 10.0, "ms")],
     [_row("p99", 14.0, "ms", tolerance=0.5)], ["--tolerance", "0.01"]),
    ("tolerance-old-row", [_row("p99", 10.0, "ms", tolerance=0.5)], [_row("p99", 14.0, "ms")], []),
    ("tolerance-flag-beats-unit", [_row("p99", 10.0, "ms")], [_row("p99", 14.0, "ms")],
     ["--tolerance", "0.5"]),
    ("override-beats-row", [_row("p99", 10.0, "ms")],
     [_row("p99", 14.0, "ms", tolerance=0.5)], ["--set", "p99=0.01"]),
    ("vanished-and-new", [_row("gone", 1.0, "x"), _row("kept", 1.0, "x")],
     [_row("fresh", 2.0, "x"), _row("kept", 1.0, "x")], []),
    ("vanished-allowed", [_row("gone", 1.0, "x"), _row("kept", 1.0, "x")],
     [_row("kept", 1.0, "x")], ["--allow-missing"]),
    ("skipped", [_row("skip", None, "skipped", skipped=True), _row("a", 2.0, "ms")],
     [_row("skip", None, "skipped", skipped=True), _row("a", 2.0, "ms")], []),
    ("zero-baseline", [_row("z", 0.0, "ms"), _row("w", 0.0, "x")],
     [_row("z", 1.0, "ms"), _row("w", 0.0, "x")], []),
    ("json-report", [_row("p99", 10.0, "ms"), _row("rate", 100.0, "examples/sec")],
     [_row("p99", 14.0, "ms"), _row("rate", 80.0, "examples/sec")], ["--json"]),
]

# how the rounds are written: JSONL with log noise, a JSON array, a
# {"rows": [...]} document, and JSONL with a later duplicate of a row
FORMATS = ["jsonl", "array", "rows", "duplicates"]


def _write(path, rows, fmt):
    if fmt == "array":
        path.write_text(json.dumps(rows))
    elif fmt == "rows":
        path.write_text(json.dumps({"rows": rows}))
    else:
        lines = ["some log line"] + [json.dumps(r) for r in rows] + ["not json either"]
        if fmt == "duplicates":
            lines += [json.dumps(dict(r, value=-1.0)) for r in rows]
        path.write_text("\n".join(lines) + "\n")


def _run(main, argv, capsys):
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_bench_diff_answers_as_jax(tmp_path, capsys, case, fmt):
    _, old_rows, new_rows, extra = case
    old, new = tmp_path / "old.json", tmp_path / "new.json"
    _write(old, old_rows, fmt)
    _write(new, new_rows, fmt)
    argv = [str(old), str(new), *extra]
    want = _run(jdiff.main, argv, capsys)
    got = _run(tdiff.main, argv, capsys)
    assert got == want
    assert want[0] in (0, 1) and want[1]
    assert tdiff.load_rows(str(old)) == jdiff.load_rows(str(old))


def test_classify_and_diff_rows_as_jax():
    for unit in UNITS + ["weird_unit", "skipped"]:
        assert tdiff.classify(unit) == jdiff.classify(unit)
    old = {"p99": _row("p99", 10.0, "ms"), "rate": _row("rate", 100.0, "examples/sec")}
    new = {"p99": _row("p99", 10.5, "ms"), "rate": _row("rate", 80.0, "examples/sec")}
    for kw in ({}, {"tolerance": 0.5}, {"overrides": {"rate": 0.3}}):
        assert tdiff.diff_rows(old, new, **kw) == jdiff.diff_rows(old, new, **kw)


@pytest.mark.parametrize("what", ["missing-old", "empty-old", "bad-set"])
def test_usage_errors_as_jax(tmp_path, capsys, what):
    new = tmp_path / "new.jsonl"
    new.write_text(json.dumps(_row("p99", 1.0, "ms")) + "\n")
    empty = tmp_path / "empty.json"
    empty.write_text("")
    argv = {"missing-old": [str(tmp_path / "nope.json"), str(new)],
            "empty-old": [str(empty), str(new)],
            "bad-set": [str(new), str(new), "--set", "p99=fast"]}[what]
    got, want = [], []
    for main, into in ((jdiff.main, want), (tdiff.main, got)):
        try:
            into.append(main(argv))
        except SystemExit as e:  # argparse's error exit
            into.append(e.code)
        out, err = capsys.readouterr()
        into.append(out)
        # the error line (argparse wraps the usage above it by the
        # program's name, which differs)
        last = err.strip().splitlines()[-1]
        into.append(last.replace("keystone_tpu_torch bench-diff", "keystone_tpu bench-diff"))
    assert got == want and want[0] == 2
