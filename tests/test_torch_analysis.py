"""keystone-lint in the port (``keystone_tpu_torch/analysis/``) against
the JAX package's (``keystone_tpu/analysis/``): the same fixture snippets
give the same findings under both packages' rules; the port's rules also
fire on PyTorch's spellings of a host sync and of blocking device work
under a lock; and the port itself is lint-clean (the tier-1 gate)."""

import ast
import json
import os
import textwrap

import pytest

from keystone_tpu.analysis import cli as jcli
from keystone_tpu.analysis import core as jcore
from keystone_tpu.analysis import rules as jrules
from keystone_tpu_torch.analysis import cli as tcli
from keystone_tpu_torch.analysis import core as tcore
from keystone_tpu_torch.analysis import rules as trules

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOT_MODULES = {"hot/engine.py": {"gather_once"}}


def _rule(rules, name, **kw):
    return getattr(rules, name)(**kw)


def _keys(findings):
    return [(f.rule, f.path, f.line, f.col, f.message, f.index) for f in findings]


def _both(tmp_path, source, names, rel="pkg/mod.py", **kw):
    """Run the JAX package's rules and the port's (same names, same
    arguments) over ``source`` written at ``rel``: (jax, port) results."""
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    top = rel.split("/")[0]
    j = jcore.run_analysis(str(tmp_path), [top], [_rule(jrules, n, **kw) for n in names])
    t = tcore.run_analysis(str(tmp_path), [top], [_rule(trules, n, **kw) for n in names])
    return j, t


# -- the JAX package's fixture snippets, through both packages -------------

GUARDED_CLASS = """
import threading


class Pool:
    def __init__(self):
        self._lock = threading.Lock()
        self._ring = []  # guarded-by: _lock
        self._free = {{}}  # guarded-by: _lock

    def mutate(self):
        {body}
"""

LOCKED_BODY = """
import threading
import time


class Pool:
    def __init__(self):
        self._lock = threading.Lock()

    def run(self, fut, engine, thread):
        {body}
"""

HOST_SYNC = "import numpy as np\n\n\ndef deliver(x, futs):\n    {body}\n"

# (id, rule class, file, source, findings the JAX package's tests expect)
CASES = [
    *[(f"guarded-fires-{i}", "GuardedByRule", "pkg/mod.py", GUARDED_CLASS.format(body=b), 1)
      for i, b in enumerate([
          "self._ring = []", "self._ring += [1]", "self._free['k'] = 1",
          "self._ring.append(1)", "self._free.setdefault('k', []).append(1)",
          "del self._free['k']"])],
    *[(f"guarded-quiet-{i}", "GuardedByRule", "pkg/mod.py", GUARDED_CLASS.format(body=b), 0)
      for i, b in enumerate([
          "with self._lock:\n            self._ring = []",
          "with self._lock:\n            self._ring.append(1)",
          "x = self._ring", "n = len(self._free)", "x = self._free.get('k')"])],
    ("guarded-exempt", "GuardedByRule", "pkg/mod.py", """
    import threading


    class Pool:
        def __init__(self):
            self._lock = threading.Lock()
            self._ring = []  # guarded-by: _lock
            self._ring = [1]  # re-init is still construction

        def _drop_locked(self):
            self._ring = []
    """, 0),
    ("guarded-cross-object", "GuardedByRule", "pkg/mod.py", """
    import threading


    class Tracer:
        def __init__(self):
            self._lock = threading.Lock()
            self._ring = []  # guarded-by: _lock


    _global = Tracer()


    def resize_bad(n):
        _global._ring = [None] * n


    def resize_good(n):
        with _global._lock:
            _global._ring = [None] * n
    """, 1),
    *[(f"blocking-fires-{i}", "BlockingUnderLockRule", "pkg/mod.py",
       LOCKED_BODY.format(body=b), 1)
      for i, b in enumerate([
          "with self._lock:\n            time.sleep(1.0)",
          "with self._lock:\n            fut.result()",
          "with self._lock:\n            engine.warmup(example=1)",
          "with self._lock:\n            thread.join()",
          "with self._lock:\n            engines = self.build_replacements(None)"])],
    *[(f"blocking-quiet-{i}", "BlockingUnderLockRule", "pkg/mod.py",
       LOCKED_BODY.format(body=b), 0)
      for i, b in enumerate([
          "engines = self.build_replacements(None)\n        with self._lock:\n"
          "            self.e = engines",
          "time.sleep(1.0)",
          "with self._lock:\n            x = ', '.join(['a'])",
          "with self._lock:\n            self._lock.wait(0.05)"])],
    ("blocking-with-header", "BlockingUnderLockRule", "pkg/m.py",
     "import threading\n\n\nclass P:\n    def __init__(self):\n"
     "        self._lock = threading.Lock()\n\n    def bad(self, fut):\n"
     "        with self._lock, fut.result():\n            pass\n", 1),
    ("assert-fires", "StrippableAssertRule", "keystone_tpu/serving/bench.py",
     "def gate(ok):\n    assert ok, 'enforced'\n", 1),
    ("assert-quiet-tests", "StrippableAssertRule", "tests/serving/test_x.py",
     "def test_x():\n    assert 1 == 1\n", 0),
    ("assert-quiet-raise", "StrippableAssertRule", "keystone_tpu/serving/bench.py",
     "def gate(ok):\n    if not ok:\n        raise AssertionError('enforced')\n", 0),
    ("absent-preregistered", "AbsentNotZeroRule", "pkg/mod.py", """
    class Metrics:
        def __init__(self, registry):
            self._mfu = registry.gauge(
                "keystone_serving_mfu", "rolling MFU"
            )
    """, 1),
    ("absent-labeled-or-lazy", "AbsentNotZeroRule", "pkg/mod.py", """
    class Metrics:
        def __init__(self, registry):
            self._mem = registry.gauge(
                "keystone_device_memory_bytes", "hbm",
                ("device", "kind", "stat"),
            )

        def on_available(self, registry):
            self._mfu = registry.gauge("keystone_serving_mfu", "mfu")
    """, 0),
    ("absent-zero-stamp", "AbsentNotZeroRule", "pkg/mod.py",
     "def degrade(self):\n    self.mfu_gauge.set(0)\n", 1),
    ("absent-real-zero", "AbsentNotZeroRule", "pkg/mod.py",
     "def on_swap(self):\n    old.metrics.set_staging_bytes(0)\n", 0),
    ("absent-none-fallback", "AbsentNotZeroRule", "pkg/mod.py", """
    def families(m, mfu):
        return MetricFamily(
            "keystone_serving_mfu", "gauge", "mfu",
            [Sample("", {}, mfu if mfu is not None else 0.0)],
        )
    """, 1),
    ("absent-inverted-fallback", "AbsentNotZeroRule", "pkg/mod.py", """
    def families(m, mfu):
        return MetricFamily(
            "keystone_serving_mfu", "gauge", "mfu",
            [Sample("", {}, 0.0 if mfu is None else mfu)],
        )
    """, 1),
    ("absent-one-hot", "AbsentNotZeroRule", "pkg/mod.py", """
    def families(m, r):
        return MetricFamily(
            "keystone_device_roofline_bound", "gauge", "side",
            [Sample("", {}, 1.0 if "compute" == r else 0.0)],
        )
    """, 0),
    *[(f"host-sync-fires-{i}", "HotPathHostSyncRule", "hot/engine.py",
       HOST_SYNC.format(body=b), 1)
      for i, b in enumerate([
          "y = float(x)", "y = x.item()", "y = np.asarray(x)",
          "for i, f in enumerate(futs):\n        f.set_result(x[i])"])],
    ("host-sync-allowlisted", "HotPathHostSyncRule", "hot/engine.py",
     "import numpy as np\n\n\ndef gather_once(x, futs):\n    host = np.asarray(x)\n"
     "    for i, f in enumerate(futs):\n        f.set_result(host[i])\n", 0),
    ("host-sync-cold-module", "HotPathHostSyncRule", "cold/util.py",
     "import numpy as np\n\n\ndef deliver(x, futs):\n    host = np.asarray(x)\n", 0),
    ("host-sync-literal-and-dict", "HotPathHostSyncRule", "hot/engine.py",
     "def warm(self, want):\n    x = float('nan')\n    for b in want:\n"
     "        self._aot[b] = {}\n        r = self._aot[b]\n", 0),
    # the suppression and baseline snippets of the JAX package's tests
    ("suppress-trailing", "StrippableAssertRule", "pkg/m.py",
     "def gate(ok):\n    assert ok  # lint: disable=strippable-assert\n    assert ok\n", 1),
    ("suppress-standalone", "StrippableAssertRule", "pkg/mod.py",
     "def gate(ok):\n    # lint: disable=strippable-assert\n    assert ok\n", 0),
    ("suppress-not-in-string", "StrippableAssertRule", "pkg/mod.py",
     'def gate(ok):\n    assert ok, "see docs: # lint: disable=strippable-assert"\n', 1),
    ("suppress-skips-justification", "StrippableAssertRule", "pkg/mod.py",
     "def gate(ok):\n    # lint: disable=strippable-assert\n"
     "    # justification: exercised only in the debug REPL\n    assert ok\n", 0),
    ("suppress-wrapped", "StrippableAssertRule", "pkg/mod.py",
     "def gate(ok, msg):\n    assert (\n        ok\n    ), msg  # lint: disable=strippable-assert\n", 0),
    ("suppress-per-rule", "StrippableAssertRule", "pkg/mod.py",
     "def gate(ok):\n    assert ok  # lint: disable=guarded-by\n", 1),
    ("baseline-duplicates", "StrippableAssertRule", "pkg/mod.py",
     "def gate(ok):\n    assert ok\n\n\ndef gate2(ok):\n    assert ok\n", 2),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_port_rules_give_jax_findings_on_its_fixtures(tmp_path, case):
    _, name, rel, source, want = case
    kw = {"modules": HOT_MODULES} if name == "HotPathHostSyncRule" else {}
    j, t = _both(tmp_path, source, [name], rel=rel, **kw)
    assert len(j.findings) == want, j.findings
    assert _keys(t.findings) == _keys(j.findings)
    assert t.suppressed == j.suppressed


def test_parse_error_and_baseline_mechanics_as_in_jax(tmp_path):
    j, t = _both(tmp_path, "def broken(:\n", [r.__name__ for r in jrules.ALL_RULES])
    assert [f.rule for f in t.findings] == ["parse-error"] == [f.rule for f in j.findings]
    # round trip, then stale once the offending line is fixed, and a new
    # assert on the same line number is not covered (text identity)
    (tmp_path / "pkg" / "mod.py").write_text("def gate(ok):\n    assert ok\n")
    first = tcore.run_analysis(str(tmp_path), ["pkg"], [trules.StrippableAssertRule()])
    path = tmp_path / "baseline.json"
    tcore.Baseline.from_findings(first.findings, justification="grandfathered").save(str(path))
    loaded = tcore.Baseline.load(str(path))
    assert first.unbaselined(loaded) == [] and loaded.stale_entries(first.findings) == []
    (tmp_path / "pkg" / "mod.py").write_text("def gate(ok):\n    return bool(ok)\n")
    fixed = tcore.run_analysis(str(tmp_path), ["pkg"], [trules.StrippableAssertRule()])
    assert len(loaded.stale_entries(fixed.findings)) == 1
    (tmp_path / "pkg" / "mod.py").write_text("def gate(ok):\n    assert ok != 1\n")
    changed = tcore.run_analysis(str(tmp_path), ["pkg"], [trules.StrippableAssertRule()])
    assert len(changed.unbaselined(loaded)) == 1


# -- the cross-file rules, through both packages ---------------------------

# the two messages that name the scope they searched: the JAX package's
# name its own package and all of tests/, the port's its own package and
# its own tests
PORT_WORDING = (
    ("in keystone_tpu/ —", "in pkg/ —"),
    ("nowhere under tests/ —", "nowhere under tests/test_torch_*.py —"),
)


def _port_wording(keys):
    out = []
    for rule, path, line, col, message, index in keys:
        for jax_words, port_words in PORT_WORDING:
            message = message.replace(jax_words, port_words)
        out.append((rule, path, line, col, message, index))
    return out


def drift_project(tmp_path, catalog=("a.point", "b.point"), wired=("a.point", "b.point"),
                  readme=("a.point", "b.point"), tested=("a.point", "b.point"),
                  test_file="test_torch_chaos.py"):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    entries = ",\n".join(f'    "{p}": "doc"' for p in catalog)
    (pkg / "faults.py").write_text("FAULT_POINTS = {\n" + entries + ",\n}\n")
    calls = "\n".join(f'    fire("{p}", None)' for p in wired) or "    pass"
    (pkg / "hot.py").write_text(
        "from pkg.faults import FAULT_POINTS\n\n\n"
        "def fire(p, ctx):\n    return None\n\n\n"
        "def serve():\n" + calls + "\n"
    )
    rows = "\n".join(f"| `{p}` | effect |" for p in readme)
    (tmp_path / "README.md").write_text(
        "# demo\n\n**Fault-point catalog** table:\n\n"
        "| point | effect |\n|---|---|\n" + rows + "\n\n## Next\n"
    )
    tests = tmp_path / "tests"
    tests.mkdir()
    body = "\n".join(f'    arm("{p}")' for p in tested) or "    pass"
    (tests / test_file).write_text("def test_points():\n" + body + "\n")
    return dict(faults_rel="pkg/faults.py", readme_rel="README.md", tests_rel="tests",
                package_rel="pkg")


def family_project(tmp_path, registered=("keystone_demo_hits_total", "keystone_demo_depth"),
                   fstring_field=None,
                   readme=("keystone_demo_hits_total", "keystone_demo_depth"), with_table=True):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    lines = ["reg = object()\n\n\ndef wire(reg):"]
    for fam in registered:
        lines.append(f'    reg.counter("{fam}", "help")')
    if fstring_field:
        lines.append(f'    reg.gauge(f"keystone_demo_{{{fstring_field}}}_total", "help")')
    if len(lines) == 1:
        lines.append("    pass")
    (pkg / "metrics.py").write_text("\n".join(lines) + "\n")
    if with_table:
        rows = "\n".join(f"| `{f}` | counter | doc |" for f in readme)
        (tmp_path / "README.md").write_text(
            "# demo\n\n**Metric-family catalog** — every exported "
            "family:\n\n| family | kind | meaning |\n|---|---|---|\n" + rows + "\n\n## Next\n"
        )
    else:
        (tmp_path / "README.md").write_text("# demo\n\nno table here\n")
    return dict(readme_rel="README.md", package_rel="pkg")


PROJECT_CASES = [
    ("drift-agree", "FaultPointDriftRule", drift_project, {}, ("pkg",), 0),
    ("drift-readme-missing", "FaultPointDriftRule", drift_project,
     dict(readme=("a.point",)), ("pkg",), 1),
    ("drift-readme-phantom", "FaultPointDriftRule", drift_project,
     dict(readme=("a.point", "b.point", "ghost.point")), ("pkg",), 1),
    ("drift-unwired", "FaultPointDriftRule", drift_project, dict(wired=("a.point",)),
     ("pkg",), 1),
    ("drift-untested", "FaultPointDriftRule", drift_project, dict(tested=("a.point",)),
     ("pkg",), 1),
    ("drift-uncataloged", "FaultPointDriftRule", drift_project,
     dict(wired=("a.point", "b.point", "rogue.point")), ("pkg",), 1),
    ("drift-file-slice", "FaultPointDriftRule", drift_project, {}, ("pkg/faults.py",), 0),
    ("family-agree", "MetricFamilyDriftRule", family_project, {}, ("pkg",), 0),
    ("family-undocumented", "MetricFamilyDriftRule", family_project,
     dict(readme=("keystone_demo_depth",)), ("pkg",), 1),
    ("family-phantom", "MetricFamilyDriftRule", family_project,
     dict(readme=("keystone_demo_hits_total", "keystone_demo_depth", "keystone_demo_ghost")),
     ("pkg",), 1),
    ("family-no-table", "MetricFamilyDriftRule", family_project, dict(with_table=False),
     ("pkg",), 1),
    ("family-fstring-matches", "MetricFamilyDriftRule", family_project,
     dict(registered=(), fstring_field="field",
          readme=("keystone_demo_device_seconds_total", "keystone_demo_h2d_bytes_total")),
     ("pkg",), 0),
    ("family-fstring-unmatched", "MetricFamilyDriftRule", family_project,
     dict(registered=(), fstring_field="field", readme=()), ("pkg",), 1),
    ("family-file-slice", "MetricFamilyDriftRule", family_project, {}, ("pkg/other.py",), 0),
]


@pytest.mark.parametrize("case", PROJECT_CASES, ids=[c[0] for c in PROJECT_CASES])
def test_port_drift_rules_give_jax_findings_on_its_fixtures(tmp_path, case):
    _, name, build, overrides, paths, want = case
    kw = build(tmp_path, **overrides)
    (tmp_path / "pkg" / "other.py").write_text("x = 1\n")
    j = jcore.run_analysis(str(tmp_path), list(paths), [_rule(jrules, name, **kw)])
    t = tcore.run_analysis(str(tmp_path), list(paths), [_rule(trules, name, **kw)])
    assert len(j.findings) == want, j.findings
    assert _keys(t.findings) == _port_wording(_keys(j.findings))


def test_fault_points_must_be_exercised_in_the_ports_own_tests(tmp_path):
    """A point that only a test outside ``tests/test_torch_*.py`` names
    is untested for the port; the JAX package's rule reads all tests/."""
    kw = drift_project(tmp_path, test_file="test_chaos.py")
    j = jcore.run_analysis(str(tmp_path), ["pkg"], [jrules.FaultPointDriftRule(**kw)])
    t = tcore.run_analysis(str(tmp_path), ["pkg"], [trules.FaultPointDriftRule(**kw)])
    assert j.findings == []
    assert sorted(f.message.split("`")[1] for f in t.findings) == ["a.point", "b.point"]
    assert all("nowhere under tests/test_torch_*.py" in f.message for f in t.findings)


# -- PyTorch's spellings ---------------------------------------------------


@pytest.mark.parametrize("body", [
    "y = x.cpu()",
    "y = x.detach().cpu().numpy()",
    "y = x.numpy()",
    "y = x.tolist()",
    "torch.cuda.synchronize()",
    "stream.synchronize()",
    "ready.synchronize()",
])
def test_host_sync_fires_on_torch_spellings(tmp_path, body):
    src = f"import torch\n\n\ndef deliver(x, stream, ready):\n    {body}\n"
    j, t = _both(tmp_path, src, ["HotPathHostSyncRule"], rel="hot/engine.py",
                 modules=HOT_MODULES)
    assert j.findings == []  # the JAX package's rule knows none of them
    assert len(t.findings) >= 1 and {f.rule for f in t.findings} == {"hot-path-host-sync"}
    assert t.findings[0].line == 5


def test_host_sync_torch_spellings_quiet_at_an_allowlisted_point(tmp_path):
    src = ("import torch\n\n\ndef gather_once(x, futs, stream):\n"
           "    stream.synchronize()\n    host = x.detach().cpu().numpy()\n"
           "    rows = x.tolist()\n    torch.cuda.synchronize()\n"
           "    for i, f in enumerate(futs):\n        f.set_result(host[i])\n")
    _, t = _both(tmp_path, src, ["HotPathHostSyncRule"], rel="hot/engine.py",
                 modules=HOT_MODULES)
    assert t.findings == []


LOCK_CASES = [
    ("with self._lock:\n            self._stream.synchronize()", 1),
    ("with self._lock:\n            torch.cuda.synchronize()", 1),
    ("with self._lock:\n            ready.synchronize()", 1),
    ("with self._lock:\n            with torch.cuda.graph(g, stream=s):\n"
     "                out = fn(x)", 1),
    ("with self._lock, torch.cuda.graph(g):\n            out = fn(x)", 1),
    ("with self._fn_lock:\n            self._graphs[k] = self._capture(b, x)", 1),
    # outside a lock, and the lock only around the re-point: quiet
    ("g = self._capture(b, x)\n        with self._lock:\n            self._graphs[k] = g", 0),
    ("with torch.cuda.graph(g):\n            out = fn(x)\n        self._stream.synchronize()", 0),
]


@pytest.mark.parametrize("body,want", LOCK_CASES)
def test_blocking_under_lock_fires_on_syncs_and_captures(tmp_path, body, want):
    src = ("import threading\nimport torch\n\n\nclass Engine:\n    def __init__(self):\n"
           "        self._lock = threading.Lock()\n        self._fn_lock = threading.Lock()\n\n"
           f"    def run(self, g, s, fn, x, b, k, ready):\n        {body}\n")
    _, t = _both(tmp_path, src, ["BlockingUnderLockRule"])
    assert len(t.findings) == want, t.findings
    assert all(f.rule == "blocking-under-lock" for f in t.findings)


def _qualnames(path):
    """Every class and function qualname defined in a module."""
    names = set()

    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                names.add(q)
                walk(child, q + ".")

    walk(ast.parse(open(path).read()), "")
    return names


def test_hot_path_modules_and_defaults_name_the_port():
    """The port's rules default to its own package, and every allowlisted
    gather or wait point names a function that exists (a renamed one
    would silently allow nothing, or leave a real sync unlisted)."""
    assert set(trules.HOT_PATH_MODULES) == {
        "keystone_tpu_torch/serving/engine.py", "keystone_tpu_torch/serving/pipeline.py",
        "keystone_tpu_torch/gateway/pool.py"}
    for rel, allowed in trules.HOT_PATH_MODULES.items():
        defined = _qualnames(os.path.join(ROOT, rel))
        assert allowed <= defined, (rel, sorted(allowed - defined))
    fp = trules.FaultPointDriftRule()
    assert (fp.faults_rel, fp.package_rel, fp.TESTS_GLOB) == (
        "keystone_tpu_torch/loadgen/faults.py", "keystone_tpu_torch", "test_torch_*.py")
    assert trules.MetricFamilyDriftRule().package_rel == "keystone_tpu_torch"
    assert tcli.DEFAULT_PATHS == ("keystone_tpu_torch",)
    assert tcli.DEFAULT_BASELINE == "keystone_tpu_torch/analysis/LINT_BASELINE.json"
    assert [c.name for c in trules.ALL_RULES] == [c.name for c in jrules.ALL_RULES]


def test_the_lint_sees_the_engines_blocking_work_and_each_has_its_reason():
    """The port's rules, before suppressions, see the engine's graph
    capture under ``_fn_lock`` and its stream waits under
    ``_replay_lock``; each is suppressed on its line with a reason."""
    rel = "keystone_tpu_torch/serving/engine.py"
    ctx = tcore.FileContext(os.path.join(ROOT, rel), rel, open(os.path.join(ROOT, rel)).read())
    raw = list(trules.BlockingUnderLockRule().check_file(ctx))
    calls = sorted(f.line_text for f in raw)
    assert calls == ["g = self._graphs[key] = self._capture(bucket, staged)",
                     "self._compute_stream.synchronize()",
                     "self._compute_stream.synchronize()"], calls
    for f in raw:
        assert ctx.suppressed(f.rule, f.line), f.render()
        # the reason: a comment line between the suppression and the code
        assert ctx.lines[f.line - 2].strip().startswith("#")
        assert "disable" not in ctx.lines[f.line - 2]


# -- the gate: the port is lint-clean --------------------------------------


def test_keystone_tpu_torch_is_lint_clean():
    result = tcore.run_analysis(ROOT, ["keystone_tpu_torch"], trules.default_rules())
    baseline = tcore.Baseline.load(os.path.join(ROOT, tcli.DEFAULT_BASELINE))
    live = result.unbaselined(baseline)
    assert live == [], "\n".join(f.render() for f in live)
    assert baseline.stale_entries(result.findings) == []
    unjustified = [e for e in baseline.entries
                   if not str(e.get("justification", "")).strip()
                   or str(e.get("justification", "")).startswith("TODO")]
    assert unjustified == []


def test_cli_gate_matches_library_verdict(capsys):
    rc = tcli.main(["--root", ROOT, "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0, doc["findings"]
    assert doc["clean"] is True and doc["files"] > 100
    assert doc["rules"] == [c.name for c in trules.ALL_RULES]


# -- the CLI's contract, as the JAX package's ------------------------------

CLEAN = "def add(a, b):\n    return a + b\n"
DIRTY = "def gate(ok):\n    assert ok\n"

# (id, the package's files, argv after --root, further steps)
CLI_CASES = [
    ("clean", {"mod.py": CLEAN}, [], []),
    ("findings", {"mod.py": DIRTY}, [], []),
    ("json", {"mod.py": DIRTY}, ["--json"], []),
    ("json-files", {"mod.py": CLEAN, "second.py": CLEAN}, ["--json"], []),
    ("write-baseline-then-clean", {"mod.py": DIRTY}, ["--write-baseline"], [[]]),
    ("stale-baseline", {"mod.py": DIRTY}, ["--write-baseline"], [["@fix"]]),
    ("unknown-option", {"mod.py": CLEAN}, ["--frobnicate"], []),
    ("explicit-clean-path", {"mod.py": DIRTY, "clean.py": CLEAN}, ["@pkg/clean.py"], []),
    ("explicit-dirty-path", {"mod.py": DIRTY, "clean.py": CLEAN}, ["@pkg/mod.py"], []),
    ("no-such-path", {"mod.py": DIRTY}, ["@pkg/engin.py"], []),
    ("changed-only-and-paths", {"mod.py": CLEAN}, ["--changed-only", "@pkg"], []),
    ("write-baseline-slice", {"mod.py": DIRTY}, ["--write-baseline", "@pkg/mod.py"], []),
    ("write-baseline-changed", {"mod.py": DIRTY}, ["--write-baseline", "--changed-only"], []),
    ("changed-only-no-git", {"mod.py": DIRTY}, ["--changed-only"], []),
    ("bad-baseline", {"mod.py": CLEAN, "@baseline": '{"nope": true}'}, [], []),
]


def _cli_run(main, root, pkg, argv, capsys):
    argv = [a.replace("@pkg", pkg).lstrip("@") for a in argv]
    rc = main(["--root", str(root)] + argv)
    out, err = capsys.readouterr()
    text = (out + err).replace(str(root), "ROOT").replace(pkg, "PKG")
    if "--json" in argv:
        doc = json.loads(out)
        doc["root"] = "ROOT"
        text = json.dumps(doc, sort_keys=True).replace(pkg, "PKG")
    return rc, text


@pytest.mark.parametrize("case", CLI_CASES, ids=[c[0] for c in CLI_CASES])
def test_cli_answers_as_the_jax_cli(tmp_path, capsys, case):
    _, files, argv, steps = case
    seen = {}
    for main, pkg in ((jcli.main, "keystone_tpu"), (tcli.main, "keystone_tpu_torch")):
        root = tmp_path / pkg.replace("_", "-")
        (root / pkg).mkdir(parents=True)
        for name, src in files.items():
            if name == "@baseline":
                path = root / (tcli if pkg == "keystone_tpu_torch" else jcli).DEFAULT_BASELINE
                path.parent.mkdir(parents=True, exist_ok=True)
                path.write_text(src)
            else:
                (root / pkg / name).write_text(src)
        runs = [_cli_run(main, root, pkg, argv, capsys)]
        for step in steps:
            if step == ["@fix"]:
                (root / pkg / "mod.py").write_text(CLEAN)
                step = []
            runs.append(_cli_run(main, root, pkg, step, capsys))
        seen[pkg] = runs
    # the JAX CLI keeps its baseline at the root, the port's in its package
    want = [(rc, text.replace("ROOT/LINT_BASELINE.json",
                              "ROOT/PKG/analysis/LINT_BASELINE.json"))
            for rc, text in seen["keystone_tpu"]]
    assert seen["keystone_tpu_torch"] == want
    if case[0].startswith("write-baseline-then"):
        assert (tmp_path / "keystone-tpu-torch" / "keystone_tpu_torch" / "analysis"
                / "LINT_BASELINE.json").exists()


@pytest.mark.parametrize("argv", [["--baseline"], ["--root"], ["--list-rules"]])
def test_cli_dangling_options_and_rule_list_as_in_jax(argv, capsys):
    assert tcli.main(argv) == jcli.main(argv)
    out = capsys.readouterr().out
    for cls in trules.ALL_RULES:
        assert (cls.name in out) == (argv == ["--list-rules"])
