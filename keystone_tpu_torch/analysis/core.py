"""Rule framework: file contexts, shared class/lock/scope resolution,
inline suppressions, the baseline store, and the analysis runner.

The division of labor mirrors the workflow optimizer it is modeled on
(``workflow/rules.py``: one ``Rule.apply`` per rewrite over a shared
``Graph`` IR): here the IR is a ``FileContext`` — parsed ``ast`` plus
the comment-derived side tables ``ast`` drops (``# lint:
disable=<rule>`` suppressions, ``# guarded-by: <lock>`` annotations) —
and every rule is a visitor over it. Cross-file rules (the fault-point
catalog drift check) run once over the whole ``Project`` after the
per-file pass.

Baseline discipline: a finding's identity is ``(path, rule, stripped
source line text, occurrence index)`` — NOT the line number, so
grandfathered findings survive unrelated edits above them and go stale
the moment the offending line itself changes (stale entries are
reported so the baseline shrinks monotonically instead of rotting).
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

# trailing or standalone suppression: `# lint: disable=rule[,rule]`.
# A standalone comment line suppresses the next code line (and itself);
# a trailing comment suppresses its own line.
_SUPPRESS_RE = re.compile(r"#\s*lint:\s*disable=([\w.,\-\s]+)")

# `self._attr = ... # guarded-by: _lock` — the annotation rule (1)
# reads; associated with the attribute assigned on the same line
_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)")

# with-items that count as taking a lock: `with self._lock:`,
# `with self._cond:`, `with _global_lock:` — a Name/Attribute whose
# terminal name contains lock/cond/mutex (or is a known lock attribute
# of the enclosing class, resolved by the rule)
_LOCKY_NAME_RE = re.compile(r"(lock|cond|mutex)", re.IGNORECASE)

# constructors that make an attribute a lock for class resolution
_LOCK_CTORS = {
    "threading.Lock",
    "threading.RLock",
    "threading.Condition",
    "Lock",
    "RLock",
    "Condition",
}


@dataclasses.dataclass
class Finding:
    """One rule violation, anchored to a source line."""

    rule: str
    path: str  # project-root-relative, forward slashes
    line: int
    col: int
    message: str
    line_text: str = ""  # stripped source of the line (baseline key)
    index: int = 0  # nth finding sharing (path, rule, line_text)
    # last physical line of the flagged node: a trailing suppression
    # on any line of a wrapped multi-line statement must still count
    # (not serialized — anchoring and baseline keys stay on `line`)
    end_line: int = 0

    def key(self) -> Tuple[str, str, str, int]:
        return (self.path, self.rule, self.line_text, self.index)

    def to_dict(self) -> Dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "line_text": self.line_text,
            "index": self.index,
        }

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: "
            f"{self.rule}: {self.message}"
        )


@dataclasses.dataclass
class ClassInfo:
    """Shared per-class resolution every lock rule reads."""

    name: str
    locks: Set[str] = dataclasses.field(default_factory=set)
    # attribute -> lock name it is annotated `# guarded-by:` with
    guarded: Dict[str, str] = dataclasses.field(default_factory=dict)


class FileContext:
    """One parsed file plus the comment side tables ``ast`` drops."""

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        # line -> set of rule names suppressed there ("*" = all)
        self.suppressions: Dict[int, Set[str]] = {}
        # line -> guarded-by lock name on that line's comment
        self.guarded_comments: Dict[int, str] = {}
        self._scan_comments()
        self.classes: Dict[str, ClassInfo] = {}
        # attr -> (class name, lock) when the attr is annotated in
        # exactly ONE class of this module — lets rule (1) check writes
        # through a non-self base (`_global_tracer._ring = ...`)
        self.unique_guarded: Dict[str, Tuple[str, str]] = {}
        self._resolve_classes()

    # -- comment side tables ------------------------------------------------

    def _scan_comments(self) -> None:
        # real COMMENT tokens only (tokenize): a string literal that
        # happens to contain "# lint: disable=..." must not become an
        # unreviewable escape hatch
        try:
            comments = [
                (tok.start[0], tok.string)
                for tok in tokenize.generate_tokens(
                    io.StringIO(self.source).readline
                )
                if tok.type == tokenize.COMMENT
            ]
        except (tokenize.TokenError, IndentationError, SyntaxError):
            # ast parsed it, tokenize didn't (pathological): no
            # comments rather than string-confused ones
            comments = []
        for i, text in comments:
            m = _SUPPRESS_RE.search(text)
            if m:
                rules = {
                    r.strip() for r in m.group(1).split(",") if r.strip()
                }
                target = i
                if self.lines[i - 1].lstrip().startswith("#"):
                    # standalone comment: suppress the next CODE line,
                    # skipping blanks and further comment lines (a
                    # justification comment may sit between the
                    # suppression and the code it covers)
                    j = i + 1
                    while j <= len(self.lines) and (
                        not self.lines[j - 1].strip()
                        or self.lines[j - 1].lstrip().startswith("#")
                    ):
                        j += 1
                    target = j
                    self.suppressions.setdefault(i, set()).update(rules)
                self.suppressions.setdefault(target, set()).update(rules)
            g = _GUARDED_RE.search(text)
            if g:
                self.guarded_comments[i] = g.group(1)

    def suppressed(self, rule: str, line: int) -> bool:
        rules = self.suppressions.get(line)
        return bool(rules) and (rule in rules or "*" in rules)

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    # -- class / lock resolution --------------------------------------------

    def _resolve_classes(self) -> None:
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            info = ClassInfo(name=node.name)
            for sub in ast.walk(node):
                if not isinstance(sub, (ast.Assign, ast.AnnAssign)):
                    continue
                targets = (
                    sub.targets
                    if isinstance(sub, ast.Assign)
                    else [sub.target]
                )
                for t in targets:
                    attr = _self_attr(t)
                    if attr is None:
                        continue
                    value = sub.value
                    if value is not None and _is_lock_ctor(value):
                        info.locks.add(attr)
                    # the annotation may trail any line of a
                    # multi-line assignment (black-wrapped inits)
                    end = getattr(sub, "end_lineno", None) or sub.lineno
                    for ln in range(sub.lineno, end + 1):
                        lock = self.guarded_comments.get(ln)
                        if lock is not None:
                            info.guarded[attr] = lock
                            break
            self.classes[node.name] = info
        seen: Dict[str, List[Tuple[str, str]]] = {}
        for cname, info in self.classes.items():
            for attr, lock in info.guarded.items():
                seen.setdefault(attr, []).append((cname, lock))
        self.unique_guarded = {
            attr: owners[0]
            for attr, owners in seen.items()
            if len(owners) == 1
        }


def _self_attr(node: ast.AST) -> Optional[str]:
    """``self.X`` target -> ``"X"``; anything else -> None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _is_lock_ctor(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    try:
        fn = ast.unparse(node.func)
    except Exception:
        return False
    return fn in _LOCK_CTORS


def lock_expr_name(node: ast.AST, class_locks: Set[str]) -> Optional[str]:
    """If a ``with`` context expression looks like taking a lock,
    return its normalized source text (``self._lock``); else None.
    A Name/Attribute counts when its terminal name matches
    lock/cond/mutex or is a known lock attribute of the class."""
    expr = node
    # `with self._lock.acquire_timeout(...)` style: not supported —
    # only plain Name/Attribute context managers are lock-shaped
    if not isinstance(expr, (ast.Name, ast.Attribute)):
        return None
    terminal = expr.id if isinstance(expr, ast.Name) else expr.attr
    if _LOCKY_NAME_RE.search(terminal) or terminal in class_locks:
        try:
            return ast.unparse(expr)
        except Exception:
            return None
    return None


@dataclasses.dataclass
class Scope:
    """Lexical position during a scoped walk."""

    class_stack: List[str] = dataclasses.field(default_factory=list)
    func_stack: List[str] = dataclasses.field(default_factory=list)
    # normalized source text of every enclosing with-lock item
    lock_stack: List[str] = dataclasses.field(default_factory=list)
    # Name -> True for names bound as for-loop targets in scope
    loop_vars: Set[str] = dataclasses.field(default_factory=set)

    @property
    def cls(self) -> Optional[str]:
        return self.class_stack[-1] if self.class_stack else None

    @property
    def func(self) -> Optional[str]:
        return self.func_stack[-1] if self.func_stack else None

    def qualname(self) -> str:
        return ".".join(self.class_stack + self.func_stack)


class Rule:
    """One checked invariant. Subclasses set ``name``/``description``
    and override ``check_file`` (per-file) or ``check_project``
    (cross-file, runs once after every file parsed)."""

    name: str = "rule"
    description: str = ""

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        return ()

    def check_project(self, project: "Project") -> Iterable[Finding]:
        return ()


class ScopedRule(Rule):
    """Base for rules that need class/function/lock scope: drives one
    recursive walk per file and calls ``on_node`` with the live
    ``Scope`` at every node."""

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        scope = Scope()
        self._walk(ctx.tree, ctx, scope, findings)
        return findings

    def on_node(
        self,
        node: ast.AST,
        ctx: FileContext,
        scope: Scope,
        findings: List[Finding],
    ) -> None:
        raise NotImplementedError

    def _class_locks(self, ctx: FileContext, scope: Scope) -> Set[str]:
        info = ctx.classes.get(scope.cls) if scope.cls else None
        return info.locks if info else set()

    def _walk(
        self,
        node: ast.AST,
        ctx: FileContext,
        scope: Scope,
        findings: List[Finding],
    ) -> None:
        if isinstance(node, ast.ClassDef):
            scope.class_stack.append(node.name)
            for child in ast.iter_child_nodes(node):
                self._walk(child, ctx, scope, findings)
            scope.class_stack.pop()
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scope.func_stack.append(node.name)
            for child in ast.iter_child_nodes(node):
                self._walk(child, ctx, scope, findings)
            scope.func_stack.pop()
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            # items evaluate left-to-right with earlier locks already
            # held: `with self._lock, fut.result():` blocks under the
            # lock, so each item's expression is walked BEFORE later
            # items push — and after its own push, matching runtime
            pushed = 0
            for item in node.items:
                self._walk(item.context_expr, ctx, scope, findings)
                if item.optional_vars is not None:
                    self._walk(
                        item.optional_vars, ctx, scope, findings
                    )
                name = lock_expr_name(
                    item.context_expr, self._class_locks(ctx, scope)
                )
                if name is not None:
                    scope.lock_stack.append(name)
                    pushed += 1
            self.on_node(node, ctx, scope, findings)
            for child in node.body:
                self._walk(child, ctx, scope, findings)
            for _ in range(pushed):
                scope.lock_stack.pop()
            return
        if isinstance(
            node,
            (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp),
        ):
            added = []
            for gen in node.generators:
                for t in ast.walk(gen.target):
                    if (
                        isinstance(t, ast.Name)
                        and t.id not in scope.loop_vars
                    ):
                        scope.loop_vars.add(t.id)
                        added.append(t.id)
            self.on_node(node, ctx, scope, findings)
            for child in ast.iter_child_nodes(node):
                self._walk(child, ctx, scope, findings)
            for name in added:
                scope.loop_vars.discard(name)
            return
        if isinstance(node, (ast.For, ast.AsyncFor)):
            added = []
            for t in ast.walk(node.target):
                if isinstance(t, ast.Name) and t.id not in scope.loop_vars:
                    scope.loop_vars.add(t.id)
                    added.append(t.id)
            self.on_node(node, ctx, scope, findings)
            for child in ast.iter_child_nodes(node):
                if child is not node.target:
                    self._walk(child, ctx, scope, findings)
            for name in added:
                scope.loop_vars.discard(name)
            return
        self.on_node(node, ctx, scope, findings)
        for child in ast.iter_child_nodes(node):
            self._walk(child, ctx, scope, findings)


class Project:
    """The file set one analysis run covers, plus the root the
    cross-file rules resolve their catalog/README/tests paths from."""

    def __init__(self, root: str, files: Sequence[FileContext]):
        self.root = os.path.abspath(root)
        self.files = list(files)
        self.by_rel = {f.rel: f for f in self.files}
        # parse errors surfaced as findings (path, message)
        self.errors: List[Finding] = []


def make_finding(
    rule: str, ctx: FileContext, node: ast.AST, message: str
) -> Finding:
    line = getattr(node, "lineno", 1)
    col = getattr(node, "col_offset", 0)
    return Finding(
        rule=rule,
        path=ctx.rel,
        line=line,
        col=col,
        message=message,
        line_text=ctx.line_text(line),
        end_line=getattr(node, "end_lineno", None) or line,
    )


# -- runner -----------------------------------------------------------------


def iter_python_files(root: str, paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(full):
            if full.endswith(".py"):
                out.append(full)
            continue
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames[:] = [
                d for d in dirnames
                if d != "__pycache__" and not d.startswith(".")
            ]
            for f in sorted(filenames):
                if f.endswith(".py"):
                    out.append(os.path.join(dirpath, f))
    # stable order, no duplicates
    seen: Set[str] = set()
    uniq = []
    for f in sorted(out):
        if f not in seen:
            seen.add(f)
            uniq.append(f)
    return uniq


def build_project(root: str, paths: Sequence[str]) -> Project:
    root = os.path.abspath(root)
    files: List[FileContext] = []
    errors: List[Finding] = []
    for full in iter_python_files(root, paths):
        rel = os.path.relpath(full, root)
        try:
            with open(full, "r", encoding="utf-8") as fh:
                source = fh.read()
            files.append(FileContext(full, rel, source))
        except (OSError, SyntaxError, ValueError) as e:
            errors.append(
                Finding(
                    rule="parse-error",
                    path=rel.replace(os.sep, "/"),
                    line=getattr(e, "lineno", None) or 1,
                    col=0,
                    message=f"could not parse: {e}",
                )
            )
    project = Project(root, files)
    project.errors = errors
    return project


@dataclasses.dataclass
class AnalysisResult:
    findings: List[Finding]  # live, unsuppressed (pre-baseline)
    suppressed: int

    def unbaselined(self, baseline: "Baseline") -> List[Finding]:
        return [f for f in self.findings if not baseline.covers(f)]


def run_analysis(
    root: str,
    paths: Sequence[str],
    rules: Sequence[Rule],
    project: Optional[Project] = None,
) -> AnalysisResult:
    """Parse ``paths`` under ``root``, run every rule, apply inline
    suppressions, and return the surviving findings (baseline handling
    is the caller's — the CLI and the self-clean test share it)."""
    if project is None:
        project = build_project(root, paths)
    raw: List[Finding] = list(project.errors)
    for ctx in project.files:
        for rule in rules:
            for f in rule.check_file(ctx):
                raw.append(f)
    for rule in rules:
        for f in rule.check_project(project):
            raw.append(f)
    live: List[Finding] = []
    suppressed = 0
    for f in raw:
        ctx = project.by_rel.get(f.path)
        if ctx is not None and any(
            ctx.suppressed(f.rule, ln)
            for ln in range(f.line, max(f.line, f.end_line) + 1)
        ):
            suppressed += 1
            continue
        live.append(f)
    live.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    # occurrence indices make duplicate line texts distinguishable in
    # the baseline (two identical offending lines in one file)
    counts: Dict[Tuple[str, str, str], int] = {}
    for f in live:
        k = (f.path, f.rule, f.line_text)
        f.index = counts.get(k, 0)
        counts[k] = f.index + 1
    return AnalysisResult(findings=live, suppressed=suppressed)


# -- baseline ---------------------------------------------------------------


class Baseline:
    """Checked-in grandfathered findings. Each entry must carry a
    ``justification`` — the baseline is for violations that are *by
    design*, not a dumping ground; ``--write-baseline`` stamps a
    placeholder that review is expected to replace."""

    VERSION = 1

    def __init__(self, entries: Optional[List[Dict]] = None):
        self.entries: List[Dict] = entries or []
        self._keys = {
            (
                e.get("path", ""),
                e.get("rule", ""),
                e.get("line_text", ""),
                int(e.get("index", 0)),
            )
            for e in self.entries
        }

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls()
        with open(path, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
        if not isinstance(doc, dict) or "findings" not in doc:
            raise ValueError(
                f"{path}: not a keystone-lint baseline "
                "(want {'version': 1, 'findings': [...]})"
            )
        return cls(list(doc["findings"]))

    @classmethod
    def from_findings(
        cls, findings: Sequence[Finding],
        justification: str = "TODO: justify or fix",
    ) -> "Baseline":
        return cls(
            [
                {**f.to_dict(), "justification": justification}
                for f in findings
            ]
        )

    def save(self, path: str) -> None:
        doc = {
            "version": self.VERSION,
            "tool": "keystone-lint",
            "findings": self.entries,
        }
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=2, sort_keys=False)
            fh.write("\n")

    def covers(self, finding: Finding) -> bool:
        return finding.key() in self._keys

    def stale_entries(self, findings: Sequence[Finding]) -> List[Dict]:
        """Entries no longer matching any live finding — fixed (or the
        line changed); they should be deleted so the baseline only
        shrinks."""
        live = {f.key() for f in findings}
        return [
            e
            for e in self.entries
            if (
                e.get("path", ""),
                e.get("rule", ""),
                e.get("line_text", ""),
                int(e.get("index", 0)),
            )
            not in live
        ]

    def __len__(self) -> int:
        return len(self.entries)
