"""The seven repo-native rules (counterpart of
``keystone_tpu/analysis/rules.py``, with the port's paths and PyTorch's
spellings of a host sync and of blocking device work). Each encodes a
defect class a review actually caught; the docstring of each rule names
the incident it generalizes.

Rules are deliberately *lexical*: they check what can be decided from
one file's AST plus the shared class/lock resolution — no type
inference, no data flow. That keeps every rule O(nodes), keeps
findings explainable (the message quotes the lock or allowlist
involved), and makes the false-positive escape hatch explicit: a
``# lint: disable=<rule>`` with a justification comment, reviewed like
any other code.
"""

from __future__ import annotations

import ast
import fnmatch
import os
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from keystone_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Project,
    Rule,
    Scope,
    ScopedRule,
    make_finding,
)

# -- rule 1: guarded-by -----------------------------------------------------

# mutating container methods: calling one on a guarded attribute is a
# write for lock-discipline purposes (the tracer-ring / fault-spec /
# admission-queue state is all dict/deque mutation, not rebinding)
_MUTATORS = frozenset({
    "append", "appendleft", "extend", "insert",
    "pop", "popleft", "remove", "discard", "clear",
    "add", "update", "setdefault",
})


class GuardedByRule(ScopedRule):
    """An attribute annotated ``# guarded-by: <lock>`` on its class may
    only be written — rebound, item-assigned, or mutated through a
    container method — inside a ``with self.<lock>`` block.

    The incident class: the tracer ring swap, the staging-bytes gauge
    stamped on a retired engine, the request-log stop() close race —
    all writes to lock-protected state that compiled fine and raced
    rarely.

    Exemptions: ``__init__`` (construction happens-before publication)
    and methods named ``*_locked`` (the caller-holds-the-lock
    convention, e.g. ``FaultInjector._disarm_locked``)."""

    name = "guarded-by"
    description = (
        "writes to `# guarded-by:`-annotated attributes must hold the "
        "named lock"
    )

    def _exempt(self, scope: Scope) -> bool:
        fn = scope.func
        return fn is not None and (
            fn == "__init__" or fn.endswith("_locked")
        )

    def _check_attr_write(
        self,
        target: ast.AST,
        node: ast.AST,
        ctx: FileContext,
        scope: Scope,
        findings: List[Finding],
        via: str,
    ) -> None:
        if not isinstance(target, ast.Attribute):
            return
        attr = target.attr
        base = target.value
        try:
            base_text = ast.unparse(base)
        except Exception:
            return
        if base_text == "self":
            info = ctx.classes.get(scope.cls) if scope.cls else None
            if info is None or attr not in info.guarded:
                return
            lock = info.guarded[attr]
            owner = scope.cls
        else:
            # cross-object write: `_global_tracer._ring = ...` — only
            # when the attr is annotated in exactly one class of this
            # module, so the association is unambiguous
            if attr not in ctx.unique_guarded:
                return
            owner, lock = ctx.unique_guarded[attr]
        if self._exempt(scope):
            return
        want = f"{base_text}.{lock}"
        if want in scope.lock_stack:
            return
        findings.append(
            make_finding(
                self.name, ctx, node,
                f"`{base_text}.{attr}` is `# guarded-by: {lock}` "
                f"(class {owner}) but {via} outside `with {want}`",
            )
        )

    def on_node(self, node, ctx, scope, findings):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target]
            )
            for t in targets:
                if isinstance(t, ast.Subscript):
                    self._check_attr_write(
                        t.value, node, ctx, scope, findings,
                        via="item-assigned",
                    )
                elif isinstance(t, ast.Tuple):
                    for elt in t.elts:
                        self._check_attr_write(
                            elt, node, ctx, scope, findings,
                            via="written",
                        )
                else:
                    self._check_attr_write(
                        t, node, ctx, scope, findings, via="written"
                    )
        elif isinstance(node, ast.Call):
            fn = node.func
            if (
                isinstance(fn, ast.Attribute)
                and fn.attr in _MUTATORS
            ):
                self._check_attr_write(
                    fn.value, node, ctx, scope, findings,
                    via=f"mutated (`.{fn.attr}()`)",
                )
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                base = t.value if isinstance(t, ast.Subscript) else t
                self._check_attr_write(
                    base, node, ctx, scope, findings, via="deleted"
                )


# -- rule 2: blocking-under-lock --------------------------------------------

# dotted call texts that block outright
_BLOCKING_DOTTED = frozenset({
    "time.sleep",
    "sleep",
    "urllib.request.urlopen",
    "subprocess.run",
    "subprocess.check_output",
    "subprocess.check_call",
    "socket.create_connection",
    # a CUDA graph capture (also as a `with` header): its entry
    # synchronizes the card, and the warm kernels run first
    "torch.cuda.graph",
    # the shared capture core (workflow/cuda_graph.py): warm pass,
    # capture and a checking replay, with stream waits
    "capture_graph",
    "cuda_graph.capture_graph",
})

# attribute calls that block: futures, sockets/HTTP, and engine
# build/warmup/dispatch/capture (a graph capture under the pool lock
# stalls every lane; "build engines OUTSIDE the lock" is the checked
# design)
_BLOCKING_ATTRS = frozenset({
    "result",            # Future.result
    "warmup",            # CompiledPipeline.warmup (captures)
    "apply",             # CompiledPipeline.apply (device dispatch)
    "compute_staged",    # bucket dispatch
    "_capture",          # CompiledPipeline._capture (warm pass + graph)
    "synchronize",       # torch.cuda / stream / event / engine waits
    "build_replacements",  # EnginePool generation build
    "build_engines",     # Gateway generation build
    "urlopen", "getresponse", "recv", "accept", "connect",
})


class BlockingUnderLockRule(ScopedRule):
    """Blocking work — sleeps, thread joins, ``Future.result``,
    socket/HTTP calls, engine dispatch/warmup/build, CUDA graph
    captures and stream/event/card ``synchronize()`` — flagged when
    lexically inside a lock's ``with`` body.

    ``<expr>.join(...)`` counts only as a *statement* (result unused):
    that is a thread join; ``str.join``/``os.path.join`` results are
    always consumed. ``Condition.wait`` is exempt — it releases the
    lock it waits on."""

    name = "blocking-under-lock"
    description = (
        "no sleeps / joins / Future.result / sockets / engine "
        "dispatch+warmup / graph captures / device syncs inside a "
        "lock's `with` body"
    )

    def on_node(self, node, ctx, scope, findings):
        if not scope.lock_stack:
            return
        held = scope.lock_stack[-1]
        call: Optional[ast.Call] = None
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            stmt_call = node.value
            fn = stmt_call.func
            if isinstance(fn, ast.Attribute) and fn.attr == "join":
                findings.append(
                    make_finding(
                        self.name, ctx, node,
                        f"`.join()` (statement form: a thread join) "
                        f"inside `with {held}`",
                    )
                )
                return
        if isinstance(node, ast.Call):
            call = node
        if call is None:
            return
        try:
            fn_text = ast.unparse(call.func)
        except Exception:
            return
        if fn_text in _BLOCKING_DOTTED:
            findings.append(
                make_finding(
                    self.name, ctx, call,
                    f"blocking call `{fn_text}(...)` inside "
                    f"`with {held}`",
                )
            )
            return
        fn = call.func
        if isinstance(fn, ast.Attribute) and fn.attr in _BLOCKING_ATTRS:
            findings.append(
                make_finding(
                    self.name, ctx, call,
                    f"blocking call `{fn_text}(...)` inside "
                    f"`with {held}` (build/dispatch work belongs "
                    "outside the lock; re-pointing alone goes under it)",
                )
            )


# -- rule 3: strippable-assert ----------------------------------------------


class StrippableAssertRule(Rule):
    """Bare ``assert`` outside ``tests/`` must be an explicit raise:
    ``python -O`` strips asserts, so an enforcement/gating path that
    asserts is a path that silently stops enforcing in optimized runs
    (the chaos-row fix, applied as a rule)."""

    name = "strippable-assert"
    description = (
        "enforcement paths must raise, not assert (`-O` strips asserts)"
    )

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        rel = ctx.rel
        if rel.startswith("tests/") or "/tests/" in rel:
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assert):
                yield make_finding(
                    self.name, ctx, node,
                    "bare `assert` is stripped under `python -O`; "
                    "raise AssertionError/ValueError explicitly",
                )


# -- rule 4: absent-not-zero ------------------------------------------------

# the degradable families: series that exist only when their input
# exists (cost analysis present, peaks detected, sampler live). The
# contract: a backend that reports nothing yields ABSENT series —
# pre-registering one of these, or stamping 0 on the unavailable path,
# turns "unknown" into a confident lie on every dashboard
DEGRADABLE_SERIES = frozenset({
    "keystone_serving_mfu",
    "keystone_device_roofline_bound",
    "keystone_device_flops_per_dispatch",
    "keystone_device_bytes_per_dispatch",
    "keystone_device_temp_hbm_bytes",
    "keystone_serving_device_flops_total",
    "keystone_serving_padding_efficiency",
    "keystone_serving_staging_bytes",
    "keystone_device_memory_bytes",
})

# receiver/method-name shapes whose `.set(0)` / `set_x(0)` means
# "stamp zero where the honest value is absent" (staging bytes are
# excluded: an empty pool is a real measured zero, not an unknown)
_DEGRADABLE_ATTR_RE = re.compile(
    r"(mfu|roofline|cost_model|device_mem|temp_hbm|flops)",
    re.IGNORECASE,
)

_REGISTRATION_METHODS = frozenset(
    {"gauge", "counter", "histogram", "gauge_func", "summary"}
)


def _zero_const(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value in (0, 0.0)


class AbsentNotZeroRule(ScopedRule):
    """Degradable metric series (cost-model, MFU, roofline,
    device-memory families) must never be pre-registered or ``.set(0)``
    on the unavailable path. Three shapes are flagged:

    - registering a degradable family *unlabeled* at module scope or in
      ``__init__`` (a labeled family with no cells scrapes as absent;
      an unlabeled one scrapes as a lying 0 the moment it exists);
    - ``<x>.set(0)`` / ``set_mfu(0)``-shaped calls whose receiver or
      method names a degradable family;
    - ``X if X is not None else 0`` fallbacks inside a call that emits
      a degradable family (the absent case must skip the sample, not
      zero it)."""

    name = "absent-not-zero"
    description = (
        "degradable metric series stay ABSENT when unavailable — "
        "never pre-registered, never zero-stamped"
    )

    def _first_str_arg(self, call: ast.Call) -> Optional[str]:
        if call.args and isinstance(call.args[0], ast.Constant) and (
            isinstance(call.args[0].value, str)
        ):
            return call.args[0].value
        return None

    def _has_labels(self, call: ast.Call) -> bool:
        # gauge(name, help, labelnames) / labelnames= kwarg: a
        # non-empty labels tuple means no cell exists until set(labels)
        for kw in call.keywords:
            if kw.arg in ("labelnames", "labels"):
                return not (
                    isinstance(kw.value, (ast.Tuple, ast.List))
                    and not kw.value.elts
                )
        if len(call.args) >= 3:
            a = call.args[2]
            return not (
                isinstance(a, (ast.Tuple, ast.List)) and not a.elts
            )
        return False

    def on_node(self, node, ctx, scope, findings):
        if not isinstance(node, ast.Call):
            return
        fn = node.func
        name_arg = self._first_str_arg(node)
        # (a) eager registration of a degradable family
        if (
            isinstance(fn, ast.Attribute)
            and fn.attr in _REGISTRATION_METHODS
            and name_arg in DEGRADABLE_SERIES
            and (scope.func is None or scope.func == "__init__")
            and not self._has_labels(node)
        ):
            findings.append(
                make_finding(
                    self.name, ctx, node,
                    f"degradable series `{name_arg}` pre-registered "
                    "unlabeled at construction — it scrapes as 0 "
                    "before its input exists; register lazily on the "
                    "available path (or label it)",
                )
            )
            return
        # (b) zero-stamp: receiver/method names a degradable family
        if isinstance(fn, ast.Attribute):
            stamped = None
            if (
                fn.attr == "set"
                and len(node.args) >= 1
                and _zero_const(node.args[0])
            ):
                try:
                    recv = ast.unparse(fn.value)
                except Exception:
                    recv = ""
                if _DEGRADABLE_ATTR_RE.search(recv.split(".")[-1]):
                    stamped = recv
            elif (
                fn.attr.startswith("set_")
                and _DEGRADABLE_ATTR_RE.search(fn.attr)
                and node.args
                and _zero_const(node.args[0])
            ):
                stamped = fn.attr
            if stamped is not None:
                findings.append(
                    make_finding(
                        self.name, ctx, node,
                        f"`{stamped}` stamped with literal 0 — the "
                        "unavailable path must leave the series "
                        "absent, not zero",
                    )
                )
                return
        # (c) `X if X is not None else 0` — or the inverted spelling
        # `0 if X is None else X` — feeding a degradable family (the
        # test must be an is[-not]-None check: one-hot encodings like
        # `1.0 if side == r else 0.0` are real values, not absence
        # fallbacks)
        if name_arg in DEGRADABLE_SERIES:
            for sub in ast.walk(node):
                if (
                    isinstance(sub, ast.IfExp)
                    and (
                        _zero_const(sub.orelse)
                        or _zero_const(sub.body)
                    )
                    and isinstance(sub.test, ast.Compare)
                    and any(
                        isinstance(op, (ast.IsNot, ast.Is))
                        for op in sub.test.ops
                    )
                    and any(
                        isinstance(c, ast.Constant) and c.value is None
                        for c in sub.test.comparators
                    )
                ):
                    findings.append(
                        make_finding(
                            self.name, ctx, sub,
                            f"zero fallback inside the emission of "
                            f"degradable series `{name_arg}` — skip "
                            "the sample when the input is absent",
                        )
                    )
                    return


# -- rule 5: hot-path host-sync ---------------------------------------------

# designated hot-path modules -> allowlisted gather-once points
# (qualname prefixes). The incident: per-row device-array slicing in the
# delivery path dispatched one device op per request — measured as THE
# pipelined-lane bottleneck and fixed with a single host gather; the
# gather entries are exactly those gather points. The other entries are
# paths off the dispatch path that wait for the card on purpose.
HOT_PATH_MODULES: Dict[str, Set[str]] = {
    "keystone_tpu_torch/serving/engine.py": {
        # host-side pad into the pooled staging buffer: host arrays in,
        # pinned host buffers out, by design (the prep stage burns host
        # cores while the device computes the previous window)
        "CompiledPipeline.host_stage",
        # the wait a caller asks for: apply(sync=True) and the lane's
        # compute stage, which times the dispatch to completion
        "CompiledPipeline.synchronize",
        # warm pass and graph capture: before traffic (warmup) or once
        # per bucket, never per dispatch
        "CompiledPipeline._capture",
        # retire: waits for the engine's last replays before the graphs
        # are reset, after the last window
        "CompiledPipeline.release_graphs",
        # the AOT store's warmup check: a probe replay copied to the
        # host, and the drop of a graph that failed it
        "CompiledPipeline._probe",
        "CompiledPipeline._drop_graph",
        # NOT listed, deliberately: compute_staged's H2D-bytes read
        # (`a.nbytes` over the staged leaves) is tensor METADATA —
        # shape x itemsize, no device round-trip — so the
        # device-featurize accounting needs no gather-once exemption;
        # adding one here would license real syncs on the dispatch path
    },
    "keystone_tpu_torch/serving/pipeline.py": {
        # THE gather-once point: one device-to-host copy per window
        # leaf (through _to_numpy), futures resolve with row views of it
        "resolve_window_futures",
        "_to_numpy",
        "LanePipeline._deliver",
        # a failed window: the copy may still read the pinned buffer
        # that goes back to the pool
        "LanePipeline._fail_window",
    },
    "keystone_tpu_torch/gateway/pool.py": set(),
}

_HOST_SYNC_CALLS = {
    "np.asarray", "numpy.asarray", "np.array", "numpy.array",
    "jax.device_get",
}

# PyTorch's spellings: `.cpu()`/`.numpy()`/`.tolist()` copy a tensor to
# the host; `.synchronize()` (a stream's, an event's, the engine's, or
# `torch.cuda.synchronize()`) waits for the card
_HOST_COPY_ATTRS = frozenset({"cpu", "numpy", "tolist"})


class HotPathHostSyncRule(ScopedRule):
    """In the designated hot-path modules, ``float()`` on a value,
    ``.item()``, ``np.asarray()``/``np.array()``, ``jax.device_get()``,
    PyTorch's ``.cpu()``/``.numpy()``/``.tolist()``, any
    ``.synchronize()`` (``torch.cuda.synchronize()``, a stream's or an
    event's) and per-row loop-index subscripting are host syncs — each
    one round-trips the device per call. They are allowed only at the
    allowlisted gather-once points."""

    name = "hot-path-host-sync"
    description = (
        "host syncs (float/.item()/.cpu()/np.asarray/synchronize()/"
        "per-row indexing) only at allowlisted gather-once points in "
        "hot-path modules"
    )

    def __init__(
        self, modules: Optional[Dict[str, Set[str]]] = None
    ):
        self.modules = modules if modules is not None else HOT_PATH_MODULES

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.rel not in self.modules:
            return ()
        return super().check_file(ctx)

    def _allowlisted(self, ctx: FileContext, scope: Scope) -> bool:
        allowed = self.modules.get(ctx.rel, set())
        qual = scope.qualname()
        return any(
            qual == a or qual.startswith(a + ".") for a in allowed
        )

    def on_node(self, node, ctx, scope, findings):
        if self._allowlisted(ctx, scope):
            return
        if isinstance(node, ast.Call):
            fn = node.func
            if (
                isinstance(fn, ast.Name)
                and fn.id == "float"
                and len(node.args) == 1
                and isinstance(
                    node.args[0],
                    (ast.Name, ast.Attribute, ast.Subscript),
                )
            ):
                findings.append(
                    make_finding(
                        self.name, ctx, node,
                        "`float(...)` on a value is a device->host "
                        "sync on the hot path",
                    )
                )
                return
            try:
                fn_text = ast.unparse(fn)
            except Exception:
                return
            if fn_text in _HOST_SYNC_CALLS:
                findings.append(
                    make_finding(
                        self.name, ctx, node,
                        f"`{fn_text}(...)` gathers to host — hot-path "
                        "code must gather once at an allowlisted "
                        "point, not per call",
                    )
                )
                return
            if (
                isinstance(fn, ast.Attribute)
                and fn.attr == "item"
                and not node.args
            ):
                findings.append(
                    make_finding(
                        self.name, ctx, node,
                        "`.item()` is a per-element device->host sync",
                    )
                )
            elif isinstance(fn, ast.Attribute) and fn.attr in _HOST_COPY_ATTRS:
                findings.append(
                    make_finding(
                        self.name, ctx, node,
                        f"`.{fn.attr}()` copies device->host — hot-path "
                        "code must gather once at an allowlisted point, "
                        "not per call",
                    )
                )
            elif isinstance(fn, ast.Attribute) and fn.attr == "synchronize":
                findings.append(
                    make_finding(
                        self.name, ctx, node,
                        f"`{fn_text}()` makes the host wait for the "
                        "device — hot-path code waits only at an "
                        "allowlisted point",
                    )
                )
            return
        if (
            isinstance(node, ast.Subscript)
            and isinstance(node.ctx, ast.Load)
            # bare-Name receivers only: `a[i]` in a row loop is the
            # per-request device-op pattern; `self._aot[b]` and other
            # attribute-rooted subscripts are dict/config lookups
            and isinstance(node.value, ast.Name)
            and isinstance(node.slice, ast.Name)
            and node.slice.id in scope.loop_vars
        ):
            findings.append(
                make_finding(
                    self.name, ctx, node,
                    "per-row indexing with a loop variable dispatches "
                    "one device op per row — gather the window once "
                    "and slice host-side",
                )
            )


# -- rule 6: fault-point-drift ----------------------------------------------


class FaultPointDriftRule(Rule):
    """The fault-point names wired in code (``faults.fire(...)`` /
    ``register_trigger(...)`` literals), cataloged in ``FAULT_POINTS``,
    documented in README's catalog table, and exercised in the port's
    own tests (``tests/test_torch_*.py``: the JAX package's tests
    exercise its points, not the port's) must agree — a chaos point that
    exists in only some of those places is a drill that silently stopped
    covering what it claims to."""

    name = "fault-point-drift"
    description = (
        "fault points must agree across FAULT_POINTS, call sites, the "
        "README catalog table, and tests/test_torch_*.py"
    )

    _POINT_RE = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_]+)+$")
    _README_ROW_RE = re.compile(r"^\|\s*`([a-z0-9_.]+)`\s*\|")
    # the port's own tests, under tests_rel
    TESTS_GLOB = "test_torch_*.py"

    def __init__(
        self,
        faults_rel: str = "keystone_tpu_torch/loadgen/faults.py",
        readme_rel: str = "README.md",
        tests_rel: str = "tests",
        package_rel: str = "keystone_tpu_torch",
        catalog_var: str = "FAULT_POINTS",
    ):
        self.faults_rel = faults_rel
        self.readme_rel = readme_rel
        self.tests_rel = tests_rel
        self.package_rel = package_rel
        self.catalog_var = catalog_var

    def _catalog(
        self, project: Project
    ) -> Tuple[Optional[Dict[str, int]], Optional[Finding]]:
        """FAULT_POINTS keys -> their source lines (from the AST)."""
        path = os.path.join(project.root, self.faults_rel)
        ctx = project.by_rel.get(self.faults_rel.replace(os.sep, "/"))
        if ctx is None:
            if not os.path.exists(path):
                return None, None  # project without a fault plane
            with open(path, "r", encoding="utf-8") as fh:
                ctx = FileContext(path, self.faults_rel, fh.read())
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target]
            )
            names = {
                t.id for t in targets if isinstance(t, ast.Name)
            }
            if self.catalog_var not in names:
                continue
            if not isinstance(node.value, ast.Dict):
                break
            out: Dict[str, int] = {}
            for k in node.value.keys:
                if isinstance(k, ast.Constant) and isinstance(
                    k.value, str
                ):
                    out[k.value] = k.lineno
            return out, None
        return None, Finding(
            rule=self.name,
            path=self.faults_rel.replace(os.sep, "/"),
            line=1,
            col=0,
            message=(
                f"no `{self.catalog_var} = {{...}}` dict literal found "
                "— the fault-point catalog is the drift check's anchor"
            ),
        )

    def _wired(self, project: Project) -> Dict[str, Tuple[str, int]]:
        """point -> (rel, line) of one call site arming/firing it.
        Always scans the WHOLE package from disk: a --changed-only
        slice must not make unchanged call sites look unwired."""
        from keystone_tpu_torch.analysis.core import iter_python_files

        wired: Dict[str, Tuple[str, int]] = {}
        faults_rel = self.faults_rel.replace(os.sep, "/")
        for full in iter_python_files(project.root, [self.package_rel]):
            rel = os.path.relpath(full, project.root).replace(
                os.sep, "/"
            )
            if rel == faults_rel:
                continue  # the registry itself, not a wiring site
            ctx = project.by_rel.get(rel)
            if ctx is None:
                try:
                    with open(full, "r", encoding="utf-8") as fh:
                        ctx = FileContext(full, rel, fh.read())
                except (OSError, SyntaxError, ValueError):
                    continue
            for node in ast.walk(ctx.tree):
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                is_fire = (
                    isinstance(fn, ast.Attribute)
                    and fn.attr in ("fire", "register_trigger")
                ) or (
                    isinstance(fn, ast.Name)
                    and fn.id in ("fire", "register_trigger")
                )
                if not is_fire or not node.args:
                    continue
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(
                    arg.value, str
                ) and self._POINT_RE.match(arg.value):
                    wired.setdefault(
                        arg.value, (ctx.rel, arg.lineno)
                    )
        return wired

    def _readme_points(
        self, project: Project
    ) -> Tuple[Optional[Dict[str, int]], int]:
        path = os.path.join(project.root, self.readme_rel)
        if not os.path.exists(path):
            return None, 1
        with open(path, "r", encoding="utf-8") as fh:
            lines = fh.read().splitlines()
        start = None
        for i, line in enumerate(lines, start=1):
            if "Fault-point catalog" in line:
                start = i
                break
        if start is None:
            return None, 1
        points: Dict[str, int] = {}
        for i in range(start, len(lines) + 1):
            line = lines[i - 1]
            if i > start and (
                line.startswith("#") or line.startswith("**")
            ):
                break  # next section/paragraph heading ends the table
            m = self._README_ROW_RE.match(line)
            if m and self._POINT_RE.match(m.group(1)):
                points[m.group(1)] = i
        return points, start

    def _tests_corpus(self, project: Project) -> str:
        """The text of every test file matching ``TESTS_GLOB``, read
        ONCE per analysis run (not once per cataloged point — the walk
        is the expensive part)."""
        tests_dir = os.path.join(project.root, self.tests_rel)
        chunks: List[str] = []
        for dirpath, dirnames, filenames in os.walk(tests_dir):
            dirnames[:] = [
                d for d in dirnames if d != "__pycache__"
            ]
            for f in filenames:
                if not fnmatch.fnmatch(f, self.TESTS_GLOB):
                    continue
                try:
                    with open(
                        os.path.join(dirpath, f), "r", encoding="utf-8"
                    ) as fh:
                        chunks.append(fh.read())
                except OSError:
                    continue
        return "\n".join(chunks)

    def check_project(self, project: Project) -> Iterable[Finding]:
        catalog, err = self._catalog(project)
        if err is not None:
            yield err
            return
        if catalog is None:
            return
        faults_rel = self.faults_rel.replace(os.sep, "/")
        readme_rel = self.readme_rel.replace(os.sep, "/")
        wired = self._wired(project)
        readme, table_line = self._readme_points(project)
        if readme is None:
            yield Finding(
                rule=self.name, path=readme_rel, line=1, col=0,
                message=(
                    "no 'Fault-point catalog' table found in README — "
                    "the catalog must be documented where operators "
                    "look for it"
                ),
            )
        else:
            for point, line in sorted(catalog.items()):
                if point not in readme:
                    yield Finding(
                        rule=self.name, path=readme_rel,
                        line=table_line, col=0,
                        message=(
                            f"cataloged fault point `{point}` missing "
                            "from the README fault-point table"
                        ),
                    )
            for point, line in sorted(readme.items()):
                if point not in catalog:
                    yield Finding(
                        rule=self.name, path=readme_rel, line=line,
                        col=0,
                        message=(
                            f"README documents fault point `{point}` "
                            "that FAULT_POINTS does not catalog"
                        ),
                    )
        corpus = self._tests_corpus(project)
        for point, line in sorted(catalog.items()):
            if point not in wired:
                yield Finding(
                    rule=self.name, path=faults_rel, line=line, col=0,
                    message=(
                        f"cataloged fault point `{point}` has no "
                        "`fire(...)`/`register_trigger(...)` call site "
                        f"in {self.package_rel}/ — a point nothing consults "
                        "never fires"
                    ),
                )
            elif point not in corpus:
                yield Finding(
                    rule=self.name, path=faults_rel, line=line, col=0,
                    message=(
                        f"cataloged fault point `{point}` appears "
                        f"nowhere under {self.tests_rel}/{self.TESTS_GLOB}"
                        " — every chaos point needs a test exercising it"
                    ),
                )
        for point, (rel, line) in sorted(wired.items()):
            if point not in catalog:
                yield Finding(
                    rule=self.name, path=rel, line=line, col=0,
                    message=(
                        f"fault point `{point}` is wired here but "
                        "missing from FAULT_POINTS — /chaosz can't "
                        "validate arms against it"
                    ),
                )

    # README/line-text note: README findings anchor to markdown, where
    # `line_text` stays empty (the baseline key still works: path +
    # rule + message-stable anchor line text "").


# -- rule 7: metric-family-drift ---------------------------------------------


class MetricFamilyDriftRule(Rule):
    """The ``keystone_*`` metric families registered in code and the
    README's metric-family catalog table must agree in both
    directions — a family operators can't find documented is a dark
    series, and a documented family nothing registers is a dashboard
    pointed at nothing.

    Registration sites are the registry methods
    (``counter``/``gauge``/``gauge_func``/``summary``/``histogram``/
    ``latency``) and direct ``MetricFamily(...)`` construction, scanned
    over the WHOLE package from disk like the fault-point rule (a
    ``--changed-only`` slice must not make unchanged registrations look
    undocumented). F-string family names (``f"keystone_attr_{f}_total"``)
    become wildcard patterns: each must match at least one catalog row,
    and rows they match count as registered.

    Asymmetry by design: the registered→documented direction only
    counts names the scan can prove are registered (literal first args
    of registration calls), but the documented→registered direction
    accepts any catalog row whose name appears as a string literal
    anywhere in the package — families registered through a variable
    (the ``device_families`` per-key loop) would otherwise read as
    phantom rows."""

    name = "metric-family-drift"
    description = (
        "registered keystone_* metric families and the README "
        "metric-family catalog table must agree both ways"
    )

    _FAMILY_RE = re.compile(r"^keystone_[a-z0-9_]+$")
    _README_ROW_RE = re.compile(r"^\|\s*`(keystone_[a-z0-9_]+)`")
    _REGISTER_FUNCS = frozenset(
        ("counter", "gauge", "gauge_func", "summary", "histogram",
         "latency", "MetricFamily")
    )

    def __init__(
        self,
        readme_rel: str = "README.md",
        package_rel: str = "keystone_tpu_torch",
        table_heading: str = "Metric-family catalog",
    ):
        self.readme_rel = readme_rel
        self.package_rel = package_rel
        self.table_heading = table_heading

    def _registered(
        self, project: Project
    ) -> Tuple[
        Dict[str, Tuple[str, int]],
        List[Tuple["re.Pattern", str, str, int]],
        Set[str],
    ]:
        """Literal family -> one registration site, the wildcard
        patterns compiled from f-string registrations, and every
        family-shaped string literal seen anywhere (the
        phantom-suppression set for indirect registrations)."""
        from keystone_tpu_torch.analysis.core import iter_python_files

        literals: Dict[str, Tuple[str, int]] = {}
        patterns: List[Tuple[re.Pattern, str, str, int]] = []
        mentioned: Set[str] = set()
        for full in iter_python_files(project.root, [self.package_rel]):
            rel = os.path.relpath(full, project.root).replace(
                os.sep, "/"
            )
            ctx = project.by_rel.get(rel)
            if ctx is None:
                try:
                    with open(full, "r", encoding="utf-8") as fh:
                        ctx = FileContext(full, rel, fh.read())
                except (OSError, SyntaxError, ValueError):
                    continue
            for node in ast.walk(ctx.tree):
                if (
                    isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and self._FAMILY_RE.match(node.value)
                ):
                    mentioned.add(node.value)
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                fn = node.func
                fn_name = (
                    fn.attr if isinstance(fn, ast.Attribute)
                    else fn.id if isinstance(fn, ast.Name) else None
                )
                if fn_name not in self._REGISTER_FUNCS:
                    continue
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(
                    arg.value, str
                ):
                    if self._FAMILY_RE.match(arg.value):
                        literals.setdefault(
                            arg.value, (rel, arg.lineno)
                        )
                elif isinstance(arg, ast.JoinedStr):
                    pieces: List[str] = []
                    for part in arg.values:
                        if isinstance(part, ast.Constant) and isinstance(
                            part.value, str
                        ):
                            pieces.append(re.escape(part.value))
                        else:
                            pieces.append("[a-z0-9_]+")
                    raw = "".join(pieces)
                    if raw.startswith("keystone_"):
                        patterns.append((
                            re.compile(f"^{raw}$"), raw, rel,
                            arg.lineno,
                        ))
        return literals, patterns, mentioned

    def _readme_rows(
        self, project: Project
    ) -> Tuple[Optional[Dict[str, int]], int]:
        path = os.path.join(project.root, self.readme_rel)
        if not os.path.exists(path):
            return None, 1
        with open(path, "r", encoding="utf-8") as fh:
            lines = fh.read().splitlines()
        start = None
        for i, line in enumerate(lines, start=1):
            if self.table_heading in line:
                start = i
                break
        if start is None:
            return None, 1
        rows: Dict[str, int] = {}
        for i in range(start, len(lines) + 1):
            line = lines[i - 1]
            if i > start and (
                line.startswith("#") or line.startswith("**")
            ):
                break  # next section/paragraph heading ends the table
            m = self._README_ROW_RE.match(line)
            if m:
                rows[m.group(1)] = i
        return rows, start

    def check_project(self, project: Project) -> Iterable[Finding]:
        readme_rel = self.readme_rel.replace(os.sep, "/")
        literals, patterns, mentioned = self._registered(project)
        if not literals and not patterns:
            return  # project without a metrics plane
        rows, table_line = self._readme_rows(project)
        if rows is None:
            yield Finding(
                rule=self.name, path=readme_rel, line=1, col=0,
                message=(
                    f"no '{self.table_heading}' table found in README "
                    "— the exported families must be documented where "
                    "operators look for them"
                ),
            )
            return
        for family, (rel, line) in sorted(literals.items()):
            if family not in rows:
                yield Finding(
                    rule=self.name, path=readme_rel, line=table_line,
                    col=0,
                    message=(
                        f"registered metric family `{family}` "
                        f"({rel}:{line}) missing from the README "
                        "metric-family catalog table"
                    ),
                )
        for pattern, raw, rel, line in sorted(
            patterns, key=lambda p: (p[1], p[2])
        ):
            if not any(pattern.match(r) for r in rows):
                yield Finding(
                    rule=self.name, path=rel, line=line, col=0,
                    message=(
                        f"f-string-registered family `{raw}` matches "
                        "no row of the README metric-family catalog "
                        "table — document each concrete family it "
                        "expands to"
                    ),
                )
        for family, line in sorted(rows.items()):
            if family in literals or family in mentioned:
                continue
            if any(p.match(family) for p, _, _, _ in patterns):
                continue
            yield Finding(
                rule=self.name, path=readme_rel, line=line, col=0,
                message=(
                    f"README catalogs metric family `{family}` that "
                    "nothing in the package registers"
                ),
            )


# -- registry ---------------------------------------------------------------

ALL_RULES = (
    GuardedByRule,
    BlockingUnderLockRule,
    StrippableAssertRule,
    AbsentNotZeroRule,
    HotPathHostSyncRule,
    FaultPointDriftRule,
    MetricFamilyDriftRule,
)


def default_rules() -> List[Rule]:
    return [cls() for cls in ALL_RULES]
