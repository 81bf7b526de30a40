"""The port holds every public name of the JAX package: for each module of
``keystone_tpu/`` (read with ``ast``, so nothing of JAX is imported),
its public functions and classes, each public class's public methods
and properties, its dataclass fields and its constructor's parameters,
and the parameter names of every public function and method must be in
the port's module of the same path (methods may be inherited; a
``**kwargs`` takes any name). What the port leaves out on purpose is
``DEPARTURES``, each with its reason, and every entry there must be a
gap the walk really finds."""

import ast
import importlib
import inspect
import os
import textwrap
from typing import Dict, List, Optional, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# key -> why the port does without it. Keys: "module" (the whole module),
# "module:name", "module:Class.member", "module:func(param)",
# "module:Class.method(param)", "module:Class(param)" (the constructor)
NO_MESH = ("the port's serving engine runs on one card; serving over a mesh of "
           "processes waits for the model axis across processes (ROADMAP A)")
DEPARTURES: Dict[str, str] = {
    "ops.images.pallas_kernels": (
        "the Pallas kernels B1 and B2: the port's are csrc/sift_bin.cu and "
        "csrc/sandwich.cu behind ops/images/kernels.py"),
    "ops.images.fv_pallas": (
        "the Pallas kernel B3: the port's is csrc/fv_stats.cu behind "
        "ops/images/fv_kernel.py"),
    "parallel.runtime:setup_compilation_cache": (
        "XLA's persistent compilation cache; the port compiles no programs: its "
        "CUDA libraries build into _build/ (or $KEYSTONE_CUDA_BUILD_DIR) and the AOT "
        "store keeps them (setup_aot_cache)"),
    "parallel.virtual:provision_devices": (
        "gives one process n virtual XLA CPU devices; the port runs one process per "
        "device, and parallel.virtual.launch starts n processes joined in one group"),
    "utils.precision:hi_if_f32": (
        "XLA's matmul precision argument; the port turns TF32 off once "
        "(_device.py), so float32 products are float32"),
    "observability.device:compiled_cost_model": (
        "reads an XLA compiled program's cost analysis; the port counts "
        "the same flops and bytes with CostCounter while the chain runs"),
    "serving.engine:CompiledPipeline(donate)": (
        "XLA input donation; a CUDA graph reads its own static input, into "
        "which every batch is copied"),
    "serving.engine:CompiledPipeline(shard)": "data sharding over a mesh; " + NO_MESH,
    "serving.engine:CompiledPipeline(mesh)": "the mesh of shard=; " + NO_MESH,
    "serving.engine:CompiledPipeline.apply(owned)": (
        "promises a batch may be donated to XLA; nothing is donated to a "
        "CUDA graph"),
    "serving.aot:AotStore.save(compiled)": (
        "a serialized XLA executable; a CUDA graph cannot be serialized, so "
        "the port's store keeps the kernels and the bucket's operators"),
}


def _decorator(d: ast.expr) -> str:
    if isinstance(d, ast.Call):
        d = d.func
    if isinstance(d, ast.Attribute):
        return d.attr
    return d.id if isinstance(d, ast.Name) else ""


def _params(fn: ast.FunctionDef, method: bool) -> List[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if method and "staticmethod" not in {_decorator(d) for d in fn.decorator_list}:
        names = names[1:]  # self / cls
    return names


def public_surface(path: str) -> List[Tuple[str, str, Optional[str], Optional[List[str]]]]:
    """``(kind, name, member, params)`` for the public module-level
    functions and classes of one source file: kinds ``func``, ``class``,
    ``init`` (constructor parameters), ``method`` (params None for a
    property) and ``field`` (a dataclass field)."""
    tree = ast.parse(open(path, encoding="utf-8").read())
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                out.append(("func", node.name, None, _params(node, False)))
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out.append(("class", node.name, None, None))
            is_dc = any(_decorator(d) == "dataclass" for d in node.decorator_list)
            for b in node.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    decs = {_decorator(d) for d in b.decorator_list}
                    if b.name == "__init__":
                        out.append(("init", node.name, None, _params(b, True)))
                    elif not b.name.startswith("_"):
                        prop = bool(decs & {"property", "cached_property", "setter"})
                        out.append(("method", node.name, b.name,
                                    None if prop else _params(b, True)))
                elif (is_dc and isinstance(b, ast.AnnAssign)
                      and isinstance(b.target, ast.Name)
                      and not b.target.id.startswith("_")
                      and "ClassVar" not in ast.unparse(b.annotation)):
                    out.append(("field", node.name, b.target.id, None))
    return out


def _accepts(obj, names: List[str]) -> List[str]:
    """The names of ``names`` that ``obj``'s signature lacks (none when it
    takes ``**kwargs`` or has no signature)."""
    try:
        params = inspect.signature(obj).parameters
    except (TypeError, ValueError):
        return []
    if any(p.kind == p.VAR_KEYWORD for p in params.values()):
        return []
    return [n for n in names if n not in params]


def gaps(src_root: str, src_pkg: str, port_pkg: str) -> List[str]:
    """Every public name of the package under ``src_root/src_pkg`` that
    the importable ``port_pkg`` lacks, as ``DEPARTURES`` keys."""
    found = []
    base = os.path.join(src_root, src_pkg)
    for dirpath, _, files in os.walk(base):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), base)[:-3].replace(os.sep, ".")
            mod = rel[: -len(".__init__")] if rel.endswith(".__init__") else rel
            mod = "" if mod == "__init__" else mod
            try:
                port = importlib.import_module(port_pkg + ("." + mod if mod else ""))
            except ModuleNotFoundError:
                found.append(mod)
                continue
            for kind, name, member, params in public_surface(os.path.join(dirpath, f)):
                obj = getattr(port, name, None)
                if obj is None:
                    if kind in ("func", "class"):
                        found.append(f"{mod}:{name}")
                    continue
                if kind in ("func", "init"):
                    found += [f"{mod}:{name}({p})" for p in _accepts(obj, params)]
                elif kind == "field":
                    if _accepts(obj, [member]):
                        found.append(f"{mod}:{name}.{member}")
                elif kind == "method":
                    if inspect.getattr_static(obj, member, None) is None:
                        found.append(f"{mod}:{name}.{member}")
                    elif params is not None:
                        found += [f"{mod}:{name}.{member}({p})"
                                  for p in _accepts(getattr(obj, member), params)]
    return sorted(found)


def test_every_public_name_of_the_jax_package_is_in_the_port():
    found = gaps(ROOT, "keystone_tpu", "keystone_tpu_torch")
    missing = [k for k in found if k not in DEPARTURES]
    assert not missing, "JAX names the port lacks (add them, or a departure with its reason): " + ", ".join(missing)
    # no departure for what the port now has
    stale = sorted(set(DEPARTURES) - set(found))
    assert not stale, f"departures the port no longer departs from: {stale}"


def test_every_departure_has_its_reason():
    for key, why in DEPARTURES.items():
        assert why.strip() and len(why) > 20, key


def test_the_walk_reports_what_a_port_lacks(tmp_path, monkeypatch):
    """A JAX-style package and a port of it that lacks one of each kind of
    name: the walk reports exactly those."""
    (tmp_path / "src_pkg").mkdir()
    (tmp_path / "src_pkg" / "__init__.py").write_text("")
    (tmp_path / "src_pkg" / "mod.py").write_text(textwrap.dedent('''
        import dataclasses

        def kept(a, b=1): ...
        def dropped(x): ...
        def narrowed(x, mesh=None): ...
        def _private(): ...

        @dataclasses.dataclass
        class Node:
            width: int
            chunk: int = 8
            _hidden: int = 0

            def run(self, x, fast=False): ...

            @property
            def dims(self): ...

            @staticmethod
            def of(data): ...

        class Engine:
            def __init__(self, model, donate=False): ...
            def apply(self, data): ...
    '''))
    (tmp_path / "src_pkg" / "gone.py").write_text("def f(): ...\n")
    (tmp_path / "port_pkg").mkdir()
    (tmp_path / "port_pkg" / "__init__.py").write_text("")
    (tmp_path / "port_pkg" / "mod.py").write_text(textwrap.dedent('''
        import dataclasses

        def kept(a, b=1, c=2): ...
        def narrowed(x): ...

        @dataclasses.dataclass
        class Base:
            def run(self, x): ...

        @dataclasses.dataclass
        class Node(Base):
            width: int

            @staticmethod
            def of(data): ...

        class Engine:
            def __init__(self, model, **kwargs): ...
            def apply(self, data): ...
    '''))
    monkeypatch.syspath_prepend(str(tmp_path))
    got = gaps(str(tmp_path), "src_pkg", "port_pkg")
    assert got == sorted([
        "gone", "mod:dropped", "mod:narrowed(mesh)", "mod:Node.chunk",
        "mod:Node.run(fast)", "mod:Node.dims",
    ]), got
    # and the real package's walk finds names at all
    surface = public_surface(os.path.join(ROOT, "keystone_tpu", "workflow", "api.py"))
    assert ("method", "FittedPipeline", "jit_batch", ["donate"]) in surface
