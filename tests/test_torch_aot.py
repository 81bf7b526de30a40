"""``keystone_tpu_torch/serving/aot.py`` on the CPU, held to the contract
of the JAX package's ``tests/serving/test_aot.py`` and
``test_aot_namespace.py``: a round trip that counts hits and answers bit
for bit as the saving engine (the demo model, and the flagship chain at
48² whose SIFT and LCS operators come back from the store); a corrupt
entry, a probe that disagrees and a planted entry counted as errors and
rebuilt; a meta mismatch rejected before the payload is read; a changed
bucket list or toolchain misses; ``pipeline_token`` and ``bucket_key``;
namespaces, GC and ``namespace_bytes``; kernel libraries taken from the
store in place of ``nvcc``; ``serve-aot-build`` populates then hits; the
counters on a scrape; the configured store and ``/varz``. A CUDA graph
cannot be serialized, so a hit still captures: the JAX contract's "zero
compiles" is the port's "zero operator builds, output checked".

The JAX package's own AOT round trip is not leaned on (it fails in some
environments for an undiagnosed reason; ROADMAP § C)."""

import contextlib
import ctypes.util
import io
import json
import os

import numpy as np
import pytest
import torch

from keystone_tpu.serving import aot as jaot
from keystone_tpu_torch import _cuda
from keystone_tpu_torch.observability import admin
from keystone_tpu_torch.observability.prometheus import render
from keystone_tpu_torch.observability.registry import MetricsRegistry
from keystone_tpu_torch.serving import aot
from keystone_tpu_torch.serving.aot import AotStore
from keystone_tpu_torch.serving.bench import build_pipeline
from keystone_tpu_torch.serving.featurize import (
    build_featurize_pipeline,
    build_flagship_featurize_pipeline,
    pipeline_token,
)

D = 16
EXAMPLE = torch.zeros(D)
FIMG = 48
FLAGSHIP = dict(img=FIMG, desc_dim=8, vocab=8)


@pytest.fixture(scope="module")
def fitted():
    return build_pipeline(d=D, hidden=D, depth=2, device="cpu")


def make_store(tmp_path, namespace=None, registry=None) -> AotStore:
    return AotStore(str(tmp_path / "aot"), registry=registry or MetricsRegistry(),
                    namespace=namespace)


def warm_engine(fitted, store, buckets=(4, 8), featurize=None, example=EXAMPLE, **kw):
    eng = fitted.compiled(buckets=buckets, device="cpu", aot_store=store, featurize=featurize,
                          **kw)
    eng.warmup(example=example)
    return eng


def statuses(engine):
    return {b: v["status"] for b, v in engine.aot_report().items()}


def _images(n, seed=5):
    return torch.as_tensor(np.random.default_rng(seed).integers(0, 256, (n, FIMG, FIMG, 3),
                                                                dtype=np.uint8))


# -- the round trip --------------------------------------------------------


def test_roundtrip_second_engine_hits_and_answers_bitwise(tmp_path, fitted):
    store = make_store(tmp_path)
    e1 = warm_engine(fitted, store)
    assert statuses(e1) == {4: "saved", 8: "saved"}
    e2 = warm_engine(fitted, store)
    assert statuses(e2) == {4: "hit", 8: "hit"}
    assert all(v["load_s"] > 0 for v in e2.aot_report().values())
    assert store.hits == 2 and store.misses == 2 and store.errors == 0 and store.saves == 2
    x = np.random.default_rng(0).standard_normal((5, D)).astype(np.float32)
    assert torch.equal(e1.apply(x), e2.apply(x))


def test_flagship_operators_come_back_from_the_store(tmp_path):
    """The flagship chain: the saving engine's entries hold the SIFT and
    LCS operators and bands; a fresh chain (empty operator caches) gets
    them from the store, in the same dtype and layout, builds none, and
    answers 8 images bit for bit as the saving engine."""
    store = make_store(tmp_path)
    feat, fd = build_flagship_featurize_pipeline(device="cpu", **FLAGSHIP)
    model = build_pipeline(d=fd, hidden=8, depth=2, device="cpu")
    example = torch.zeros((FIMG, FIMG, 3), dtype=torch.uint8)
    e1 = warm_engine(model, store, (2, 8), feat, example)
    assert statuses(e1) == {2: "saved", 8: "saved"}
    saved = e1._export_operators()
    assert sorted(n.split("/")[2] for n in saved) == ["LCSExtractor", "SIFTExtractor"]
    feat2, _ = build_flagship_featurize_pipeline(device="cpu", **FLAGSHIP)
    import keystone_tpu_torch.ops.images.lcs as lcs_mod
    import keystone_tpu_torch.ops.images.sift as sift_mod

    built = []
    real = (sift_mod.scale_operators, lcs_mod.LCSExtractor._make_operators)
    try:
        sift_mod.scale_operators = lambda *a, **k: built.append("sift") or real[0](*a, **k)
        lcs_mod.LCSExtractor._make_operators = (
            lambda self, *a: built.append("lcs") or real[1](self, *a))
        e2 = warm_engine(model, store, (2, 8), feat2, example)
    finally:
        sift_mod.scale_operators, lcs_mod.LCSExtractor._make_operators = real
    assert statuses(e2) == {2: "hit", 8: "hit"} and built == []
    got = e2._export_operators()
    for name, entries in saved.items():
        for key, value in entries.items():
            a, b = _flat(value), _flat(got[name][key])
            assert len(a) == len(b)
            for x, y in zip(a, b):
                if isinstance(x, torch.Tensor):
                    assert x.dtype == y.dtype and x.stride() == y.stride() and torch.equal(x, y)
                else:
                    assert x == y
    imgs = _images(8)
    assert torch.equal(e1.apply(imgs), e2.apply(imgs))


def _flat(tree):
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _flat(t)]
    return [tree]


# -- errors: counted, rebuilt, never raised ----------------------------------


def test_corrupt_entry_counts_error_and_rebuilds(tmp_path, fitted):
    store = make_store(tmp_path)
    e1 = warm_engine(fitted, store)
    for key in store.entries():
        with open(store.path_for(key), "wb") as f:
            f.write(b"not an entry at all")
    e2 = warm_engine(fitted, store)
    assert statuses(e2) == {4: "error", 8: "error"}
    assert {v.get("fallback") for v in e2.aot_report().values()} == {"saved"}
    assert store.errors == 2
    x = np.zeros((3, D), np.float32)
    assert torch.equal(e2.apply(x), e1.apply(x))
    # the cold build repaired the store: the next engine hits
    assert statuses(warm_engine(fitted, store)) == {4: "hit", 8: "hit"}


def test_a_probe_that_disagrees_is_an_error(tmp_path):
    """An entry that loads but whose stored output differs from the
    engine's (here: operators from another chain planted in the entry)
    is counted, and the bucket rebuilds cold with its own operators."""
    store = make_store(tmp_path)
    feat, fd = build_flagship_featurize_pipeline(device="cpu", **FLAGSHIP)
    model = build_pipeline(d=fd, hidden=8, depth=2, device="cpu")
    example = torch.zeros((FIMG, FIMG, 3), dtype=torch.uint8)
    e1 = warm_engine(model, store, (2,), feat, example)
    (key,) = store.entries()
    meta = store.read_meta(key)
    payload, _ = store.load(key, meta)
    for entries in payload["operators"].values():
        for k in entries:
            entries[k] = _scaled(entries[k])
    store.save(key, payload, meta)
    feat2, _ = build_flagship_featurize_pipeline(device="cpu", **FLAGSHIP)
    e2 = warm_engine(model, store, (2,), feat2, example)
    assert statuses(e2) == {2: "error"} and e2.aot_report()[2]["fallback"] == "saved"
    assert store.errors == 1
    imgs = _images(2, seed=9)
    assert torch.equal(e2.apply(imgs), e1.apply(imgs))


def _scaled(tree):
    if isinstance(tree, torch.Tensor):
        return tree * 2 if tree.is_floating_point() else tree
    if isinstance(tree, (list, tuple)):
        return type(tree)(_scaled(t) for t in tree)
    return tree


def test_meta_mismatch_rejected_before_the_payload_is_read(tmp_path, fitted, monkeypatch):
    store = make_store(tmp_path)
    warm_engine(fitted, store)
    key = store.entries()[0]
    stored = store.read_meta(key)
    assert stored is not None and stored["model_token"] == pipeline_token(fitted)
    loads = []
    real_load = torch.load
    monkeypatch.setattr(torch, "load", lambda *a, **k: loads.append(1) or real_load(*a, **k))
    payload, outcome = store.load(key, dict(stored, model_token="someone-else"))
    assert payload is None and outcome == "error" and loads == []
    assert store.errors == 1
    payload, outcome = store.load(key, stored)
    assert outcome == "hit" and loads == [1] and set(payload) == {"operators", "output"}


def test_planted_entry_of_another_featurizer_is_rejected(tmp_path):
    feat1, fd = build_featurize_pipeline(img=8, filters=4, conv_size=3, pool_stride=4,
                                         pool_size=4, seed=3, device="cpu")
    feat2, _ = build_featurize_pipeline(img=8, filters=4, conv_size=3, pool_stride=4,
                                        pool_size=4, seed=4, device="cpu")
    model = build_pipeline(d=fd, hidden=8, depth=2, device="cpu")
    store = make_store(tmp_path)
    example = torch.zeros((8, 8, 3), dtype=torch.uint8)
    e1 = warm_engine(model, store, (4,), feat1, example)
    raw = torch.as_tensor(np.random.default_rng(5).integers(0, 256, (3, 8, 8, 3), dtype=np.uint8))
    assert statuses(warm_engine(model, store, (4,), feat1, example)) == {4: "hit"}
    e3 = warm_engine(model, store, (4,), feat2, example)
    assert statuses(e3) == {4: "saved"}  # never feat1's entry
    assert not torch.equal(e3.apply(raw), e1.apply(raw))
    # feat1's entry planted at feat2's key: rejected off the stored meta
    ident = aot.runtime_identity("cpu")
    keys = [aot.bucket_key([((8, 8, 3), torch.uint8)], (4,), 4, False, False,
                           pipeline_token(model), ident, featurize_token=pipeline_token(f))[0]
            for f in (feat1, feat2)]
    with open(store.path_for(keys[0]), "rb") as src, open(store.path_for(keys[1]), "wb") as dst:
        dst.write(src.read())
    e4 = warm_engine(model, store, (4,), feat2, example)
    assert statuses(e4) == {4: "error"} and store.errors == 1
    assert torch.equal(e4.apply(raw), e3.apply(raw))


def test_changed_bucket_list_and_toolchain_miss(tmp_path, fitted, monkeypatch):
    store = make_store(tmp_path)
    warm_engine(fitted, store, (4, 8))
    assert statuses(warm_engine(fitted, store, (4, 16))) == {4: "saved", 16: "saved"}
    assert store.misses == 4 and store.errors == 0
    real = aot.runtime_versions()
    for field in ("torch", "cuda_runtime", "nvcc", "kernel_sources"):
        monkeypatch.setattr(aot, "runtime_versions", lambda f=field: dict(real, **{f: "other"}))
        assert statuses(warm_engine(fitted, store, (4, 8))) == {4: "saved", 8: "saved"}, field
    monkeypatch.setattr(aot, "device_identity",
                        lambda device=None: {"backend": "cuda", "device_kind": "other",
                                             "compute_capability": "9.0", "device_count": 1})
    assert statuses(warm_engine(fitted, store, (4, 8))) == {4: "saved", 8: "saved"}
    assert store.hits == 0 and store.errors == 0


def test_a_kernel_edit_changes_the_identity(tmp_path, monkeypatch):
    before = aot.runtime_identity("cpu")["kernel_sources"]
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in os.listdir(_cuda.CSRC_DIR):
        (csrc / name).write_bytes(open(os.path.join(_cuda.CSRC_DIR, name), "rb").read())
    monkeypatch.setattr(_cuda, "CSRC_DIR", str(csrc))
    assert aot.runtime_identity("cpu")["kernel_sources"] == before
    (csrc / "sandwich.cu").write_bytes((csrc / "sandwich.cu").read_bytes() + b"\n// edit\n")
    assert aot.runtime_identity("cpu")["kernel_sources"] != before


# -- fingerprints ----------------------------------------------------------------


def test_pipeline_token_stable_across_use_and_distinguishes_weights_and_wiring():
    f1 = build_pipeline(d=8, hidden=8, depth=1, device="cpu")
    before = aot.pipeline_token(f1)
    assert aot.pipeline_token is pipeline_token  # the one token, from featurize.py
    del f1._pipeline_token
    eng = f1.compiled((2,), device="cpu", aot_store=False)
    eng.warmup(example=torch.zeros(8))
    assert aot.pipeline_token(f1) == before
    assert aot.pipeline_token(build_pipeline(d=8, hidden=8, depth=2, device="cpu")) != before
    assert aot.pipeline_token(build_pipeline(d=8, hidden=8, depth=1, seed=1, device="cpu")) != before
    from keystone_tpu_torch.workflow.api import FittedPipeline, Identity
    from keystone_tpu_torch.workflow.graph import Graph

    g0 = Graph(sources=frozenset(), sink_dependencies={}, operators={}, dependencies={})
    g0, src = g0.add_source()
    g0, a = g0.add_node(Identity(), [src])
    g1, j1 = g0.add_node(Identity(), [a, src])
    g1, sink1 = g1.add_sink(j1)
    g2, j2 = g0.add_node(Identity(), [a, a])
    g2, sink2 = g2.add_sink(j2)
    p1, p2 = FittedPipeline(g1, src, sink1), FittedPipeline(g2, src, sink2)
    assert aot.pipeline_token(p1) != aot.pipeline_token(p2)
    g3, sink3 = g2.add_sink(a)
    assert aot.pipeline_token(FittedPipeline(g3, src, sink3)) != aot.pipeline_token(p2)
    import hashlib

    def tok(v):
        h = hashlib.sha256()
        aot._hash_update(h, v)
        return h.hexdigest()

    assert tok([1, 23]) != tok([12, 3]) and tok([[1], 2]) != tok([[1, 2]])


def test_bucket_key_varies_by_every_field():
    """JAX's fields, with the same stamped-only-when-set discipline for
    the featurize token, the sharding token and the namespace."""
    specs = [((D,), np.float32)]
    args = dict(specs=specs, buckets=(4, 8), bucket=4, donate=False, shard=False,
                model_token="m", identity={"torch": "t"})
    base, base_meta = aot.bucket_key(**args)
    for kwargs in (dict(buckets=(4, 16)), dict(bucket=8), dict(donate=True), dict(shard=True),
                   dict(model_token="other"), dict(identity={"torch": "u"}),
                   dict(specs=[((D,), np.float64)]), dict(specs=[((D + 1,), np.float32)]),
                   dict(featurize_token="f"), dict(sharding_token="s"), dict(namespace="n")):
        key, _ = aot.bucket_key(**dict(args, **kwargs))
        assert key != base, f"fingerprint ignored {kwargs}"
    assert not {"featurize_token", "sharding_token", "namespace"} & set(base_meta)
    # a torch dtype and its numpy name key alike; JAX's meta spells specs the same way
    assert aot.bucket_key(**dict(args, specs=[((D,), torch.float32)]))[0] == base
    jmeta = jaot.bucket_key(specs, (4, 8), 4, donate=False, shard=False, model_token="m",
                            identity={}, featurize_token="f", sharding_token="s",
                            namespace="n")[1]
    tmeta = aot.bucket_key(specs, (4, 8), 4, donate=False, shard=False, model_token="m",
                           identity={}, featurize_token="f", sharding_token="s",
                           namespace="n")[1]
    assert {k: v for k, v in tmeta.items() if k != "format"} == {
        k: v for k, v in jmeta.items() if k != "format"}


def test_sharded_and_replicated_engines_never_share(tmp_path, fitted):
    store = make_store(tmp_path)
    plain = warm_engine(fitted, store)
    sharded = warm_engine(fitted, store, param_sharding=True)
    assert statuses(sharded) == {4: "saved", 8: "saved"} and len(store.entries()) == 4
    assert statuses(warm_engine(fitted, store, param_sharding=True)) == {4: "hit", 8: "hit"}
    metas = [store.read_meta(k) for k in store.entries()]
    assert sum("sharding_token" in m for m in metas) == 2
    x = np.ones((2, D), np.float32)
    assert torch.equal(plain.apply(x), sharded.apply(x))


# -- namespaces and GC --------------------------------------------------------------


def _stamp(store, keys):
    for i, key in enumerate(keys):
        os.utime(store.path_for(key), (1_700_000_000 + i,) * 2)


def test_namespaces_gc_and_bytes(tmp_path, fitted):
    reg = MetricsRegistry()
    a = make_store(tmp_path, namespace="a", registry=reg)
    b = make_store(tmp_path, namespace="b", registry=reg)
    warm_engine(fitted, a, (2, 4, 8))
    warm_engine(fitted, b, (2, 4))
    assert len(a.entries()) == 5  # one directory, two namespaces
    keys_a = [k for k in a.entries() if a.read_meta(k)["namespace"] == "a"]
    _stamp(a, keys_a)
    size = os.path.getsize(a.path_for(keys_a[0]))
    assert a.namespace_bytes() == sum(os.path.getsize(a.path_for(k)) for k in keys_a)
    # pinned entries survive any budget; the oldest go first; b is untouched
    report = a.gc(size, pinned=[keys_a[0]])
    assert report["evicted"] == keys_a[1:] and report["kept_bytes"] == size
    assert not report["over_budget"]
    assert b.namespace_bytes() > 0 and len(b.entries()) == 3
    report = a.gc(0, pinned=[keys_a[0]])
    assert report["evicted"] == [] and report["over_budget"]
    text = render(reg.collect())
    assert 'keystone_aot_store_bytes{namespace="a"}' in text
    assert 'keystone_aot_store_bytes{namespace="b"}' in text
    # a's entries never load through b: the namespace is in the key and the meta
    assert statuses(warm_engine(fitted, b, (2, 4, 8)))[8] == "saved"


# -- kernel libraries ------------------------------------------------------------------


def test_libraries_come_from_the_store_in_place_of_nvcc(tmp_path, monkeypatch):
    """A build directory without the libraries takes them from the store
    (here a shared object of the host stands in for a built kernel
    library); one that does not load is removed and counted, so that
    nvcc builds it at first use."""
    libc = ctypes.util.find_library("c")
    path = next(p for p in (f"/lib/x86_64-linux-gnu/{libc}", f"/usr/lib/x86_64-linux-gnu/{libc}",
                            f"/lib64/{libc}", f"/usr/lib64/{libc}") if os.path.exists(p))
    first = tmp_path / "build1"
    first.mkdir()
    monkeypatch.setattr(_cuda, "BUILD_DIR", str(first))
    with open(path, "rb") as src:
        so = src.read()
    for name in ("sift_bin", "sandwich"):
        with open(_cuda.library_path(name), "wb") as f:
            f.write(so)
    store = make_store(tmp_path)
    assert aot.save_libraries(store) == {"sift_bin": True, "sandwich": True}
    assert store.library_saves == 2 and len(store.library_entries()) == 2
    second = tmp_path / "build2"
    monkeypatch.setattr(_cuda, "BUILD_DIR", str(second))
    got = aot.install_libraries(store)
    assert got == {"sift_bin": "loaded", "sandwich": "loaded", "fv_stats": "miss"}
    assert os.path.exists(_cuda.library_path("sift_bin")) and store.library_loads == 2
    assert aot.install_libraries(store)["sift_bin"] == "local"
    # a stored library that does not load: counted, removed, left to nvcc
    key, meta = aot.library_key("sift_bin")
    with open(store.library_path_for(key), "wb") as f:
        f.write(aot._pack(meta, b"\x7fELF but not a library"))
    monkeypatch.setattr(_cuda, "BUILD_DIR", str(tmp_path / "build3"))
    got = aot.install_libraries(store)
    assert got["sift_bin"] == "error" and got["sandwich"] == "loaded"
    assert not os.path.exists(_cuda.library_path("sift_bin")) and store.errors == 1
    # another nvcc build, or an edited source, keys another library
    stored = aot.library_key("sandwich")[0]
    monkeypatch.setattr(_cuda, "nvcc_version", lambda: "Build cuda_99")
    monkeypatch.setattr(_cuda, "BUILD_DIR", str(tmp_path / "build4"))
    assert aot.library_key("sandwich")[0] != stored
    assert aot.install_libraries(store)["sandwich"] == "miss"


# -- the CLI, the scrape, the configured store ------------------------------------------


def test_build_main_populates_then_hits(tmp_path, monkeypatch):
    monkeypatch.delenv("KEYSTONE_AOT_CACHE", raising=False)
    argv = ["--buckets", "2,4", "--d", "8", "--hidden", "8", "--depth", "2",
            "--aot-cache", str(tmp_path / "built")]
    reports = []
    for _ in range(2):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert aot.build_main(argv, device="cpu") == 0
        reports.append(json.loads(out.getvalue().strip().splitlines()[-1]))
    assert {v["status"] for v in reports[0]["aot"].values()} == {"saved"}
    assert {v["status"] for v in reports[1]["aot"].values()} == {"hit"}
    assert reports[1]["entries"] == 2 and reports[1]["dir"] == str(tmp_path / "built")
    # the flagship gateway's chain, as serve-gateway --device-featurize flagship builds it
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert aot.build_main(["--buckets", "2", "--device-featurize", "flagship", "--img", "48",
                               "--aot-cache", str(tmp_path / "flag")], device="cpu") == 0
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    assert report["aot"] == {"2": {"status": "saved"}} or report["aot"] == {2: {"status": "saved"}}


def test_metrics_families_on_scrape(tmp_path, fitted):
    reg = MetricsRegistry()
    store = make_store(tmp_path, registry=reg)
    warm_engine(fitted, store)
    warm_engine(fitted, store)
    text = render(reg.collect())
    for family, value in (("keystone_aot_cache_hits_total", 2), ("keystone_aot_cache_misses_total", 2),
                          ("keystone_aot_cache_errors_total", 0)):
        assert f"# TYPE {family} counter" in text, family
        got = sum(float(ln.split()[-1]) for ln in text.splitlines() if ln.startswith(family + " "))
        assert got == value, (family, got)
    assert "keystone_aot_cache_load_seconds_count 2" in text


def test_configured_store_and_varz_status(tmp_path, monkeypatch, fitted):
    monkeypatch.setattr(aot, "_aot_dir", None)
    monkeypatch.setattr(aot, "_configured", None)
    assert aot.configured_store() is None and aot.status() == {"dir": None}
    assert admin.build_info()["aot_cache"] == {"dir": None}
    monkeypatch.setenv("KEYSTONE_AOT_CACHE", str(tmp_path / "env"))
    assert aot.setup_aot_cache() == str(tmp_path / "env")
    assert aot.setup_aot_cache(str(tmp_path / "arg")) == str(tmp_path / "arg")
    monkeypatch.delenv("KEYSTONE_AOT_CACHE")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert aot.setup_aot_cache() == str(tmp_path / "home" / ".cache" / "keystone_tpu_torch" / "aot")
    store = aot.configured_store()
    assert store is not None and store is aot.configured_store()
    eng = warm_engine(fitted, "auto")
    assert statuses(eng) == {4: "saved", 8: "saved"}
    varz = admin.build_info()["aot_cache"]
    assert varz["dir"] == store.root and varz["entries"] == 2 and varz["saves"] == 2
    ns = aot.namespaced_store("model-a")
    assert ns.namespace == "model-a" and ns.root == store.root
    # an engine without a store, or with it off, reports nothing
    assert warm_engine(fitted, False).aot_report() == {}
