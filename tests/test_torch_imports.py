"""The port stands alone: importing every module of ``keystone_tpu_torch``
(and ``chip_smoke.py``) pulls in neither ``jax`` nor ``keystone_tpu``,
no source imports them, and the entry points run on CUDA unless the
caller names the CPU."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "keystone_tpu_torch")
# the training slice's new modules, which the walk must reach
TRAINING_MODULES = [
    "keystone_tpu_torch." + m for m in (
        "loaders.image_loaders", "ops.util.cacher", "ops.learning.cost",
        "parallel.linalg", "ops.learning.kmeans", "ops.learning.weighted_ls",
        "pipelines.images.imagenet_sift_lcs_fv", "utils.chunks",
    )
]
# the serving slice's new modules, which the walk must reach too
SERVING_MODULES = [
    "keystone_tpu_torch." + m for m in (
        "utils.profiling", "observability.registry", "observability.prometheus",
        "observability.device", "loadgen", "loadgen.faults", "serving.metrics",
        "serving.pipeline", "serving.batching", "serving.autoscale",
    )
]


# the real-image-files slice's new modules, which the walk must reach too
LOADER_MODULES = [
    "keystone_tpu_torch." + m for m in ("native", "loaders.streaming", "utils.lru")
]


# the VOC slice's new modules, which the walk must reach too
VOC_MODULES = [
    "keystone_tpu_torch." + m for m in (
        "utils.checkpoint", "ops.learning.hostsolve", "ops.learning.block_ls",
        "evaluation", "evaluation.multiclass", "evaluation.binary",
        "evaluation.mean_average_precision", "evaluation.augmented",
        "workflow.chain_utils", "pipelines.images.voc_sift_fisher",
    )
]


# the random-features slice's new modules, which the walk must reach too
RANDOM_FEATURES_MODULES = [
    "keystone_tpu_torch." + m for m in (
        "loaders.cifar", "loaders.csv_loader", "ops.learning.zca", "ops.learning.linear",
        "ops.learning.kernel", "pipelines.images.random_patch_cifar",
        "pipelines.images.mnist_random_fft", "pipelines.images.cifar_apps",
    )
]


# the fit-memory and TIMIT slice's new modules, which the walk must reach too
HOST_FIT_MODULES = [
    "keystone_tpu_torch." + m for m in (
        "workflow.auto_cache", "loaders.text_loaders", "pipelines.speech",
        "pipelines.speech.timit",
    )
]


# the text slice's new modules, which the walk must reach too
TEXT_MODULES = [
    "keystone_tpu_torch." + m for m in (
        "ops.nlp", "ops.nlp.string_utils", "ops.nlp.ngrams", "ops.nlp.hashing_tf",
        "ops.learning.lbfgs", "ops.learning.classifiers", "ops.learning.sparse_ell",
        "ops.learning.least_squares", "pipelines.text", "pipelines.text.newsgroups",
        "pipelines.text.amazon_reviews", "utils.gcpause",
    )
]


# the last app's and the remaining operators' modules, which the walk must
# reach too
SLICE12_MODULES = [
    "keystone_tpu_torch." + m for m in (
        "__main__", "ops.nlp.word_frequency", "ops.nlp.stupid_backoff", "ops.nlp.tagging",
        "ops.nlp.external", "ops.nlp.crf", "ops.images.conversions", "ops.images.daisy",
        "ops.images.hog", "ops.images.image_utils", "parallel.shuffle", "pipelines.nlp",
        "pipelines.nlp.stupid_backoff_pipeline",
    )
]


# the request plane's front door, which the walk must reach too
GATEWAY_MODULES = [
    "keystone_tpu_torch." + m for m in (
        "gateway", "gateway.admission", "gateway.metrics", "gateway.pool",
        "gateway.lifecycle", "gateway.http", "observability.httpd", "observability.admin",
        "observability.flight", "observability.slo", "observability.profilez",
        "serving.bench",
    )
]


# the fleet tier's and the model zoo's modules, which the walk must reach too
FLEET_ZOO_MODULES = [
    "keystone_tpu_torch." + m for m in (
        "fleet", "fleet.registry", "fleet.client", "fleet.router", "zoo", "zoo.registry",
        "zoo.optimizer", "zoo.cse", "zoo.host", "observability.otlp", "observability.stitch",
        "observability.attribution", "observability.drift",
    )
]


# the load generator's and the online lifecycle's modules, which the walk
# must reach too
LOADGEN_LIFECYCLE_MODULES = [
    "keystone_tpu_torch." + m for m in (
        "loadgen.trace", "loadgen.runner", "loadgen.invariants", "loadgen.cli", "lifecycle",
        "lifecycle.policy", "lifecycle.teacher", "lifecycle.metrics", "lifecycle.routes",
        "lifecycle.refit", "lifecycle.controller", "lifecycle.manager", "lifecycle.cli",
    )
]


# the AOT store's, sharding's and the autoscaler's modules, which the walk
# must reach too
AOT_SHARDING_AUTOSCALE_MODULES = [
    "keystone_tpu_torch." + m for m in (
        "serving.aot", "serving.sharding", "autoscale", "autoscale.policy",
        "autoscale.controller", "autoscale.supervisor", "autoscale.planner", "autoscale.cli",
    )
]


def _port_sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_importing_every_module_loads_no_jax():
    code = f"""
import importlib, importlib.util, pkgutil, sys
sys.path.insert(0, {ROOT!r})
import keystone_tpu_torch
for m in pkgutil.walk_packages(keystone_tpu_torch.__path__, "keystone_tpu_torch."):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", {os.path.join(ROOT, "chip_smoke.py")!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "keystone_tpu"
             or n.startswith("keystone_tpu."))
print("LOADED", len([n for n in sys.modules if n.startswith("keystone_tpu_torch")]))
print("BAD", bad)
print("TRAINING", sorted(n for n in {TRAINING_MODULES!r} if n not in sys.modules))
print("SERVING", sorted(n for n in {SERVING_MODULES!r} if n not in sys.modules))
print("LOADERS", sorted(n for n in {LOADER_MODULES!r} if n not in sys.modules))
print("VOC", sorted(n for n in {VOC_MODULES!r} if n not in sys.modules))
print("RF", sorted(n for n in {RANDOM_FEATURES_MODULES!r} if n not in sys.modules))
print("HOSTFIT", sorted(n for n in {HOST_FIT_MODULES!r} if n not in sys.modules))
print("TEXT", sorted(n for n in {TEXT_MODULES!r} if n not in sys.modules))
print("SLICE12", sorted(n for n in {SLICE12_MODULES!r} if n not in sys.modules))
print("GATEWAY", sorted(n for n in {GATEWAY_MODULES!r} if n not in sys.modules))
print("FLEETZOO", sorted(n for n in {FLEET_ZOO_MODULES!r} if n not in sys.modules))
print("LOADGENLIFECYCLE", sorted(n for n in {LOADGEN_LIFECYCLE_MODULES!r} if n not in sys.modules))
print("AOTSHARDAUTOSCALE", sorted(n for n in {AOT_SHARDING_AUTOSCALE_MODULES!r}
                                  if n not in sys.modules))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=ROOT, env=env,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert "TRAINING []" in out.stdout, out.stdout
    assert "SERVING []" in out.stdout, out.stdout
    assert "LOADERS []" in out.stdout, out.stdout
    assert "VOC []" in out.stdout, out.stdout
    assert "RF []" in out.stdout, out.stdout
    assert "HOSTFIT []" in out.stdout, out.stdout
    assert "TEXT []" in out.stdout, out.stdout
    assert "SLICE12 []" in out.stdout, out.stdout
    assert "GATEWAY []" in out.stdout, out.stdout
    assert "FLEETZOO []" in out.stdout, out.stdout
    assert "LOADGENLIFECYCLE []" in out.stdout, out.stdout
    assert "AOTSHARDAUTOSCALE []" in out.stdout, out.stdout
    assert int(re.search(r"LOADED (\d+)", out.stdout).group(1)) >= (
        25 + len(TRAINING_MODULES) + len(SERVING_MODULES) + len(LOADER_MODULES)
        + len(VOC_MODULES) + len(RANDOM_FEATURES_MODULES) + len(HOST_FIT_MODULES)
        + len(TEXT_MODULES) + len(SLICE12_MODULES) + len(GATEWAY_MODULES)
        + len(FLEET_ZOO_MODULES) + len(LOADGEN_LIFECYCLE_MODULES)
        + len(AOT_SHARDING_AUTOSCALE_MODULES))


def test_importing_the_gateway_loads_no_jax_and_starts_no_cuda():
    """``import keystone_tpu_torch.gateway`` (and the admin endpoint)
    neither loads JAX nor initialises CUDA: a card is touched only when
    an engine is built on it."""
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
import torch
import keystone_tpu_torch.gateway
import keystone_tpu_torch.observability
from keystone_tpu_torch.gateway.http import main
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "keystone_tpu"))
print("BAD", bad, "CUDA", torch.cuda.is_initialized())
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=ROOT, env=env,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD [] CUDA False" in out.stdout, out.stdout


def test_importing_the_fleet_and_the_zoo_loads_no_jax_and_starts_no_cuda():
    """The router, the zoo and their observability import without JAX or
    a CUDA context; a spec file loads into a registry without touching a
    device (params materialize at page-in)."""
    code = f"""
import json, sys, tempfile
sys.path.insert(0, {ROOT!r})
import torch
import keystone_tpu_torch.fleet, keystone_tpu_torch.zoo
from keystone_tpu_torch.fleet.router import main
from keystone_tpu_torch.observability import OtlpSpanExporter, TraceStitcher, DriftDetector
from keystone_tpu_torch.zoo import load_zoo_spec
path = tempfile.mktemp(suffix=".json")
json.dump({{"models": [{{"name": "m", "device_featurize": "flagship", "img": 256}}]}}, open(path, "w"))
reg = load_zoo_spec(path)
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "keystone_tpu"))
print("BAD", bad, "CUDA", torch.cuda.is_initialized(), "IDS", reg.ids())
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=ROOT, env=env,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD [] CUDA False IDS ('m',)" in out.stdout, out.stdout


def test_aot_sharding_and_autoscale_load_no_jax_and_start_no_cuda():
    """The AOT store, sharding and the autoscaler import without JAX,
    ``keystone_tpu`` or a CUDA context; ``keystone_tpu_torch.autoscale``
    loads no submodule until one of its names is used, as in JAX."""
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
import torch
import keystone_tpu_torch
import keystone_tpu_torch.autoscale as autoscale
print("LAZY", sorted(n for n in sys.modules if n.startswith("keystone_tpu_torch.autoscale.")))
import keystone_tpu_torch.serving.aot, keystone_tpu_torch.serving.sharding
autoscale.PolicyEngine, autoscale.Supervisor, autoscale.Autoscaler
import keystone_tpu_torch.autoscale.planner, keystone_tpu_torch.autoscale.cli
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "keystone_tpu"))
print("BAD", bad, "CUDA", torch.cuda.is_initialized())
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=ROOT, env=env,
    )
    assert out.returncode == 0, out.stderr
    assert "LAZY []" in out.stdout, out.stdout
    assert "BAD [] CUDA False" in out.stdout, out.stdout


def test_loadgen_loads_only_faults_and_the_lifecycle_cli_no_torch():
    """A serving process imports ``keystone_tpu_torch.loadgen`` for its
    fault points alone: the driver half (trace, runner, invariants, cli)
    resolves lazily, as in the JAX package. ``serve-lifecycle``'s client
    imports neither torch nor jax."""
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
import keystone_tpu_torch.loadgen as lg
import keystone_tpu_torch.lifecycle.cli
half = sorted(m for m in ("trace", "runner", "invariants", "cli")
              if "keystone_tpu_torch.loadgen." + m in sys.modules)
print("EAGER", half, "FAULTS", "keystone_tpu_torch.loadgen.faults" in sys.modules,
      "TORCH", "torch" in sys.modules)
lg.LoadGenerator, lg.InvariantChecker, lg.trace
print("LAZY", "keystone_tpu_torch.loadgen.runner" in sys.modules,
      "keystone_tpu_torch.loadgen.invariants" in sys.modules)
try:
    lg.nothing_here
except AttributeError:
    print("MISSING ok")
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "keystone_tpu"))
print("BAD", bad)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=ROOT, env=env,
    )
    assert out.returncode == 0, out.stderr
    assert "EAGER [] FAULTS True TORCH False" in out.stdout, out.stdout
    assert "LAZY True True" in out.stdout and "MISSING ok" in out.stdout, out.stdout
    assert "BAD []" in out.stdout, out.stdout


def test_streaming_loader_imports_neither_torch_nor_jax():
    """Spawned decode workers unpickle ``_decode_payload`` from the
    streaming module and load the native decoder: neither may pull in
    torch or jax."""
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
import keystone_tpu_torch.loaders.streaming as s
import keystone_tpu_torch.native
s._decode_payload((b"not a jpeg", None))
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("torch", "jax", "keystone_tpu"))
print("BAD", bad)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=ROOT, env=env,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_the_lint_and_bench_diff_entries_load_neither_torch_nor_jax(tmp_path):
    """``python -m keystone_tpu_torch keystone-lint --json`` and
    ``bench-diff`` run (neither says "not ported"), and the entry's
    dispatch to them loads no ``torch``, ``jax`` or ``keystone_tpu``."""
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    a.write_text('{"metric": "B1_ms", "value": 1.0, "unit": "ms"}\n')
    b.write_text('{"metric": "B1_ms", "value": 2.0, "unit": "ms"}\n')
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    lint = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", "keystone-lint", "--json"],
        capture_output=True, text=True, timeout=120, cwd=ROOT, env=env,
    )
    assert lint.returncode == 0, lint.stdout + lint.stderr
    assert json.loads(lint.stdout)["clean"] is True
    diff = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", "bench-diff", str(a), str(b)],
        capture_output=True, text=True, timeout=120, cwd=ROOT, env=env,
    )
    assert diff.returncode == 1 and "REGRESSED B1_ms" in diff.stdout, diff.stdout + diff.stderr
    for out in (lint, diff):
        assert "not ported" not in out.stdout + out.stderr
    code = f"""
import runpy, sys
sys.path.insert(0, {ROOT!r})
rcs = []
for argv in (["keystone-lint", "--json"], ["bench-diff", {str(a)!r}, {str(b)!r}]):
    sys.argv = ["keystone_tpu_torch"] + argv
    try:
        runpy.run_module("keystone_tpu_torch", run_name="__main__")
    except SystemExit as e:
        rcs.append(e.code)
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("torch", "jax", "keystone_tpu"))
print("RCS", rcs, "BAD", bad)
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=ROOT, env=env,
    )
    assert out.returncode == 0, out.stderr
    assert "RCS [0, 1] BAD []" in out.stdout, out.stdout[-2000:]


def test_no_source_imports_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(from|import)\s+(jax|keystone_tpu)(\.|\s|$)", re.M)
    offenders = [p for p in _port_sources() if pat.search(open(p).read())]
    assert offenders == []


def test_entry_points_need_cuda_unless_given_the_cpu(monkeypatch):
    from keystone_tpu_torch import convert
    from keystone_tpu_torch.serving import MicroBatcher, ServingMetrics
    from keystone_tpu_torch.serving.engine import CompiledPipeline
    from keystone_tpu_torch.serving.featurize import (
        build_flagship_featurize_pipeline,
        flagship_pipeline,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_flagship_featurize_pipeline(img=40, desc_dim=4, vocab=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        flagship_pipeline(np.random.default_rng(0), 4, 2)
    flagship_pipeline(np.random.default_rng(0), 4, 2, device="cpu")
    feat, _ = build_flagship_featurize_pipeline(
        img=40, desc_dim=4, vocab=2, device="cpu"
    )
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CompiledPipeline(feat, (4,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        feat.compiled((4,))
    assert CompiledPipeline(feat, (4,), device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.flagship_from_numpy({})
    with pytest.raises(ValueError, match="unsupported device"):
        CompiledPipeline(feat, (4,), device="meta")
    out = CompiledPipeline(feat, (4,), device="cpu").apply(
        np.zeros((1, 40, 40, 3), np.uint8)
    )
    assert out.shape == (1, 2 * 2 * 4 * 2) and bool(torch.isfinite(out).all())
    # the micro-batcher serves through an engine, so it needs one made on
    # the CPU as well
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MicroBatcher(feat.compiled((4,), metrics=ServingMetrics()))
    for depth in (0, 2):
        mb = MicroBatcher(feat.compiled((4,), device="cpu"), pipeline_depth=depth)
        try:
            row = mb.submit(np.zeros((40, 40, 3), np.uint8)).result(timeout=60)
        finally:
            mb.close()
        assert isinstance(row, np.ndarray) and row.shape == (2 * 2 * 4 * 2,)

    # the random-features apps and the dense-conv serving chain
    from keystone_tpu_torch.pipelines.images import cifar_apps, mnist_random_fft, random_patch_cifar
    from keystone_tpu_torch.serving.featurize import build_featurize_pipeline

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_featurize_pipeline()
    conv, dim = build_featurize_pipeline(device="cpu")
    assert conv._batch_run(torch.zeros((2, 16, 16, 3), dtype=torch.uint8)).shape == (2, dim)
    train, test = random_patch_cifar.synthetic_cifar(n_train=24, n_test=8)
    rpc = random_patch_cifar.RandomCifarConfig(num_filters=4, patch_steps=8, lam=10.0)
    mtrain, mtest = mnist_random_fft.synthetic_mnist(n_train=16, n_test=8)
    mconf = mnist_random_fft.MnistRandomFFTConfig(num_ffts=1, block_size=512, lam=10.0)
    kconf = cifar_apps.RandomCifarKernelConfig(num_filters=4, patch_steps=8, block_size=8)
    aconf = cifar_apps.RandomCifarAugmentedConfig(num_filters=4, patch_steps=8, augment_copies=2)
    akconf = cifar_apps.RandomCifarAugmentedKernelConfig(num_filters=4, patch_steps=8,
                                                         augment_copies=2, block_size=8)
    calls = [
        lambda **kw: random_patch_cifar.run(train, test, rpc, **kw),
        lambda **kw: random_patch_cifar.build_pipeline(train, rpc, **kw),
        lambda **kw: random_patch_cifar.main(["--numFilters", "4", "--patchSteps", "8"], **kw),
        lambda **kw: mnist_random_fft.run(mtrain, mtest, mconf, **kw),
        lambda **kw: mnist_random_fft.build_pipeline(mtrain, mconf, **kw),
        lambda **kw: mnist_random_fft.main(["--numFFTs", "1", "--blockSize", "512"], **kw),
        lambda **kw: cifar_apps.linear_pixels(train, test, **kw),
        lambda **kw: cifar_apps.random_cifar(train, test, num_filters=4, **kw),
        lambda **kw: cifar_apps.random_patch_cifar_kernel(train, test, kconf, **kw),
        lambda **kw: cifar_apps.random_patch_cifar_augmented(train, test, aconf, **kw),
        lambda **kw: cifar_apps.random_patch_cifar_augmented_kernel(train, test, akconf, **kw),
        lambda **kw: convert.random_patch_cifar_from_numpy({}, **kw),
        lambda **kw: convert.mnist_random_fft_from_numpy({}, **kw),
        lambda **kw: convert.krr_from_numpy({}, **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    for call in calls[:3] + calls[3:6]:
        out = call(device="cpu")
        assert out == 0 or out is not None


def test_training_entry_points_need_cuda_unless_given_the_cpu(monkeypatch):
    from keystone_tpu_torch.loaders.image_loaders import LabeledImage
    from keystone_tpu_torch.ops.images.lcs import LCSExtractor
    from keystone_tpu_torch.ops.learning.gmm import GaussianMixtureModel
    from keystone_tpu_torch.parallel.dataset import Dataset
    from keystone_tpu_torch.pipelines.images.imagenet_sift_lcs_fv import (
        ImageNetSiftLcsFVConfig,
        LabelExtractor,
        build_pipeline,
        compute_pca_and_fisher_branch,
        run,
    )
    from keystone_tpu_torch.serving.featurize import (
        build_flagship_featurize_pipeline,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (4, 40, 40, 3), dtype=np.uint8)
    data = Dataset.from_items([LabeledImage(im, i % 2) for i, im in enumerate(images)])
    conf = ImageNetSiftLcsFVConfig(
        desc_dim=4, vocab_size=2, num_classes=2, lcs_stride=8,
        num_pca_samples_per_image=8, num_gmm_samples_per_image=8,
    )
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(data, data, conf)
    # host data, as a loader yields it
    host_images = Dataset.from_items(list(images))
    labels = LabelExtractor.apply(data)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_pipeline(host_images, labels, conf)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compute_pca_and_fisher_branch(
            LCSExtractor(8, 16, 6).to_pipeline(), host_images, conf, None, None)
    pred = build_pipeline(host_images, labels, conf, device="cpu")
    top = pred.fit()(Dataset.from_array(torch.as_tensor(images))).array()
    assert top.shape[0] == 4 and top.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_flagship_featurize_pipeline(img=40, desc_dim=4, vocab=2, fit_images=images)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GaussianMixtureModel.load("m.csv", "v.csv", "w.csv")
    feat, dim = build_flagship_featurize_pipeline(
        img=40, desc_dim=4, vocab=2, fit_images=images, device="cpu"
    )
    out = feat._batch_run(torch.as_tensor(images))
    assert out.shape == (4, dim) and bool(torch.isfinite(out).all())
    _, err = run(data, data, conf, device="cpu")
    assert 0.0 <= err <= 1.0


def test_voc_entry_points_need_cuda_unless_given_the_cpu(monkeypatch, tmp_path):
    from keystone_tpu_torch import convert
    from keystone_tpu_torch.loaders.image_loaders import LabeledImage
    from keystone_tpu_torch.ops.stats.nodes import NormalizeRows
    from keystone_tpu_torch.parallel.dataset import Dataset
    from keystone_tpu_torch.pipelines.images import voc_sift_fisher as voc
    from keystone_tpu_torch.workflow.api import FittedPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    items = []
    for i in range(6):
        li = LabeledImage(rng.integers(0, 256, (40, 48, 3)).astype(np.float32), -1)
        li.labels = [i % 3, (i + 1) % 3]
        items.append(li)
    data = Dataset.from_items(items)
    conf = voc.SIFTFisherConfig(desc_dim=4, vocab_size=2, num_classes=3,
                                num_pca_samples_per_image=8, num_gmm_samples_per_image=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        voc.run(data, data, conf)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        voc.main(["--trainLocation", "x", "--testLocation", "y", "--labelPath", "z"])
    images = Dataset.from_items([li.image for li in items])
    labels = Dataset.from_array(torch.ones(6, 3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        voc.build_pipeline(images, labels, conf)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.voc_from_numpy({})
    _, mean_ap = voc.run(data, data, conf, device="cpu")
    assert 0.0 <= mean_ap <= 1.0 + 1e-12  # eleven sums of precision / 11
    path = str(tmp_path / "p.pt")
    NormalizeRows().to_pipeline().fit().save(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FittedPipeline.load(path)
    assert isinstance(FittedPipeline.load(path, device="cpu"), FittedPipeline)


def test_timit_entry_points_need_cuda_unless_given_the_cpu(monkeypatch, tmp_path):
    from keystone_tpu_torch.loaders.csv_loader import LabeledData
    from keystone_tpu_torch.pipelines.speech import timit

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((12, 440)).astype(np.float32)
    y = (np.arange(12) % 3).astype(np.int32)
    np.savetxt(tmp_path / "f.csv", x, delimiter=",")
    (tmp_path / "f.labels").write_text("".join(f"{i + 1} {c + 1}\n" for i, c in enumerate(y)))
    files = [str(tmp_path / "f.csv"), str(tmp_path / "f.labels")]
    argv = ["--trainDataLocation", files[0], "--trainLabelsLocation", files[1],
            "--testDataLocation", files[0], "--testLabelsLocation", files[1],
            "--numCosines", "1", "--numEpochs", "1", "--lambda", "1"]
    data = LabeledData.of(torch.as_tensor(y), torch.as_tensor(x))
    conf = timit.TimitConfig(num_cosines=1, num_cosine_features=64, lam=1.0, num_classes=3)
    calls = [
        lambda **kw: timit.main(argv, **kw),
        lambda **kw: timit.run(data, data, conf, **kw),
        lambda **kw: timit.build_pipeline(data, conf, **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    for call in calls:
        out = call(device="cpu")
        assert out == 0 or out is not None


def test_text_entry_points_need_cuda_unless_given_the_cpu(monkeypatch, tmp_path):
    from keystone_tpu_torch import convert
    from keystone_tpu_torch.loaders.csv_loader import LabeledData
    from keystone_tpu_torch.pipelines.text import amazon_reviews, newsgroups

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    texts = ["good great fine", "bad awful poor"] * 4
    data = LabeledData.of(torch.tensor([1, 0] * 4, dtype=torch.int32), texts)
    (tmp_path / "comp.graphics").mkdir()
    for i, t in enumerate(texts):
        (tmp_path / "comp.graphics" / f"{i}").write_text(t)
    reviews = tmp_path / "r.json"
    reviews.write_text("".join(f'{{"overall": {5 - 4 * (i % 2)}, "reviewText": "{t}"}}\n'
                               for i, t in enumerate(texts)))
    news = ["--trainLocation", str(tmp_path), "--testLocation", str(tmp_path)]
    amazon = ["--trainLocation", str(reviews), "--testLocation", str(reviews)]
    nconf = newsgroups.NewsgroupsConfig(common_features=16)
    aconf = amazon_reviews.AmazonReviewsConfig(common_features=16, num_iters=2, hashing=True)
    calls = [
        lambda **kw: newsgroups.main(news, **kw),
        lambda **kw: newsgroups.run(data, data, nconf, **kw),
        lambda **kw: newsgroups.build_pipeline(data, nconf, **kw),
        lambda **kw: amazon_reviews.main(amazon, **kw),
        lambda **kw: amazon_reviews.run(data, data, aconf, **kw),
        lambda **kw: amazon_reviews.build_pipeline(data, aconf, **kw),
        lambda **kw: convert.text_from_numpy({"orders": [1], "num_features": 4,
                                              "binarize": True,
                                              "logistic": {"W": np.zeros((4, 2))}}, **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    for call in calls:
        out = call(device="cpu")
        assert out == 0 or out is not None


def test_slice12_entry_points_need_cuda_unless_given_the_cpu(monkeypatch, tmp_path):
    from PIL import Image

    from keystone_tpu_torch import __main__ as cli
    from keystone_tpu_torch.ops.images import conversions, image_utils
    from keystone_tpu_torch.ops.images.daisy import DaisyExtractor
    from keystone_tpu_torch.ops.images.hog import HogExtractor
    from keystone_tpu_torch.ops.nlp.crf import CRFNEREstimator, CRFTaggerEstimator
    from keystone_tpu_torch.parallel.dataset import Dataset

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.random.default_rng(0).uniform(0, 255, (40, 40, 3)).astype(np.float32)
    path = str(tmp_path / "x.png")
    Image.fromarray(img.astype(np.uint8)).save(path)
    pos = Dataset.from_items([(["the", "dog"], ["DT", "NN"]), (["a", "cat"], ["DT", "NN"])])
    ner = Dataset.from_items([(["bob", "left"], ["B-PER", "O"])])
    news = ["--trainLocation", str(tmp_path), "--testLocation", str(tmp_path)]
    calls = [
        lambda **kw: HogExtractor(8, **kw).apply(img),
        lambda **kw: DaisyExtractor(**kw).apply(img[:, :, 0]),
        lambda **kw: conversions.bytes_to_image(bytes(12), 2, 2, 3, **kw),
        lambda **kw: image_utils.load_image(path, **kw),
        lambda **kw: CRFTaggerEstimator(n_epochs=2, hash_dim=64, **kw).fit(pos),
        lambda **kw: CRFNEREstimator(n_epochs=2, hash_dim=64, **kw).fit(ner),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    for call in calls:
        assert call(device="cpu") is not None
    # a tagger fit on the CPU decodes there; one unpickled with no device
    # wants cuda
    tagger = calls[4](device="cpu")
    assert tagger(["the", "cat"]) == ["DT", "NN"]
    tagger.__dict__.pop("_tables_cache")
    tagger.device = None
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tagger(["the", "cat"])
    # the run-pipeline entry hands the app its default device
    (tmp_path / "comp.graphics").mkdir()
    (tmp_path / "comp.graphics" / "0").write_text("good words here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["NewsgroupsPipeline"] + news)


def test_loadgen_and_lifecycle_entry_points_need_cuda_unless_given_the_cpu(monkeypatch, capsys):
    from keystone_tpu_torch.gateway import http as thttp
    from keystone_tpu_torch.lifecycle.refit import RefitAccumulator
    from keystone_tpu_torch.loadgen import cli as loadgen_cli
    from keystone_tpu_torch.serving.bench import build_split_pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loadgen_cli.main(["--self-gateway", "--synthetic", "5", "--d", "8"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        thttp.main(["--gateway-port", "0", "--refit", "--d", "8", "--hidden", "8", "--depth", "2"])
    base, _, _ = build_split_pipeline(d=4, hidden=4, depth=2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RefitAccumulator(base, 4, 4)
    acc = RefitAccumulator(base, 4, 4, device="cpu", chunk=4)
    assert acc.add(np.zeros((9, 4)), np.zeros((9, 4))) == 7 and acc.solve()[0].device.type == "cpu"
    assert loadgen_cli.main(["--self-gateway", "--synthetic", "5", "--d", "8", "--buckets", "4"],
                            device="cpu") == 0
    assert '"passed": true' in capsys.readouterr().out
