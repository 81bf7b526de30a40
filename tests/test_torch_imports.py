"""The port stands alone: importing every module of ``keystone_tpu_torch``
(and ``chip_smoke.py``) pulls in neither ``jax`` nor ``keystone_tpu``,
no source imports them, and the entry points run on CUDA unless the
caller names the CPU."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "keystone_tpu_torch")


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
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=ROOT, env=env,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert int(re.search(r"LOADED (\d+)", out.stdout).group(1)) >= 25


def test_no_source_imports_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(from|import)\s+(jax|keystone_tpu)(\.|\s|$)", re.M)
    offenders = [p for p in _port_sources() if pat.search(open(p).read())]
    assert offenders == []


def test_entry_points_need_cuda_unless_given_the_cpu(monkeypatch):
    from keystone_tpu_torch import convert
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
