"""``FittedPipeline.jit`` and ``jit_batch`` of the port against the JAX
package's on the same seeded inputs: the chains of the JAX package's own
pipeline tests, and the flagship SIFT+LCS→FV featurize chain at 48² and
vocab 32 (B1–B3's plain versions here); an items-mode chain raises; and
the serving engine and ``jit_batch`` capture and replay through the one
core of ``workflow/cuda_graph.py``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import keystone_tpu.workflow.api as japi
from keystone_tpu.ops.stats import nodes as jstats
from keystone_tpu.ops.util.nodes import VectorCombiner as JCombiner
from keystone_tpu.serving.featurize import build_flagship_featurize_pipeline as jax_flagship
import keystone_tpu_torch.workflow.api as tapi
from keystone_tpu_torch import convert
from keystone_tpu_torch.ops.stats import nodes as tstats
from keystone_tpu_torch.ops.util.nodes import VectorCombiner as TCombiner
from keystone_tpu_torch.serving.engine import CompiledPipeline
from keystone_tpu_torch.serving.featurize import build_flagship_featurize_pipeline as torch_flagship
from keystone_tpu_torch.workflow import cuda_graph
from keystone_tpu_torch.workflow.executor import PipelineEnv as TEnv

# the port's flagship bar (tests/test_torch_flagship.py)
FEAT_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def reset_port_env():
    TEnv.get_or_create().reset()
    yield
    TEnv.get_or_create().reset()


def scale_add(api):
    """tests/workflow/test_pipeline.py's Scale → AddConst chain."""

    @dataclasses.dataclass(eq=False)
    class Scale(api.Transformer):
        factor: float

        def apply(self, x):
            return x * self.factor

    @dataclasses.dataclass(eq=False)
    class AddConst(api.Transformer):
        c: float

        def apply(self, x):
            return x + self.c

    return Scale(2.0).and_then(AddConst(1.0)).fit()


def test_jit_matches_jax_on_the_scale_chain():
    x = np.asarray([1.0, 2.0], np.float32)
    want = np.asarray(scale_add(japi).jit()(jnp.asarray(x)))
    got = scale_add(tapi).jit(device="cpu")(x)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(want, [3.0, 5.0])


def test_jit_batch_matches_jax_on_the_scale_chain():
    x = np.random.default_rng(1).standard_normal((5, 3)).astype(np.float32)
    want = np.asarray(scale_add(japi).jit_batch()(jnp.asarray(x)))
    f = scale_add(tapi).jit_batch(device="cpu")
    np.testing.assert_allclose(f(x).numpy(), want, atol=1e-6)
    # a tensor in, and donate taken, changing nothing
    np.testing.assert_allclose(
        scale_add(tapi).jit_batch(donate=True, device="cpu")(torch.as_tensor(x)).numpy(),
        want, atol=1e-6,
    )


def gathered(stats, api, combiner):
    """tests/workflow/test_pipeline.py's gather of two
    RandomSignNode → LinearRectifier → NormalizeRows branches."""
    branches = [
        stats.RandomSignNode.create(12, seed=i)
        .and_then(stats.LinearRectifier(0.0))
        .and_then(stats.NormalizeRows())
        for i in range(2)
    ]
    return api.Pipeline.gather(branches).and_then(combiner())


def test_jit_batch_matches_jax_on_a_gathered_chain():
    x = np.random.default_rng(0).standard_normal((6, 12)).astype(np.float32)
    jpipe = gathered(jstats, japi, JCombiner)
    want = np.asarray(jpipe.fit().jit_batch()(jnp.asarray(x)))
    tpipe = gathered(tstats, tapi, TCombiner)
    got = tpipe.fit().jit_batch(device="cpu")(x)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # and the port's executor path
    ref = tpipe.apply(tapi.Dataset.from_array(torch.as_tensor(x))).get().padded()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6)


def test_jit_batch_matches_jax_on_the_flagship_chain():
    """The flagship featurize chain at 48² and vocab 32 (the fused Fisher
    Vector, B3), the same seed drawing the same parameters in both
    packages, two batch shapes through one callable."""
    geometry = dict(img=48, desc_dim=8, vocab=32, sift_step=4, sift_bin=4, sift_scales=2)
    jfeat, dim = jax_flagship(**geometry)
    tfeat, tdim = torch_flagship(device="cpu", **geometry)
    assert dim == tdim == 4 * 8 * 32
    raw = np.random.default_rng(5).integers(0, 256, (5, 48, 48, 3), dtype=np.uint8)
    jf, tf = jfeat.jit_batch(), tfeat.jit_batch(device="cpu")
    for rows in (5, 3):
        want = np.asarray(jf(jnp.asarray(raw[:rows])))
        got = tf(raw[:rows])
        assert tuple(got.shape) == (rows, dim)
        np.testing.assert_allclose(got.numpy(), want, **FEAT_TOL)
    # one example through jit() is the batch's row
    one = tfeat.jit(device="cpu")(raw[1])
    np.testing.assert_allclose(one.numpy(), tf(raw[:3])[1].numpy(), **FEAT_TOL)


def host_chain(api, jax_side):
    """A chain with a node that runs per example on the host."""

    class HostNode(api.Transformer):
        vmap_batch = False

        def apply(self, x):
            return np.asarray(x) * 2.0

        if not jax_side:
            def apply_batch(self, ds):
                return ds.map(self.apply)

    return HostNode().to_pipeline().fit()


def test_jit_batch_of_an_items_mode_chain_raises_naming_apply():
    x = np.ones((3, 2), np.float32)
    with pytest.raises(Exception):
        host_chain(japi, True).jit_batch()(jnp.asarray(x))
    with pytest.raises(TypeError, match="use apply"):
        host_chain(tapi, False).jit_batch(device="cpu")(x)
    # apply runs it
    out = host_chain(tapi, False).apply(tapi.Dataset.from_array(torch.as_tensor(x)))
    assert len(out.items()) == 3


def test_jit_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        scale_add(tapi).jit_batch()
    with pytest.raises(RuntimeError):
        scale_add(tapi).jit()


class FakeGraph:
    def pool(self):
        return (0, 1)


def test_engine_and_jit_batch_capture_through_one_core(monkeypatch):
    """``CompiledPipeline`` and ``jit_batch`` both capture with
    ``cuda_graph.capture_graph`` and replay with ``cuda_graph.replay_graph``
    (here stand-ins that run the chain eagerly), so the two cannot drift;
    ``jit_batch`` captures once per input spec and shares one pool."""
    calls = []

    def capture(run, example, stream, device, *, warm=None, pool=None):
        calls.append(("capture", stream, warm is not None, pool))
        (warm or run)(example)
        return cuda_graph.CapturedGraph(FakeGraph(), example, run(example), {}, 0.0, 0)

    def replay(g, staged, stream, device, ready=None, rows=None):
        calls.append(("replay", stream, rows))
        return g.static_out if rows is None else g.static_out[:rows]

    monkeypatch.setattr(cuda_graph, "capture_graph", capture)
    monkeypatch.setattr(cuda_graph, "replay_graph", replay)

    rng = np.random.default_rng(0)
    W = rng.standard_normal((6, 4)).astype(np.float32)
    model = convert.model_head(W, np.zeros(4, np.float32), 2, "cpu")
    eng = CompiledPipeline(model, (4,), device="cpu")
    eng._compute_stream = "engine-stream"
    staged = torch.as_tensor(rng.standard_normal((4, 6)).astype(np.float32))
    g = eng._capture(4, staged)
    out = eng._replay(g, staged, 3, None)
    assert calls == [("capture", "engine-stream", True, None), ("replay", "engine-stream", 3)]
    assert eng.metrics.compile_count == 1 and 4 in eng.kernel_costs
    np.testing.assert_array_equal(out.numpy(), model._batch_run(staged)[:3].numpy())

    calls.clear()
    f = model.jit_batch(device="cpu")
    f._stream = "jit-stream"
    for rows in (4, 4, 2):
        got = f._graphed(staged[:rows])
        np.testing.assert_array_equal(got.numpy(), model._batch_run(staged[:rows]).numpy())
    assert calls == [
        ("capture", "jit-stream", False, None), ("replay", "jit-stream", None),
        ("replay", "jit-stream", None),
        ("capture", "jit-stream", False, (0, 1)), ("replay", "jit-stream", None),
    ]
    assert f.captures == 2
    assert [r["spec"] for r in f.graph_report()] == [
        ((4, 6), torch.float32), ((2, 6), torch.float32)]


def test_threads_racing_to_new_specs_capture_each_once(monkeypatch):
    """Sixteen threads calling one ``jit_batch`` callable with three batch
    shapes at once (a short switch interval): each shape is captured
    once, every call gets its own rows, and the lock is free after."""
    import sys
    import threading

    captured = []

    def capture(run, example, stream, device, *, warm=None, pool=None):
        captured.append(tuple(example.shape))
        return cuda_graph.CapturedGraph(FakeGraph(), example, None, {}, 0.0, 0)

    def replay(g, staged, stream, device, ready=None, rows=None):
        return staged.clone() * 2.0

    monkeypatch.setattr(cuda_graph, "capture_graph", capture)
    monkeypatch.setattr(cuda_graph, "replay_graph", replay)
    f = scale_add(tapi).jit_batch(device="cpu")
    f._stream = "jit-stream"
    errors, done = [], []

    def call(i):
        try:
            for j in range(20):
                x = torch.full((2 + (i + j) % 3, 4), float(i))
                np.testing.assert_array_equal(f._graphed(x).numpy(), x.numpy() * 2.0)
            done.append(i)
        except Exception as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=call, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert sorted(done) == list(range(16))
    assert sorted(captured) == [(2, 4), (3, 4), (4, 4)] and f.captures == 3
    assert not f._lock.locked()
