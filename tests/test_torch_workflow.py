"""The port's workflow core against the JAX package's on a small chain:
``gather``, ``and_then``, estimator ``fit`` (fitted once under CSE), and
``FittedPipeline._run`` / ``_batch_run``, pad rows included."""

import dataclasses
from typing import Any

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import keystone_tpu.workflow.api as japi
from keystone_tpu.ops.util.nodes import VectorCombiner as JCombiner
from keystone_tpu.parallel.dataset import Dataset as JDataset
import keystone_tpu_torch.workflow.api as tapi
from keystone_tpu_torch.ops.util.nodes import VectorCombiner as TCombiner
from keystone_tpu_torch.parallel.dataset import Dataset as TDataset
from keystone_tpu_torch.workflow.executor import PipelineEnv as TEnv


@pytest.fixture(autouse=True)
def reset_port_env():
    TEnv.get_or_create().reset()
    yield
    TEnv.get_or_create().reset()


def make_nodes(api, asarray, mean):
    """The same small node set for either package."""

    @dataclasses.dataclass(eq=False)
    class Scale(api.Transformer):
        s: float

        def apply(self, x):
            return x * self.s

    @dataclasses.dataclass(eq=False)
    class Center(api.Transformer):
        mu: Any

        def apply(self, x):
            return x - self.mu

    @dataclasses.dataclass(eq=False)
    class CenterEstimator(api.Estimator):
        fits: list

        def fit(self, data):
            self.fits.append(data.n)
            return Center(mean(asarray(data.array())))

    return Scale, CenterEstimator


def build(api, Combiner, asarray, mean, train, fits):
    Scale, CenterEstimator = make_nodes(api, asarray, mean)
    est = CenterEstimator(fits)
    left = Scale(2.0).and_then(est, train)
    # the same estimator on the same prefix and data: CSE fits it once
    right = Scale(2.0).and_then(est, train).and_then(Scale(3.0))
    return api.Pipeline.gather([left, right]).and_then(Combiner())


@pytest.fixture
def fitted_pair():
    rng = np.random.default_rng(0)
    train = rng.standard_normal((6, 4)).astype(np.float32)
    jfits, tfits = [], []
    jpipe = build(
        japi, JCombiner, jnp.asarray,
        lambda a: jnp.mean(a, axis=0), JDataset.from_array(jnp.asarray(train)), jfits,
    ).fit()
    tpipe = build(
        tapi, TCombiner, torch.as_tensor,
        lambda a: torch.mean(a, dim=0), TDataset.from_array(torch.as_tensor(train)), tfits,
    ).fit()
    return jpipe, tpipe, jfits, tfits


def test_fit_runs_each_estimator_once(fitted_pair):
    _, _, jfits, tfits = fitted_pair
    assert jfits == tfits == [6]


def test_batch_run_matches_with_pad_rows(fitted_pair):
    jpipe, tpipe, _, _ = fitted_pair
    x = np.zeros((5, 4), np.float32)
    x[:3] = np.random.default_rng(1).standard_normal((3, 4))
    want = np.asarray(jpipe._batch_run(jnp.asarray(x)))
    got = tpipe._batch_run(torch.as_tensor(x)).numpy()
    assert got.shape == (5, 8)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    jds = jpipe._run(JDataset.from_array(jnp.asarray(x), n=3), batch=True)
    tds = tpipe._run(TDataset.from_array(torch.as_tensor(x), n=3), batch=True)
    assert jds.n == tds.n == 3 and tds.padded_n == 5
    np.testing.assert_allclose(tds.padded().numpy(), np.asarray(jds.padded()), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tds.array().numpy(), want[:3], rtol=1e-6, atol=1e-6)


def test_single_datum_run_matches(fitted_pair):
    jpipe, tpipe, _, _ = fitted_pair
    x = np.random.default_rng(2).standard_normal(4).astype(np.float32)
    want = np.asarray(jpipe._run(jnp.asarray(x), batch=False))
    got = tpipe._run(torch.as_tensor(x), batch=False)
    assert got.shape == (8,)  # the gather's tuple, combined
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_dataset_padding_discipline():
    ds = TDataset.from_array(torch.ones((3, 2)))._pad_to(5)
    assert ds.n == 3 and ds.padded_n == 5
    assert ds.mask().tolist() == [1.0, 1.0, 1.0, 0.0, 0.0]
    assert not ds.padded()[3:].any()
    assert ds.array().shape == (3, 2)
    items = TDataset.from_items([torch.ones(2), torch.zeros(2)])
    assert items.to_array_mode().padded().shape == (2, 2)
    assert items.map(lambda v: v + 1).items()[1].tolist() == [1.0, 1.0]
    with pytest.raises(ValueError, match="shrink"):
        ds._pad_to(4)


def _double_plus_one(x):
    return x * 2.0 + 1.0


def _fn_pipelines(api, Combiner):
    """``transformer(fn)`` then ``Identity`` chained, and both gathered
    beside a second ``transformer(fn)`` over the same ``fn``."""
    chained = api.transformer(_double_plus_one, "double_plus_one").and_then(api.Identity())
    gathered = api.Pipeline.gather(
        [api.transformer(_double_plus_one), api.Identity(), api.transformer(_double_plus_one)]
    ).and_then(Combiner())
    return chained, gathered


def test_transformer_and_identity_match_jax():
    x = np.random.default_rng(3).standard_normal((5, 4)).astype(np.float32)
    jchain, jgather = _fn_pipelines(japi, JCombiner)
    tchain, tgather = _fn_pipelines(tapi, TCombiner)
    assert tapi.transformer(_double_plus_one, "f").label == japi.transformer(_double_plus_one, "f").label == "f"
    for jp, tp, width in ((jchain, tchain, 4), (jgather, tgather, 12)):
        want = np.asarray(jp.apply(JDataset.from_array(jnp.asarray(x))).get().array())
        got = tp.apply(TDataset.from_array(torch.as_tensor(x))).get().array().numpy()
        assert got.shape == want.shape == (5, width)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        want1 = np.asarray(jp.apply(jnp.asarray(x[0])).get())
        got1 = tp.apply(torch.as_tensor(x[0])).get()
        np.testing.assert_allclose(np.asarray(got1), want1, rtol=1e-6, atol=1e-6)
    assert tapi.Identity().apply_batch(TDataset.from_array(torch.ones(2, 3))).array().shape == (2, 3)


def test_transformer_nodes_over_one_fn_merge_as_in_jax():
    """The optimizer's common-subexpression merge keys on ``eq_key``: two
    ``transformer(fn)`` nodes over one ``fn`` become one node, in both
    packages; over two functions they stay two."""
    x = np.ones((3, 4), np.float32)

    def count(api, Dataset, asarray, fns):
        res = api.Pipeline.gather([api.transformer(f) for f in fns]).apply(Dataset.from_array(asarray(x)))
        g = res._executor.graph
        return sum(type(op).__name__ in {f.__name__ for f in fns} for op in g.operators.values())

    def other(v):
        return v - 1.0

    for fns, want in (((_double_plus_one, _double_plus_one), 1), ((_double_plus_one, other), 2)):
        assert count(japi, JDataset, jnp.asarray, fns) == want
        assert count(tapi, TDataset, torch.as_tensor, fns) == want


def test_instrument_executor_times_each_node_of_a_fit():
    from keystone_tpu.utils.profiling import instrument_executor as jinstrument
    from keystone_tpu_torch.utils.profiling import instrument_executor as tinstrument

    rng = np.random.default_rng(0)
    train = rng.standard_normal((6, 4)).astype(np.float32)
    jpipe = build(japi, JCombiner, jnp.asarray, lambda a: jnp.mean(a, axis=0),
                  JDataset.from_array(jnp.asarray(train)), [])
    tpipe = build(tapi, TCombiner, torch.as_tensor, lambda a: torch.mean(a, dim=0),
                  TDataset.from_array(torch.as_tensor(train)), [])
    jtimes, ttimes = jinstrument(jpipe.executor), tinstrument(tpipe.executor)
    jpipe.fit()
    tpipe.fit()
    assert ttimes and len(ttimes) == len(jtimes)
    assert set(map(str, ttimes)) == set(map(str, jtimes))
    assert all(s >= 0.0 for s in ttimes.values())


def test_trace_writes_a_chrome_trace(tmp_path):
    from keystone_tpu_torch.utils.profiling import trace

    with trace(str(tmp_path / "prof")):
        tapi.transformer(_double_plus_one)(TDataset.from_array(torch.ones(4, 3))).get()
    files = list((tmp_path / "prof").iterdir())
    assert len(files) == 1 and files[0].suffix == ".json" and files[0].stat().st_size > 0
