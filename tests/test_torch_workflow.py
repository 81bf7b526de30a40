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
