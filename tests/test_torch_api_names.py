"""The JAX package's names the port took on last, each against the JAX
package's on the same seeded inputs: ``Dataset.map_arrays``,
``flat_map``, ``filter`` and ``is_cached``; ``PipelineDataset.of`` and
``PipelineDatum.of`` through a fit and an apply; ``Pipeline.to_dot``;
``LinearMapEstimator.compute_cost``; ``ColumnPCAEstimator(num_machines=)``;
``RandomFFTFeatures(row_chunk=)``; the block solvers' ``num_features``;
``SIFTExtractor.descriptor_dims``; ``native.native_available``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import keystone_tpu.native as jnative
import keystone_tpu.workflow.api as japi
from keystone_tpu.ops.images.sift import SIFTExtractor as JSIFT
from keystone_tpu.ops.learning import block_ls as jblock
from keystone_tpu.ops.learning import linear as jlinear
from keystone_tpu.ops.learning import pca as jpca
from keystone_tpu.ops.learning import weighted_ls as jwls
from keystone_tpu.ops.stats import nodes as jstats
from keystone_tpu.parallel.dataset import Dataset as JDataset
import keystone_tpu_torch.native as tnative
import keystone_tpu_torch.workflow.api as tapi
from keystone_tpu_torch.ops.images.sift import SIFTExtractor as TSIFT
from keystone_tpu_torch.ops.learning import block_ls as tblock
from keystone_tpu_torch.ops.learning import linear as tlinear
from keystone_tpu_torch.ops.learning import pca as tpca
from keystone_tpu_torch.ops.learning import weighted_ls as twls
from keystone_tpu_torch.ops.stats import nodes as tstats
from keystone_tpu_torch.parallel.dataset import Dataset as TDataset
from keystone_tpu_torch.workflow.executor import PipelineEnv as TEnv


@pytest.fixture(autouse=True)
def reset_port_env():
    TEnv.get_or_create().reset()
    yield
    TEnv.get_or_create().reset()


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def both(x, n=None):
    """The same rows as a JAX and a port dataset (``n`` valid rows)."""
    return JDataset.from_array(jnp.asarray(x), n=n), TDataset.from_array(torch.as_tensor(x), n=n)


X = np.random.default_rng(0).standard_normal((6, 3)).astype(np.float32)


def test_map_arrays_keeps_the_valid_count():
    jds, tds = both(X, n=4)
    j, t = jds.map_arrays(lambda a: a * 2.0 + 1.0), tds.map_arrays(lambda a: a * 2.0 + 1.0)
    assert j.n == t.n == 4 and t.is_array
    np.testing.assert_allclose(_np(t.padded()), _np(j.padded()))
    np.testing.assert_allclose(_np(t.array()), _np(j.array()))


def test_flat_map_and_filter_match_jax():
    jds, tds = both(X, n=5)
    j = jds.flat_map(lambda x: [x, x * 3.0])
    t = tds.flat_map(lambda x: [x, x * 3.0])
    assert j.n == t.n == 10 and not t.is_array
    for a, b in zip(j.items(), t.items()):
        np.testing.assert_allclose(_np(b), _np(a))
    j = jds.filter(lambda x: float(x.sum()) > 0)
    t = tds.filter(lambda x: float(x.sum()) > 0)
    assert j.n == t.n > 0
    for a, b in zip(j.items(), t.items()):
        np.testing.assert_allclose(_np(b), _np(a))


def test_is_cached_follows_cache():
    jds, tds = both(X)
    assert jds.is_cached is tds.is_cached is False
    assert tds.cache() is tds
    jds.cache()
    assert jds.is_cached is tds.is_cached is True


def nodes(api):
    @dataclasses.dataclass(eq=False)
    class Scale(api.Transformer):
        s: float

        def apply(self, x):
            return x * self.s

    @dataclasses.dataclass(eq=False)
    class Center(api.Transformer):
        mu: object

        def apply(self, x):
            return x - self.mu

    class MeanEstimator(api.Estimator):
        def fit(self, data):
            return Center(data.array().mean(0))

    return Scale, MeanEstimator


@pytest.mark.parametrize("side", ["jax", "port"])
def test_pipeline_dataset_and_datum_of_through_a_fit_and_an_apply(side):
    api, ds_of, arr = (
        (japi, JDataset.from_array, jnp.asarray) if side == "jax"
        else (tapi, TDataset.from_array, torch.as_tensor)
    )
    Scale, MeanEstimator = nodes(api)
    train = api.PipelineDataset.of(ds_of(arr(X)))
    pipe = Scale(2.0).and_then(MeanEstimator(), train)
    fitted = pipe.fit()
    want_rows = 2.0 * X - (2.0 * X).mean(0)
    got = pipe.apply(api.PipelineDataset.of(ds_of(arr(X)))).get()
    np.testing.assert_allclose(_np(got.array()), want_rows, rtol=1e-5, atol=1e-6)
    datum = pipe.apply(api.PipelineDatum.of(arr(X[2]))).get()
    np.testing.assert_allclose(_np(datum), want_rows[2], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(fitted.apply(arr(X[2]))), want_rows[2], rtol=1e-5, atol=1e-6)


def test_pipeline_to_dot_is_its_graphs_and_jaxs():
    def build(api, stats):
        return api.Pipeline.gather([
            stats.LinearRectifier(0.0).to_pipeline(),
            stats.NormalizeRows().to_pipeline(),
        ])

    tpipe = build(tapi, tstats)
    assert tpipe.to_dot() == tpipe._graph.to_dot()
    assert tpipe.to_dot() == build(japi, jstats).to_dot()


@pytest.mark.parametrize("intercept", [False, True])
def test_compute_cost_matches_jax(intercept):
    rng = np.random.default_rng(3)
    A = rng.standard_normal((8, 5)).astype(np.float32)
    A[6:] = 0.0  # two pad rows
    Y = rng.standard_normal((8, 2)).astype(np.float32)
    Y[6:] = 0.0
    W = rng.standard_normal((5, 2)).astype(np.float32)
    b = rng.standard_normal(2).astype(np.float32) if intercept else None
    (ja, ta), (jy, ty) = both(A, n=6), both(Y, n=6)
    want = jlinear.LinearMapEstimator.compute_cost(
        ja, jy, 0.3, jnp.asarray(W), None if b is None else jnp.asarray(b))
    got = tlinear.LinearMapEstimator.compute_cost(ta, ty, 0.3, W, b)
    assert isinstance(got, float)
    assert got == pytest.approx(want, rel=1e-5)


# (n, d, dims, machines): rows of the descriptor sample, its width, the
# PCA's output width and the machines to price at
PCA_GRID = [(n, d, 16, m) for n in (20, 400, 50_000) for d in (32, 128) for m in (1, 8, 64)]


def test_column_pca_num_machines_picks_as_jax_does():
    picks = []
    for n, d, dims, m in PCA_GRID:
        cols = np.ones((3, d, 2), np.float32)  # 3 images of 2 descriptors
        jsample = JDataset.from_array(jnp.asarray(cols))
        tsample = TDataset.from_array(torch.as_tensor(cols))
        want = type(jpca.ColumnPCAEstimator(dims, num_machines=m).optimize([jsample], n)).__name__
        got = type(tpca.ColumnPCAEstimator(dims, num_machines=m).optimize([tsample], n)).__name__
        assert got == want, (n, d, dims, m)
        picks.append(want)
    assert {"LocalColumnPCAEstimator", "DistributedColumnPCAEstimator"} <= set(picks)


def test_random_fft_row_chunk_changes_no_output():
    x = np.random.default_rng(4).standard_normal((7, 10)).astype(np.float32)
    (jds, tds) = both(x, n=6)
    want = jstats.RandomFFTFeatures.create(10, 3, seed=2, rectify_threshold=0.1)
    default = tstats.RandomFFTFeatures.create(10, 3, seed=2, rectify_threshold=0.1)
    chunked = dataclasses.replace(default, row_chunk=3)
    assert default.row_chunk == want.row_chunk == 8192
    a = chunked.apply_batch(tds).padded()
    np.testing.assert_array_equal(a.numpy(), default.apply_batch(tds).padded().numpy())
    np.testing.assert_allclose(
        a.numpy(), _np(dataclasses.replace(want, row_chunk=3).apply_batch(jds).padded()),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", [
    "BlockLeastSquaresEstimator", "BlockWeightedLeastSquaresEstimator",
    "PerClassWeightedLeastSquaresEstimator",
])
def test_block_solvers_take_num_features(name):
    rng = np.random.default_rng(5)
    A = rng.standard_normal((12, 6)).astype(np.float32)
    Y = np.where(np.eye(3)[rng.integers(0, 3, 12)] > 0, 1.0, -1.0).astype(np.float32)
    jmod, tmod = (jblock, tblock) if name == "BlockLeastSquaresEstimator" else (jwls, twls)
    args = (3, 1, 0.1) if name == "BlockLeastSquaresEstimator" else (3, 1, 0.1, 0.25)
    est = getattr(tmod, name)(*args, num_features=6)
    assert est.num_features == getattr(jmod, name)(*args, num_features=6).num_features == 6
    got = est.fit(TDataset.from_array(torch.as_tensor(A)), TDataset.from_array(torch.as_tensor(Y)))
    plain = getattr(tmod, name)(*args).fit(
        TDataset.from_array(torch.as_tensor(A)), TDataset.from_array(torch.as_tensor(Y)))
    x = torch.as_tensor(A[:3])
    np.testing.assert_array_equal(got.apply(x).numpy(), plain.apply(x).numpy())


def test_sift_descriptor_dims_and_native_available():
    assert TSIFT().descriptor_dims == JSIFT().descriptor_dims == 128
    got = tnative.native_available()
    assert isinstance(got, bool) and isinstance(jnative.native_available(), bool)
    assert got == tnative.io_native_available()
