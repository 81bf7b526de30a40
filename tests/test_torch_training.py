"""The training slice on the CPU: every estimator the flagship fits
(ColumnSampler, ClassLabelIndicators, Cacher, the PCA family, k-means++,
both GMM EMs, the GMM Fisher-vector estimator, the mixture-weighted block
least-squares solver) against its JAX counterpart on the same seeded numpy
inputs, and the whole ImageNetSiftLcsFV fit (``run``) against the JAX
package's at vocab 2 and vocab 32. Bars are the JAX tests' own: 2e-3 / 5e-3
for PCA (tests/ops/test_pca_zca.py), 1e-3 for GMMs
(tests/ops/test_clustering.py), 5e-4 between solvers and 2e-2 against the
float64 reference translation (tests/ops/test_weighted_ls.py), 2e-2 for the
slice's model, and 2e-2 for Fisher vectors of a fitted GMM
(tests/ops/test_sift_fv.py's codebook bar)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.loaders.image_loaders import LabeledImage as JLabeledImage
from keystone_tpu.ops import learning as jlearn
from keystone_tpu.ops.images import fisher_vector as jfv
from keystone_tpu.ops.learning import weighted_ls as jwls
from keystone_tpu.ops.stats import ColumnSampler as JColumnSampler
from keystone_tpu.ops.util.nodes import ClassLabelIndicators as JIndicators
from keystone_tpu.parallel.dataset import Dataset as JDataset
from keystone_tpu.pipelines.images import imagenet_sift_lcs_fv as jflagship
from keystone_tpu.serving.featurize import (
    build_flagship_featurize_pipeline as jax_build,
)
from keystone_tpu_torch import convert
from keystone_tpu_torch.loaders.image_loaders import LabeledImage
from keystone_tpu_torch.ops.images import fisher_vector as tfv
from keystone_tpu_torch.ops.learning import gmm as tgmm
from keystone_tpu_torch.ops.learning import kmeans as tkmeans
from keystone_tpu_torch.ops.learning import pca as tpca
from keystone_tpu_torch.ops.learning import weighted_ls as twls
from keystone_tpu_torch.ops.stats.nodes import ColumnSampler
from keystone_tpu_torch.ops.util.cacher import Cacher
from keystone_tpu_torch.ops.util.nodes import ClassLabelIndicators
from keystone_tpu_torch.parallel.dataset import Dataset, on_device
from keystone_tpu_torch.pipelines.images import imagenet_sift_lcs_fv as tflagship
from keystone_tpu_torch.serving.featurize import (
    build_flagship_featurize_pipeline as torch_build,
)
from keystone_tpu_torch.workflow.api import LabelEstimator, Transformer
from keystone_tpu_torch.workflow.executor import PipelineEnv as TEnv
from ops.test_weighted_ls import _weighted_problem, ref_block_weighted_bcd
from pipelines.test_imagenet_sift_lcs_fv import _synthetic_imagenet
from test_torch_flagship import jax_params

PCA_TOL = 5e-3
GMM_TOL = dict(rtol=1e-3, atol=1e-3)
SOLVER_TOL = 5e-4
REF_TOL = 2e-2
# Fisher vectors of a fitted GMM: the LCS branch's logits cancel terms of
# x²/σ² ~ 1e4 per dimension, so float32 rounding moves posteriors near the
# 1e-4 threshold (the features of one chain in the two packages differ by
# ~6e-4 here)
FITTED_FEAT_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(autouse=True)
def reset_port_env():
    TEnv.get_or_create().reset()
    yield
    TEnv.get_or_create().reset()


def np_(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def tds(x, n=None):
    return Dataset.from_array(torch.as_tensor(np.asarray(x)), n=n)


# -- workflow and dataset pieces -------------------------------------------


@pytest.mark.parametrize("mode", ["array", "items"])
def test_column_sampler_draws_match_jax_index_for_index(mode):
    rng = np.random.default_rng(0)
    mats = [rng.standard_normal((4, 20)).astype(np.float32) for _ in range(5)]
    jax_node, node = JColumnSampler(6, seed=3), ColumnSampler(6, seed=3)
    # two calls: the per-datum counter runs on across them
    for part in (mats[:3], mats[3:]):
        want = [np.asarray(m) for m in jax_node.apply_batch(JDataset.from_items(part)).items()]
        ds = tds(np.stack(part)) if mode == "array" else Dataset.from_items(
            [torch.as_tensor(m) for m in part]
        )
        got = node.apply_batch(ds)
        assert got.n == len(part)
        for g, w in zip(got.items(), want):
            np.testing.assert_array_equal(np_(g), w)
    assert node._counter == jax_node._counter == 5
    assert node.eq_key() == jax_node.eq_key()


def test_class_label_indicators_match_jax():
    y = np.array([0, 3, 1, 3, 0, 0], np.int32)  # last two rows are padding
    want = np.asarray(JIndicators(4).apply_batch(JDataset.from_array(jnp.asarray(y), n=4)).padded())
    got = ClassLabelIndicators(4).apply_batch(tds(y, n=4)).padded()
    np.testing.assert_array_equal(np_(got), want)
    assert not want[4:].any()
    np.testing.assert_array_equal(
        np_(ClassLabelIndicators(4).apply(torch.tensor(2))),
        np.asarray(JIndicators(4).apply(jnp.asarray(2))),
    )


def test_cacher_is_an_identity_that_marks_a_saveable_prefix():
    from keystone_tpu_torch.workflow.rules import ExtractSaveablePrefixes

    ds = tds(np.arange(6.0).reshape(3, 2))
    out = Cacher().apply_batch(ds)
    assert out is ds
    assert Cacher("a").eq_key() == Cacher("a").eq_key() == ("cacher", "a", None)
    c = Cacher()
    assert c.eq_key() != Cacher().eq_key() and c.eq_key() == c.eq_key()
    pipe = Cacher()(ds)
    _, prefixes = ExtractSaveablePrefixes().apply(pipe._graph, {})
    assert len(prefixes) == 1


def test_dataset_first_zip_cache_match_jax():
    a, b = np.arange(12.0).reshape(4, 3), np.arange(4.0)
    ja, jb = JDataset.from_array(jnp.asarray(a), n=3), JDataset.from_array(jnp.asarray(b), n=3)
    ta, tb = tds(a, n=3), tds(b, n=3)
    np.testing.assert_array_equal(np_(ta.first()), np.asarray(ja.first()))
    jz, tz = ja.zip(jb), ta.zip(tb)
    assert tz.n == jz.n == 3
    for g, w in zip(tz.padded(), jz.padded()):
        np.testing.assert_array_equal(np_(g), np.asarray(w))
    items = Dataset.from_items([1, 2, 3]).zip(Dataset.from_items([4, 5, 6]))
    assert items.items() == [(1, 4), (2, 5), (3, 6)] and items.first() == (1, 4)
    with pytest.raises(ValueError, match="length mismatch"):
        ta.zip(tds(b))
    assert ta.cache() is ta


class _CountLabels(LabelEstimator):
    def fit(self, data, labels):
        return _AddConstant(float(labels.array().sum()))


class _AddConstant(Transformer):
    def __init__(self, c):
        self.c = c

    def apply(self, x):
        return x + self.c

    def apply_batch(self, ds):
        return Dataset.from_array(ds.padded() + self.c, n=ds.n)


def test_label_estimator_chains_with_data_and_labels():
    x, y = tds(np.zeros((3, 2), np.float32)), tds(np.array([1.0, 2.0, 3.0]))
    est = _CountLabels()
    with pytest.raises(TypeError, match="needs data and labels"):
        _AddConstant(0.0).and_then(est, x)
    with pytest.raises(TypeError, match="needs labels"):
        est.with_data(x)
    fitted = _AddConstant(1.0).and_then(est, x, y).fit()
    np.testing.assert_array_equal(np_(fitted(x).array()), np.full((3, 2), 7.0))


# -- PCA ---------------------------------------------------------------------


def _lowrank(n, d, r, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((n, r)) @ rng.standard_normal((r, d))
        + 0.01 * rng.standard_normal((n, d))
    ).astype(np.float32)


@pytest.mark.parametrize("which", ["local", "distributed", "local_column", "distributed_column"])
def test_pca_estimators_match_jax(mesh8, which):
    if which in ("local", "distributed"):
        X = _lowrank(96, 10, 4, seed=1)
        jdata, data = JDataset.of(X), tds(X)
        if which == "distributed":
            jdata = jdata.shard()
        names = {"local": "PCAEstimator", "distributed": "DistributedPCAEstimator"}
    else:
        rng = np.random.default_rng(3)
        mats = np.stack([
            (rng.standard_normal((8, 3)) @ rng.standard_normal((3, 20))).astype(np.float32)
            for _ in range(6)
        ])
        jdata, data = JDataset.from_items(list(mats)), tds(mats)
        names = {"local_column": "LocalColumnPCAEstimator",
                 "distributed_column": "DistributedColumnPCAEstimator"}
    name = names[which]
    want = np.asarray(getattr(jlearn, name)(3).fit(jdata).pca_mat)
    got = getattr(tpca, name)(3).fit(data)
    np.testing.assert_allclose(np_(got.pca_mat), want, atol=PCA_TOL)
    if which.endswith("column"):
        assert isinstance(got, tpca.BatchPCATransformer)
        np.testing.assert_allclose(
            np_(got.apply_batch(data).array()),
            np.stack([np.asarray(want.T @ m) for m in mats]), rtol=1e-3, atol=1e-3,
        )


def test_pca_sign_convention_matches_jax():
    from keystone_tpu.ops.learning.pca import (
        enforce_matlab_pca_sign_convention as jsign,
    )

    V = np.random.default_rng(2).standard_normal((7, 5)).astype(np.float32)
    got = np_(tpca.enforce_matlab_pca_sign_convention(torch.as_tensor(V)))
    np.testing.assert_array_equal(got, np.asarray(jsign(jnp.asarray(V))))
    assert (np.abs(got).argmax(0) == got.argmax(0)).all()


@pytest.mark.parametrize("d,m,n_total", [
    (128, 20, 36),  # the slice test: 36 images, 20 SIFT samples each
    (96, 20, 36),   # its LCS branch
    (128, 10, 2000),  # the chip's fit: 2,000 images, 10 samples each
    (96, 10, 2000),
    (8, 10, 4),  # few columns: local PCA is cheaper
])
def test_column_pca_picks_the_same_option_as_jax(mesh8, d, m, n_total):
    mats = np.zeros((4, d, m), np.float32)
    want = jlearn.ColumnPCAEstimator(4).optimize([JDataset.from_items(list(mats))], n_total)
    got = tpca.ColumnPCAEstimator(4).optimize([tds(mats)], n_total)
    assert type(got).__name__ == type(want).__name__
    expect = "Distributed" if n_total * m > 3 * d else "Local"
    assert type(got).__name__.startswith(expect)


# -- k-means++ and GMMs ------------------------------------------------------


def _blobs(n_per, centers, spread, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        c + spread * rng.standard_normal((n_per, len(c))) for c in centers
    ]).astype(np.float32)


CENTERS = [np.array([0.0, 0.0]), np.array([5.0, 5.0]), np.array([-5.0, 5.0])]


@pytest.mark.parametrize("iters", [1, 20])
def test_kmeans_plus_plus_means_match_jax(iters):
    X = _blobs(60, CENTERS, 1.5, seed=0)
    want = jlearn.KMeansPlusPlusEstimator(3, iters, seed=4).fit(JDataset.of(X))
    got = tkmeans.KMeansPlusPlusEstimator(3, iters, seed=4).fit(tds(X))
    np.testing.assert_allclose(np_(got.means), np.asarray(want.means), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        np_(got.apply_batch(tds(X)).array()),
        np.asarray(want.apply_batch(JDataset.of(X)).array()),
    )


@pytest.mark.parametrize("em", ["GaussianMixtureModelEstimator", "FusedGMMEstimator"])
@pytest.mark.parametrize("case", ["converges", "min_cluster_guard", "random_init"])
def test_gmm_em_matches_jax(em, case):
    X = _blobs(120, CENTERS, 0.8, seed=1)
    kw = dict(k=3, max_iterations=30, min_cluster_size=5, seed=1)
    if case == "min_cluster_guard":
        kw["min_cluster_size"] = 125  # > the blobs' 120: EM stops at once
    if case == "random_init":
        kw["initialization_method"] = "random"
    want = getattr(jlearn, em)(**kw).fit(X)
    got = getattr(tgmm, em)(**kw).fit(torch.as_tensor(X))
    for f in ("means", "variances", "weights"):
        np.testing.assert_allclose(np_(getattr(got, f)), np.asarray(getattr(want, f)),
                                   err_msg=f, **GMM_TOL)
    if case == "min_cluster_guard":
        # stopped before the first update: the k-means++ initialisation
        init = tgmm.GaussianMixtureModelEstimator(**kw)._initialize(
            torch.as_tensor(X), torch.as_tensor(X * X))
        np.testing.assert_allclose(np_(got.means), np_(init[0].T), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        np_(got.apply_batch(tds(X)).array()),
        np.asarray(want.apply_batch(JDataset.of(X)).array()), atol=1e-4,
    )


def test_optimizable_gmm_picks_fused_at_k32():
    assert type(tgmm.OptimizableGMMEstimator(k=8).default) is tgmm.GaussianMixtureModelEstimator
    assert type(tgmm.OptimizableGMMEstimator(k=32).optimize([], -1)) is tgmm.FusedGMMEstimator


def test_gmm_csv_load_matches_jax(tmp_path):
    files = []
    for name, a in (("m", [[0.0, 1.0], [2.0, 3.0]]), ("v", [[1.0, 2.0], [0.5, 1.0]]),
                    ("w", [0.4, 0.6])):
        files.append(str(tmp_path / f"{name}.csv"))
        np.savetxt(files[-1], np.asarray(a), delimiter=",")
    want = jlearn.GaussianMixtureModel.load(*files)
    got = tgmm.GaussianMixtureModel.load(*files, device="cpu")
    assert got.k == 2 and got.dim == 2
    x = np.array([0.5, 2.0], np.float32)
    np.testing.assert_allclose(np_(got.apply(torch.as_tensor(x))), np.asarray(want.apply(x)),
                               atol=1e-6)


@pytest.mark.parametrize("k", [8, 32])
def test_gmm_fisher_vector_estimator_matches_jax(k):
    """Descriptor matrices (d = 8, m = 60) from two offset populations; at
    k = 32 the estimator picks the fused node (the plain version of B3
    here, Pallas in interpret mode in the JAX package)."""
    rng = np.random.default_rng(k)
    mats = np.stack([
        (rng.standard_normal((8, 60)) + 3.0 * (i % 2)).astype(np.float32) for i in range(12)
    ])
    kw = dict(k=k, seed=2)
    want = jfv.GMMFisherVectorEstimator(**kw).fit(JDataset.from_items(list(mats)))
    got = tfv.GMMFisherVectorEstimator(**kw).fit(tds(mats))
    assert type(got).__name__ == type(want).__name__ == (
        "FisherVectorFused" if k >= 32 else "FisherVector")
    for f in ("means", "variances", "weights"):
        np.testing.assert_allclose(np_(getattr(got.gmm, f)), np.asarray(getattr(want.gmm, f)),
                                   err_msg=f, **GMM_TOL)
    # the FV of the fitted GMMs (the JAX bar of tests/ops/test_fv_pallas.py)
    np.testing.assert_allclose(
        np_(got.apply_batch(tds(mats[:4])).array()),
        np.asarray(want.apply_batch(JDataset.of(jnp.asarray(mats[:4]))).array()),
        rtol=1e-3, atol=1e-4,
    )


# -- the mixture-weighted block least-squares solver -------------------------


def _skewed_problem():
    # class counts [84, 3, 2, 1]
    rng = np.random.default_rng(5)
    y = np.concatenate([np.zeros(84, np.int64), np.full(3, 1), np.full(2, 2), [3]])
    centers = rng.standard_normal((4, 10)) * 2
    X = (centers[y] + rng.standard_normal((len(y), 10))).astype(np.float32)
    return X, (2.0 * np.eye(4, dtype=np.float32)[y] - 1.0)


def _multi_hot_problem():
    X, Y, _ = _weighted_problem(n=200, D=48, C=4, seed=5)
    Y = np.asarray(Y).copy()
    rng = np.random.default_rng(0)
    for i in rng.choice(200, 66, replace=False):
        c = int(np.argmax(Y[i]))
        if c < 3:
            Y[i, c + 1:][rng.integers(0, 4 - c - 1)] = 1.0
    return X, Y


def _empty_classes_problem():
    # six label columns; classes 2 and 5 have no rows
    X, Y, y = _weighted_problem(n=90, D=10, C=4, seed=4)
    y6 = np.array([0, 1, 3, 4])[y]
    return X, (2.0 * np.eye(6, dtype=np.float32)[y6] - 1.0)


PROBLEMS = {
    "one_block": lambda: _weighted_problem()[:2],
    "ragged_tail": lambda: _weighted_problem(n=160, D=20, C=4, seed=9)[:2],
    "skewed": _skewed_problem,
    "multi_hot": _multi_hot_problem,
    "empty_classes": _empty_classes_problem,
}
CASES = [
    ("one_block", dict(block_size=10, num_iter=1, solve="pcg"), True),
    ("one_block", dict(block_size=4, num_iter=2, solve="pcg"), True),
    ("one_block", dict(block_size=10, num_iter=1, solve="chol"), True),
    ("one_block", dict(block_size=4, num_iter=2, solve="chol"), True),
    ("ragged_tail", dict(block_size=8, num_iter=2, solve="pcg"), True),
    ("ragged_tail", dict(block_size=8, num_iter=2, solve="chol"), True),
    ("skewed", dict(block_size=10, num_iter=1, solve="chol", layout="grouped"), True),
    ("skewed", dict(block_size=10, num_iter=1, solve="chol", layout="gathered"), True),
    ("skewed", dict(block_size=10, num_iter=1, solve="pcg"), True),
    ("multi_hot", dict(block_size=48, num_iter=1, solve="pcg"), False),
    ("multi_hot", dict(block_size=48, num_iter=1, solve="chol"), False),
    ("empty_classes", dict(block_size=10, num_iter=1, solve="pcg"), False),
    ("empty_classes", dict(block_size=10, num_iter=1, solve="chol", layout="gathered"), False),
]


@pytest.mark.parametrize(
    "problem,kw,has_ref", CASES,
    ids=[f"{p}-{'-'.join(str(v) for v in kw.values())}" for p, kw, _ in CASES],
)
def test_block_weighted_ls_matches_jax(problem, kw, has_ref):
    X, Y = PROBLEMS[problem]()
    lam, w = 0.1, 0.6
    want = jwls.BlockWeightedLeastSquaresEstimator(lam=lam, mixture_weight=w, class_chunk=2, **kw).fit(
        JDataset.of(X), JDataset.of(Y))
    got = twls.BlockWeightedLeastSquaresEstimator(lam=lam, mixture_weight=w, class_chunk=2, **kw).fit(
        tds(X), tds(Y))
    np.testing.assert_allclose(np_(got.W), np.asarray(want.W), atol=SOLVER_TOL)
    np.testing.assert_allclose(np_(got.intercept), np.asarray(want.intercept), atol=SOLVER_TOL)
    if has_ref:
        W_ref, b_ref = ref_block_weighted_bcd(X, Y, kw["block_size"], kw["num_iter"], lam, w)
        np.testing.assert_allclose(np_(got.W), W_ref, atol=REF_TOL)
        np.testing.assert_allclose(np_(got.intercept), b_ref, atol=REF_TOL)
    if problem == "empty_classes":
        assert not np_(got.W)[:, [2, 5]].any()
    if kw["solve"] == "pcg":
        info = got.solver_info
        assert float(info["pcg_max_rel_residual"]) < 1e-5
        assert 0 < info["pcg_iterations"] <= 96
    else:
        assert got.solver_info is None


@pytest.mark.parametrize("check", ["warn", "raise"])
def test_block_weighted_pcg_reports_an_unconverged_fit(check):
    """At w = 0.99 the shared popCov preconditioner drains: on features
    scaled over three decades the CG ends at its 96-iteration cap above
    its tolerance, and both packages then warn (or raise)."""
    X, Y, _ = _weighted_problem(n=300, D=128, C=3, seed=2)
    X = X * np.logspace(0, -3, 128).astype(np.float32)
    kw = dict(block_size=128, num_iter=1, lam=1e-7, mixture_weight=0.99, solve="pcg",
              pcg_tol=1e-7, convergence_check=check)
    for est, ds in ((jwls.BlockWeightedLeastSquaresEstimator(**kw), JDataset.of),
                    (twls.BlockWeightedLeastSquaresEstimator(**kw), tds)):
        if check == "raise":
            with pytest.raises(RuntimeError, match="iteration cap"):
                est.fit(ds(X), ds(Y))
        else:
            with pytest.warns(UserWarning, match="iteration cap"):
                model = est.fit(ds(X), ds(Y))
            assert int(model.solver_info["pcg_iterations"]) == 96


def test_block_weighted_layout_follows_the_memory_budget(monkeypatch):
    X, Y, _ = _weighted_problem(n=96, D=12, C=3, seed=7)
    est = twls.BlockWeightedLeastSquaresEstimator(12, 1, 0.05, 0.5, solve="chol")
    W_normal = np_(est.fit(tds(X), tds(Y)).W)
    ran = {}
    orig = twls._class_chunk_stats_gathered

    def spy(*a, **k):
        ran["gathered"] = True
        return orig(*a, **k)

    monkeypatch.setattr(twls, "_class_chunk_stats_gathered", spy)
    monkeypatch.setattr(twls, "_device_memory_limit", lambda dev: 1)
    np.testing.assert_allclose(np_(est.fit(tds(X), tds(Y)).W), W_normal, atol=1e-4)
    assert ran.get("gathered")
    assert twls._device_memory_limit.__name__ == "<lambda>"
    monkeypatch.undo()
    assert twls._device_memory_limit(torch.device("cpu")) > 0


def test_block_weighted_rejects_what_it_does_not_port():
    """Bad options raise as in the JAX package; bf16 features fit, as the
    JAX package fits them (its chol bar, tests/ops/test_weighted_ls.py)."""
    X, Y, _ = _weighted_problem(n=40, D=8, C=2, seed=1)
    est = twls.BlockWeightedLeastSquaresEstimator(8, 1, 0.1, 0.5)
    got = est.fit(Dataset.from_array(torch.as_tensor(X).to(torch.bfloat16)), tds(Y))
    want = jwls.BlockWeightedLeastSquaresEstimator(8, 1, 0.1, 0.5).fit(
        JDataset.from_array(jnp.asarray(X, jnp.bfloat16)), JDataset.from_array(jnp.asarray(Y)))
    np.testing.assert_allclose(np_(got.W), np.asarray(want.W), atol=SOLVER_TOL)
    np.testing.assert_allclose(np_(got.intercept), np.asarray(want.intercept), atol=SOLVER_TOL)
    for bad in (dict(solve="lu"), dict(layout="rows"), dict(convergence_check="loud")):
        with pytest.raises(ValueError):
            twls.BlockWeightedLeastSquaresEstimator(8, 1, 0.1, 0.5, **bad).fit(tds(X), tds(Y))
    assert est.weight == jwls.BlockWeightedLeastSquaresEstimator(8, 1, 0.1, 0.5).weight == 4


@pytest.mark.parametrize("solve,block,dtype", [
    ("chol", 10, "bfloat16"), ("chol", 4, "bfloat16"), ("pcg", 10, "bfloat16"),
    ("pcg", 4, "bfloat16"), ("chol", 4, "float16"),
])
def test_block_weighted_low_precision_features_match_jax(solve, block, dtype):
    """bf16 (and fp16) features, as the JAX package fits the same values,
    at its tests' chol/pcg bars (tests/ops/test_weighted_ls.py)."""
    X, Y, _ = _weighted_problem()
    kw = dict(class_chunk=2, solve=solve, pcg_tol=1e-6)
    got = twls.BlockWeightedLeastSquaresEstimator(block, 2, 0.1, 0.6, **kw).fit(
        Dataset.from_array(torch.as_tensor(X).to(getattr(torch, dtype))), tds(Y))
    want = jwls.BlockWeightedLeastSquaresEstimator(block, 2, 0.1, 0.6, **kw).fit(
        JDataset.from_array(jnp.asarray(X, getattr(jnp, dtype))), JDataset.from_array(jnp.asarray(Y)))
    np.testing.assert_allclose(np_(got.W), np.asarray(want.W), atol=SOLVER_TOL)
    np.testing.assert_allclose(np_(got.intercept), np.asarray(want.intercept), atol=SOLVER_TOL)


def test_per_class_bf16_features_match_jax():
    X, Y, _ = _weighted_problem()
    got = twls.PerClassWeightedLeastSquaresEstimator(4, 2, 0.1, 0.6).fit(
        Dataset.from_array(torch.as_tensor(X).to(torch.bfloat16)), tds(Y))
    want = jwls.PerClassWeightedLeastSquaresEstimator(4, 2, 0.1, 0.6).fit(
        JDataset.from_array(jnp.asarray(X, jnp.bfloat16)), JDataset.from_array(jnp.asarray(Y)))
    np.testing.assert_allclose(np_(got.W), np.asarray(want.W), atol=SOLVER_TOL)
    np.testing.assert_allclose(np_(got.intercept), np.asarray(want.intercept), atol=SOLVER_TOL)


@pytest.mark.parametrize("solve,layout", [("pcg", "auto"), ("chol", "grouped"), ("chol", "gathered")])
def test_bf16_features_are_upcast_one_block_at_a_time(monkeypatch, solve, layout):
    """The whole X is never float32: each read takes one block, and the
    class-grouped copy keeps bf16."""
    X, Y, _ = _weighted_problem(n=60, D=24, C=3, seed=2)
    widths, grouped = [], []
    block, group = twls._block, twls._group_rows

    def spy_block(X_, start, width):
        widths.append(width)
        return block(X_, start, width)

    def spy_group(X_, *a):
        out = group(X_, *a)
        grouped.append(out[0].dtype)
        return out

    monkeypatch.setattr(twls, "_block", spy_block)
    monkeypatch.setattr(twls, "_group_rows", spy_group)
    twls.BlockWeightedLeastSquaresEstimator(8, 1, 0.1, 0.5, solve=solve, layout=layout).fit(
        Dataset.from_array(torch.as_tensor(X).to(torch.bfloat16)), tds(Y))
    assert widths and max(widths) == 8
    assert grouped == ([torch.bfloat16] if layout == "grouped" else [])


# -- the whole slice ---------------------------------------------------------

SLICE_CONF = dict(
    desc_dim=8, lam=1e-4, mixture_weight=0.25, num_classes=6, lcs_stride=8,
    lcs_border=16, lcs_patch=6, num_pca_samples_per_image=20,
    num_gmm_samples_per_image=20,
)


def _port_data(ds):
    return Dataset.from_items([LabeledImage(li.image, li.label, li.filename) for li in ds.items()])


def _fitted_parts(fitted, pca_cls, fv_classes, mapper_cls, arr):
    """(PCA matrices by input rows, GMM parameters by input rows, W,
    intercept) of a fitted flagship predictor."""
    g = fitted.graph
    pcas, gmms = {}, {}
    for nid, op in g.operators.items():
        if isinstance(op, pca_cls):
            fv = next(o for n, o in g.operators.items()
                      if isinstance(o, fv_classes) and g.dependencies[n] == (nid,))
            rows = arr(op.pca_mat).shape[0]
            pcas[rows] = arr(op.pca_mat)
            gmms[rows] = (type(fv).__name__, {f: arr(getattr(fv.gmm, f))
                                              for f in ("means", "variances", "weights")})
    (mapper,) = [o for o in g.operators.values() if isinstance(o, mapper_cls)]
    return pcas, gmms, arr(mapper.W), arr(mapper.intercept)


@pytest.fixture(scope="module", params=[2, 32], ids=["vocab2", "vocab32_fused"])
def fitted_slice(request):
    """Both packages' ``run`` on the JAX flagship test's synthetic set
    (48² images, 6 classes), and the parts of each fitted predictor; the
    fits are read here, before the pipeline environments are reset."""
    from keystone_tpu.ops.learning.block_ls import BlockLinearMapper as JMapper
    from keystone_tpu.workflow.executor import PipelineEnv as JEnv

    from keystone_tpu_torch.ops.learning.block_ls import BlockLinearMapper

    train = _synthetic_imagenet(n_per_class=6, num_classes=6, seed=0)
    test = _synthetic_imagenet(n_per_class=3, num_classes=6, seed=1)
    conf = dict(SLICE_CONF, vocab_size=request.param)
    JEnv.get_or_create().reset()
    TEnv.get_or_create().reset()
    jpred, jerr = jflagship.run(train, test, jflagship.ImageNetSiftLcsFVConfig(**conf))
    tpred, terr = tflagship.run(_port_data(train), _port_data(test),
                                tflagship.ImageNetSiftLcsFVConfig(**conf), device="cpu")
    jfit, tfit = jpred.fit(), tpred.fit()
    images = np.stack([li.image for li in test.items()])
    out = dict(
        vocab=request.param, jerr=jerr, terr=terr,
        jparts=_fitted_parts(jfit, jlearn.BatchPCATransformer,
                             (jfv.FisherVector, jfv.FisherVectorFused), JMapper, np.asarray),
        tparts=_fitted_parts(tfit, tpca.BatchPCATransformer,
                             (tfv.FisherVector, tfv.FisherVectorFused), BlockLinearMapper, np_),
        jtop5=np.asarray(jfit(JDataset.from_items(list(images))).array()),
        ttop5=np_(tfit(Dataset.from_array(torch.as_tensor(images))).array()),
        tparams=convert.flagship_params(tfit),
        images=images,
    )
    JEnv.get_or_create().reset()
    TEnv.get_or_create().reset()
    return out


def test_slice_fits_the_same_pca_and_gmms_as_jax(fitted_slice):
    jpcas, jgmms, _, _ = fitted_slice["jparts"]
    tpcas, tgmms, _, _ = fitted_slice["tparts"]
    assert sorted(tpcas) == sorted(jpcas) == [96, 128]
    for rows in (96, 128):
        np.testing.assert_allclose(tpcas[rows], jpcas[rows], atol=PCA_TOL)
        (jname, jg), (tname, tg) = jgmms[rows], tgmms[rows]
        assert tname == jname == ("FisherVectorFused" if fitted_slice["vocab"] >= 32 else "FisherVector")
        for f in ("means", "variances", "weights"):
            np.testing.assert_allclose(tg[f], jg[f], err_msg=f"{rows} {f}", **GMM_TOL)


def test_slice_fits_the_same_model_as_jax(fitted_slice):
    _, _, jW, jb = fitted_slice["jparts"]
    _, _, tW, tb = fitted_slice["tparts"]
    assert tW.shape == jW.shape == (2 * 2 * 8 * fitted_slice["vocab"], 6)
    np.testing.assert_allclose(tW, jW, atol=REF_TOL)
    np.testing.assert_allclose(tb, jb, atol=REF_TOL)


def test_slice_predicts_as_jax_and_learns(fitted_slice):
    np.testing.assert_array_equal(fitted_slice["ttop5"], fitted_slice["jtop5"])
    assert fitted_slice["terr"] == fitted_slice["jerr"]
    assert fitted_slice["terr"] <= 1.0 / 6.0


def test_slice_parameters_carry_into_a_serving_chain(fitted_slice):
    """``flagship_params`` of the fitted predictor rebuilds its featurize
    chain and head through ``flagship_from_numpy``; served, they give the
    fitted predictor's top-5."""
    from keystone_tpu_torch.serving.engine import CompiledPipeline

    params = fitted_slice["tparams"]
    assert set(params) == {"sift", "lcs", "model"}
    feat, model = convert.flagship_from_numpy(
        params, device="cpu", sift_step=3, sift_bin=4, sift_scales=4, sift_scale_step=1,
        lcs_stride=8, lcs_border=16, lcs_patch=6,
    )
    eng = CompiledPipeline(model, (8, 32), featurize=feat, device="cpu")
    np.testing.assert_array_equal(np_(eng.apply(fitted_slice["images"])), fitted_slice["ttop5"])


@pytest.fixture(scope="module")
def fit_images_chains():
    from keystone_tpu.workflow.executor import PipelineEnv as JEnv

    images = np.stack([li.image for li in _synthetic_imagenet(4, 3, seed=2).items()]).astype(np.uint8)
    kw = dict(img=48, desc_dim=8, vocab=8, sift_step=4, sift_bin=4, sift_scales=2,
              sift_scale_step=1, lcs_stride=4, lcs_border=16, lcs_patch=6, seed=1)
    JEnv.get_or_create().reset()
    TEnv.get_or_create().reset()
    jfeat, jdim = jax_build(fit_images=JDataset.from_items(list(images)), **kw)
    tfeat, tdim = torch_build(fit_images=images, device="cpu", **kw)
    JEnv.get_or_create().reset()
    TEnv.get_or_create().reset()
    return images, (jfeat, jdim), (tfeat, tdim)


def test_fit_images_featurize_matches_jax(fit_images_chains):
    images, (jfeat, jdim), (tfeat, tdim) = fit_images_chains
    assert tdim == jdim == 2 * 2 * 8 * 8
    want, got = jax_params(jfeat), convert.flagship_params(tfeat)
    assert "model" not in got
    for branch in ("sift", "lcs"):
        np.testing.assert_allclose(got[branch]["pca"], want[branch]["pca"], atol=PCA_TOL)
        for f in ("means", "variances", "weights"):
            np.testing.assert_allclose(got[branch][f], want[branch][f], err_msg=f, **GMM_TOL)
    # the JAX chain's parameters carried into the port, and the port's own
    # fit, give the JAX chain's features
    want_feats = np.asarray(jfeat._batch_run(jnp.asarray(images[:3])))
    carried, _ = convert.flagship_from_numpy(
        want, device="cpu", sift_step=4, sift_bin=4, sift_scales=2, sift_scale_step=1,
        lcs_stride=4, lcs_border=16, lcs_patch=6,
    )
    x = torch.as_tensor(images[:3])
    np.testing.assert_allclose(np_(carried._batch_run(x)), want_feats, **FITTED_FEAT_TOL)
    np.testing.assert_allclose(np_(tfeat._batch_run(x)), want_feats, **FITTED_FEAT_TOL)


def test_fit_images_params_rebuild_the_same_chain(fit_images_chains):
    images, _, (tfeat, _) = fit_images_chains
    rebuilt, model = convert.flagship_from_numpy(
        convert.flagship_params(tfeat), device="cpu", sift_step=4, sift_bin=4,
        sift_scales=2, sift_scale_step=1, lcs_stride=4, lcs_border=16, lcs_patch=6,
    )
    assert model is None
    x = torch.as_tensor(images[:3])
    torch.testing.assert_close(rebuilt._batch_run(x), tfeat._batch_run(x), rtol=0, atol=0)


def test_run_labels_and_images_go_to_the_device():
    train = _port_data(_synthetic_imagenet(n_per_class=2, num_classes=2, seed=0))
    images = on_device(tflagship.ImageExtractor.apply(train), torch.device("cpu"))
    labels = tflagship.LabelExtractor.apply(train)
    assert images.is_array and images.n == 4 and tuple(images.first().shape) == (48, 48, 3)
    np.testing.assert_array_equal(np_(labels.array()), [0, 0, 1, 1])
    assert isinstance(train.first(), LabeledImage) and not isinstance(train.first(), JLabeledImage)
    # a dataset already on the device is kept, so the pipeline's branches
    # and its solver share one source node
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert on_device(images, torch.device("cpu")) is images
    padded = Dataset.from_array(images.padded(), n=3)
    assert on_device(padded, torch.device("cpu")).padded_n == 3
