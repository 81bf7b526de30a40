"""The text slice's solvers on the CPU against the JAX package: Naive
Bayes (``pi``/``theta`` within rtol 1e-5 / atol 1e-6, NaN on a bad label),
the L-BFGS device driver (W within 1e-4 of JAX's device driver) and host
driver (1e-6 of JAX's, alone and in the dense estimator), ``LBFGSwithL2`` and its cost models, logistic
regression (equal predictions), LDA, ``SparseLinearMapper`` and
``EllLinearMapper`` (rtol 1e-5), the ELL normal equations (G and AᵀY
equal on integer-valued features, W within rel 1e-5 with a chunk that
does not divide n) and ``LeastSquaresEstimator``'s choice."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import sparse as jsparse

from keystone_tpu.ops.learning import classifiers as jcls
from keystone_tpu.ops.learning import lbfgs as jlbfgs
from keystone_tpu.ops.learning import sparse_ell as jell
from keystone_tpu.ops.learning.cost import TPU_CPU_WEIGHT, TPU_MEM_WEIGHT, TPU_NETWORK_WEIGHT
from keystone_tpu.ops.learning.least_squares import LeastSquaresEstimator as JLeastSquares
from keystone_tpu.ops.learning.linear import SparseLinearMapper as JSparseLinearMapper
from keystone_tpu.ops.util.nodes import Sparsify as JSparsify
from keystone_tpu.parallel.dataset import Dataset as JDataset
from keystone_tpu_torch.ops.learning import classifiers as tcls
from keystone_tpu_torch.ops.learning import lbfgs as tlbfgs
from keystone_tpu_torch.ops.learning import sparse_ell as tell
from keystone_tpu_torch.ops.learning.least_squares import LeastSquaresEstimator
from keystone_tpu_torch.ops.learning.linear import SparseLinearMapper
from keystone_tpu_torch.ops.util.nodes import Sparsify
from keystone_tpu_torch.parallel.dataset import Dataset, csr_pad_rows
from keystone_tpu_torch.workflow.chain_utils import TransformerLabelEstimatorChain

NB_TOL = dict(rtol=1e-5, atol=1e-6)


def np_(t):
    if isinstance(t, torch.Tensor):
        return (t.to_dense() if t.layout != torch.strided else t).detach().cpu().numpy()
    return np.asarray(t)


def _sparse_counts(n, d, density, seed):
    """Count-valued rows (0 to 3), about ``density`` of them nonzero."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 4, (n, d)) * (rng.random((n, d)) < density)
    return x.astype(np.float32)


def _both(x, sparse):
    """The same rows as a JAX dataset (a BCOO matrix when sparse) and a
    port dataset (a CSR matrix when sparse)."""
    if sparse:
        return (JDataset.from_array(jsparse.BCOO.fromdense(jnp.asarray(x))),
                Dataset.from_array(torch.as_tensor(x).to_sparse_csr()))
    return JDataset.from_array(jnp.asarray(x)), Dataset.from_array(torch.as_tensor(x))


# -- Naive Bayes --------------------------------------------------------------


@pytest.mark.parametrize("sparse", [False, True])
def test_naive_bayes_matches_jax(sparse):
    x = _sparse_counts(60, 40, 0.2, seed=0)
    y = np.random.default_rng(1).integers(0, 5, 60).astype(np.int32)
    jx, tx = _both(x, sparse)
    jm = jcls.NaiveBayesEstimator(5, lam=1.0).fit(jx, JDataset.from_array(jnp.asarray(y)))
    tm = tcls.NaiveBayesEstimator(5, lam=1.0).fit(tx, Dataset.from_array(torch.as_tensor(y)))
    np.testing.assert_allclose(np_(tm.pi), np.asarray(jm.pi), **NB_TOL)
    np.testing.assert_allclose(np_(tm.theta), np.asarray(jm.theta), **NB_TOL)
    scores_j = np.asarray(jm.apply_batch(jx).array())
    scores_t = np_(tm.apply_batch(tx).array())
    np.testing.assert_allclose(scores_t, scores_j, rtol=1e-5, atol=1e-4)
    assert (scores_t.argmax(1) == scores_j.argmax(1)).all()


def test_naive_bayes_pads_and_uses_the_unpadded_n():
    x = _sparse_counts(10, 8, 0.5, seed=2)
    y = np.arange(10, dtype=np.int32) % 3
    padded = Dataset.from_array(csr_pad_rows(torch.as_tensor(x).to_sparse_csr(), 16), n=10)
    jm = jcls.NaiveBayesEstimator(3).fit(JDataset.of(x), JDataset.of(y))
    tm = tcls.NaiveBayesEstimator(3).fit(padded, Dataset.of(y))
    np.testing.assert_allclose(np_(tm.pi), np.asarray(jm.pi), **NB_TOL)
    np.testing.assert_allclose(np_(tm.theta), np.asarray(jm.theta), **NB_TOL)
    out = tm.apply_batch(padded)
    assert out.padded().shape[0] == 16 and (np_(out.padded())[10:] == 0).all()


@pytest.mark.parametrize("bad", [-1, 3])
def test_naive_bayes_out_of_range_label_poisons_with_nan(bad):
    x = _sparse_counts(12, 6, 0.5, seed=3)
    y = (np.arange(12) % 3).astype(np.int32)
    y[4] = bad
    jm = jcls.NaiveBayesEstimator(3).fit(JDataset.of(x), JDataset.of(y))
    tm = tcls.NaiveBayesEstimator(3).fit(Dataset.of(x), Dataset.of(y))
    assert np.isnan(np.asarray(jm.pi)).all() and np.isnan(np_(tm.pi)).all()
    assert np.isnan(np.asarray(jm.theta)).all() and np.isnan(np_(tm.theta)).all()


# -- L-BFGS ---------------------------------------------------------------------


def _ls_problem(seed, n=120, d=8, k=3):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, d)).astype(np.float32)
    W = rng.standard_normal((d, k)).astype(np.float32)
    b = (A @ W + 0.1 * rng.standard_normal((n, k))).astype(np.float32)
    return A, b


@pytest.mark.parametrize("reg", [0.0, 0.1])
def test_device_driver_matches_jax_device_driver(reg):
    A, b = _ls_problem(4)
    n, d, k = A.shape[0], A.shape[1], b.shape[1]
    jW = jlbfgs.run_lbfgs_device(
        jlbfgs.LeastSquaresDenseGradient().regularized_vg, jnp.zeros((d, k)), 30,
        convergence_tol=1e-7,
        data=(jnp.asarray(A), jnp.asarray(b), jnp.float32(reg), jnp.float32(n)),
    )
    stats = {}
    tW = tlbfgs.run_lbfgs_device(
        tlbfgs.LeastSquaresDenseGradient().regularized_vg, torch.zeros(d, k), 30,
        convergence_tol=1e-7,
        data=(torch.as_tensor(A), torch.as_tensor(b), reg, float(n), None), stats=stats,
    )
    np.testing.assert_allclose(np_(tW), np.asarray(jW), atol=1e-4)
    assert 1 <= stats["iterations"] <= 30 and stats["vg_calls"] > stats["iterations"]
    # one read per line-search trial, and one per iteration whose search passed
    trials = stats["vg_calls"] - 1
    assert trials <= stats["host_syncs"] <= trials + stats["iterations"]


def test_device_driver_on_sparse_rows_matches_jax():
    x = _sparse_counts(80, 30, 0.15, seed=5)
    W = np.random.default_rng(6).standard_normal((30, 2)).astype(np.float32)
    b = x @ W
    jA = jsparse.BCOO.fromdense(jnp.asarray(x))
    jW = jlbfgs.run_lbfgs_device(
        jlbfgs.LeastSquaresSparseGradient().regularized_vg, jnp.zeros((30, 2)), 25,
        data=(jA, jnp.asarray(b), jnp.float32(0.01), jnp.float32(80)),
    )
    tA = torch.as_tensor(x).to_sparse_csr()
    tW = tlbfgs.run_lbfgs_device(
        tlbfgs.LeastSquaresSparseGradient().regularized_vg, torch.zeros(30, 2), 25,
        data=(tA, torch.as_tensor(b), 0.01, 80.0, None),
    )
    np.testing.assert_allclose(np_(tW), np.asarray(jW), atol=1e-4)


def test_host_driver_matches_jax_host_driver():
    A, b = _ls_problem(7)
    n, d, k = A.shape[0], A.shape[1], b.shape[1]

    def vg(w):  # float64 on both sides: the drivers alone
        W = w.reshape(d, k)
        r = A.astype(np.float64) @ W - b
        return 0.5 * float((r * r).sum()) / n, (A.T @ r / n).ravel()

    jw = jlbfgs.run_lbfgs(vg, np.zeros((d, k)), 40, convergence_tol=1e-9)
    tw = tlbfgs.run_lbfgs(vg, np.zeros((d, k)), 40, convergence_tol=1e-9)
    np.testing.assert_allclose(tw, jw, atol=1e-6, rtol=0)


@pytest.mark.parametrize("driver", ["device", "host"])
@pytest.mark.parametrize("fit_intercept", [False, True])
def test_dense_lbfgs_with_l2_matches_jax(driver, fit_intercept):
    A, b = _ls_problem(8)
    b = b + 0.7
    kw = dict(num_iterations=40, reg_param=0.01, fit_intercept=fit_intercept, driver=driver)
    jm = jlbfgs.DenseLBFGSwithL2(**kw).fit(JDataset.of(A), JDataset.of(b))
    tm = tlbfgs.DenseLBFGSwithL2(**kw).fit(Dataset.of(A), Dataset.of(b))
    tol = 1e-4 if driver == "device" else 1e-6
    np.testing.assert_allclose(np_(tm.W), np.asarray(jm.W), atol=tol)
    pj = np.asarray(jm.apply_batch(JDataset.of(A)).array())
    pt = np_(tm.apply_batch(Dataset.of(A)).array())
    np.testing.assert_allclose(pt, pj, atol=1e-3)


@pytest.mark.parametrize("driver", ["device", "host"])
def test_sparse_lbfgs_with_l2_matches_jax(driver):
    x = _sparse_counts(64, 12, 0.3, seed=9)
    b = x @ np.random.default_rng(10).standard_normal((12, 2)).astype(np.float32)
    jm = jlbfgs.SparseLBFGSwithL2(num_iterations=60, driver=driver).fit(
        JSparsify().apply_batch(JDataset.of(x)), JDataset.of(b))
    tds = Sparsify().apply_batch(Dataset.of(x))
    est = tlbfgs.SparseLBFGSwithL2(num_iterations=60, driver=driver)
    tm = est.fit(tds, Dataset.of(b))
    assert isinstance(tm, SparseLinearMapper) and not est.fit_intercept
    # float32 sparse products summed in another order than BCOO's, over 60
    # iterations, part the two fits by more than the dense test's 1e-6
    np.testing.assert_allclose(np_(tm.W), np.asarray(jm.W), atol=1e-4)
    pred = np_(tm.apply_batch(tds).array())
    assert np.abs(pred - b).max() < 0.05


def test_lbfgs_cost_models_and_weight_match_jax():
    args = (10**6, 1000, 4, 0.01, 16, TPU_CPU_WEIGHT, TPU_MEM_WEIGHT, TPU_NETWORK_WEIGHT)
    assert tlbfgs.DenseLBFGSwithL2().cost(*args) == pytest.approx(
        jlbfgs.DenseLBFGSwithL2().cost(*args), rel=1e-12)
    assert tlbfgs.SparseLBFGSwithL2().cost(*args) == pytest.approx(
        jlbfgs.SparseLBFGSwithL2().cost(*args), rel=1e-12)
    assert tlbfgs.DenseLBFGSwithL2(num_iterations=20).weight == 21
    with pytest.raises(ValueError, match="driver"):
        tlbfgs.DenseLBFGSwithL2(driver="gpu").fit(Dataset.of(np.eye(3, dtype=np.float32)),
                                                  Dataset.of(np.eye(3, dtype=np.float32)))


# -- logistic regression and LDA ------------------------------------------------


def _two_class(n, d, seed):
    x = _sparse_counts(n, d, 0.3, seed)
    w = np.random.default_rng(seed + 1).standard_normal(d)
    y = (x @ w > np.median(x @ w)).astype(np.int32)
    return x, y


@pytest.mark.parametrize("driver", ["device", "host"])
@pytest.mark.parametrize("sparse", [False, True])
def test_logistic_regression_predictions_match_jax(driver, sparse):
    x, y = _two_class(90, 20, seed=11)
    jx, tx = _both(x, sparse)
    jm = jcls.LogisticRegressionEstimator(2, num_iters=30, reg_param=1e-3, driver=driver).fit(
        jx, JDataset.of(y))
    est = tcls.LogisticRegressionEstimator(2, num_iters=30, reg_param=1e-3, driver=driver)
    tm = est.fit(tx, Dataset.of(y))
    np.testing.assert_allclose(np_(tm.W), np.asarray(jm.W), atol=1e-3)
    pj = np.asarray(jm.apply_batch(jx).array())
    pt = np_(tm.apply_batch(tx).array())
    assert (pt == pj).all()
    if driver == "device":
        assert est.fit_stats["iterations"] >= 1


def test_logistic_regression_refuses_labels_outside_the_classes():
    x, y = _two_class(20, 5, seed=12)
    y[0] = -1
    with pytest.raises(ValueError, match="class ids"):
        tcls.LogisticRegressionEstimator(2).fit(Dataset.of(x), Dataset.of(y))


def test_logistic_vg_matches_jax_on_sparse_rows():
    x, y = _two_class(40, 10, seed=13)
    W = np.random.default_rng(14).standard_normal((10, 2)).astype(np.float32)
    onehot = np.eye(2, dtype=np.float32)[y]
    mask = np.ones(40, np.float32)
    jf, jg = jcls._logistic_vg(jnp.asarray(W), jsparse.BCOO.fromdense(jnp.asarray(x)),
                               jnp.asarray(onehot), jnp.asarray(mask), 40.0, 0.1)
    tA = torch.as_tensor(x).to_sparse_csr()
    tf, tg = tcls._logistic_vg(torch.as_tensor(W), tA, torch.as_tensor(onehot),
                               torch.as_tensor(mask), 40.0, 0.1, xt=tA.t().to_sparse_csr())
    np.testing.assert_allclose(float(tf), float(jf), rtol=1e-5)
    np.testing.assert_allclose(np_(tg), np.asarray(jg), rtol=1e-5, atol=1e-6)


def test_lda_matches_jax():
    rng = np.random.default_rng(1)
    X = np.concatenate([rng.standard_normal((50, 5)) + [3, 0, 0, 0, 0],
                        rng.standard_normal((50, 5)) - [3, 0, 0, 0, 0]]).astype(np.float32)
    y = np.array([0] * 50 + [1] * 50)
    jt = jcls.LinearDiscriminantAnalysis(1).fit(JDataset.of(X), JDataset.of(y))
    tt = tcls.LinearDiscriminantAnalysis(1).fit(Dataset.of(X), Dataset.of(y))
    np.testing.assert_allclose(np_(tt.W), np.asarray(jt.W), rtol=1e-5, atol=1e-6)


# -- the sparse linear mappers --------------------------------------------------


def test_sparse_linear_mapper_matches_jax():
    x = _sparse_counts(30, 16, 0.25, seed=15)
    W = np.random.default_rng(16).standard_normal((16, 3)).astype(np.float32)
    b = np.random.default_rng(17).standard_normal(3).astype(np.float32)
    jm = JSparseLinearMapper(jnp.asarray(W), jnp.asarray(b))
    tm = SparseLinearMapper(torch.as_tensor(W), torch.as_tensor(b))
    jx, tx = _both(x, True)
    want = np.asarray(jm.apply_batch(jx).array())
    np.testing.assert_allclose(np_(tm.apply_batch(tx).array()), want, rtol=1e-5, atol=1e-6)
    one = tm.apply(tx.items()[3])
    np.testing.assert_allclose(np_(one), want[3], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np_(tm.apply_batch(Dataset.of(x)).array()), want, rtol=1e-5,
                               atol=1e-6)


def _ell(n, d, nnz, seed, integer=True):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, (n, nnz)).astype(np.int32)
    if integer:
        vals = rng.integers(-3, 4, (n, nnz)).astype(np.float32)
    else:
        vals = rng.standard_normal((n, nnz)).astype(np.float32)
    return idx, vals


def test_ell_to_dense_matches_jax_including_duplicates_and_bf16_rounding():
    idx, vals = _ell(64, 16, 6, seed=18, integer=False)
    idx[:, 1] = idx[:, 0]  # every row has a duplicate column
    idx[0, 2] = 16  # outside [0, d): dropped by both
    want = np.asarray(jell.ell_to_dense(jnp.asarray(idx), jnp.asarray(vals), 16), np.float32)
    got = tell.ell_to_dense(torch.as_tensor(idx), torch.as_tensor(vals), 16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_ell_normal_equations_equal_jax_on_integer_features():
    idx, vals = _ell(1000, 32, 5, seed=19)
    Y = np.random.default_rng(20).integers(-2, 3, (1000, 2)).astype(np.float32)
    jG, jAY = jell._normal_eq_pass(jnp.asarray(idx), jnp.asarray(vals), jnp.asarray(Y), d=32,
                                   chunk=256)
    tG, tAY = tell._normal_eq_pass(torch.as_tensor(idx), torch.as_tensor(vals),
                                   torch.as_tensor(Y), d=32, chunk=300)
    np.testing.assert_array_equal(np_(tG), np.asarray(jG))
    np.testing.assert_array_equal(np_(tAY), np.asarray(jAY))
    # bf16 labels: the bf16 x bf16 -> float32 product
    tG2, tAY2 = tell._normal_eq_pass(torch.as_tensor(idx), torch.as_tensor(vals),
                                     torch.as_tensor(Y).to(torch.bfloat16), d=32, chunk=128)
    np.testing.assert_array_equal(np_(tAY2), np.asarray(jAY))


@pytest.mark.parametrize("segment_flops", [2.5e15, 2.0 * 300 * 32 * 32])
def test_ell_solver_matches_jax(segment_flops):
    """Integer-valued features, whose Gram both packages form exactly (on
    real-valued bf16 features the JAX package's CPU Gram is not exact; the
    test below holds the port's to float64 there); a chunk of 300 rows that
    does not divide 1,000, and with the second bound, one chunk per
    segment."""
    n, d, k = 1000, 32, 2
    idx, vals = _ell(n, d, 5, seed=21)
    Y = np.random.default_rng(22).standard_normal((n, k)).astype(np.float32)
    jm = jell.EllLeastSquaresEstimator(d=d, lam=1e-2, chunk=256).fit(
        jell.ell_dataset(idx, vals), JDataset.of(Y))
    est = tell.EllLeastSquaresEstimator(d=d, lam=1e-2, chunk=300, segment_flops=segment_flops)
    tm = est.fit(tell.ell_dataset(idx, vals), Dataset.of(Y))
    assert isinstance(tm, tell.EllLinearMapper) and est.weight == 2
    jW = np.asarray(jm.W, np.float64)
    rel = np.abs(np_(tm.W) - jW).max() / np.abs(jW).max()
    assert rel < 1e-5, rel
    dense = np.zeros((n, d))
    np.add.at(dense, (np.repeat(np.arange(n), 5), idx.ravel()), vals.ravel())
    W64 = np.linalg.solve(dense.T @ dense + 1e-2 * n * np.eye(d), dense.T @ Y)
    assert np.abs(np_(tm.W) - W64).max() / np.abs(W64).max() < 1e-5


def test_ell_gram_of_real_valued_bf16_features_is_float32_accurate():
    """bf16 tiles, float32 accumulation: G and AᵀY within 1e-6 of the
    float64 products of the same tile (a Gram rounded to bf16 would stray
    by ~4e-3)."""
    idx, vals = _ell(2000, 48, 5, seed=25, integer=False)
    Y = np.random.default_rng(26).standard_normal((2000, 2)).astype(np.float32)
    G, AY = tell._normal_eq_pass(torch.as_tensor(idx), torch.as_tensor(vals),
                                 torch.as_tensor(Y), d=48, chunk=700)
    tile = tell.ell_to_dense(torch.as_tensor(idx), torch.as_tensor(vals), 48).double().numpy()
    G64, AY64 = tile.T @ tile, tile.T @ Y.astype(np.float64)
    assert np.abs(np_(G) - G64).max() / np.abs(G64).max() < 1e-6
    assert np.abs(np_(AY) - AY64).max() / np.abs(AY64).max() < 1e-6


def test_ell_linear_mapper_matches_jax_and_the_dense_product():
    n, d, k = 50, 24, 3
    idx, vals = _ell(n, d, 4, seed=23, integer=False)
    W = np.random.default_rng(24).standard_normal((d, k)).astype(np.float32)
    b = np.ones(k, np.float32)
    jm = jell.EllLinearMapper(jnp.asarray(W), intercept=jnp.asarray(b))
    tm = tell.EllLinearMapper(torch.as_tensor(W), intercept=torch.as_tensor(b))
    want = np.asarray(jm.apply_batch(jell.ell_dataset(idx, vals)).array())
    got = np_(tm.apply_batch(tell.ell_dataset(idx, vals)).array())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    dense = np.zeros((n, d), np.float32)
    for r in range(n):
        for j in range(4):
            dense[r, idx[r, j]] += vals[r, j]
    np.testing.assert_allclose(got, dense @ W + b, rtol=1e-5, atol=1e-5)


# -- LeastSquaresEstimator ------------------------------------------------------


def _choose(est, n, d, k, sparsity, seed, torch_side):
    rng = np.random.default_rng(seed)
    nnz = max(int(d * sparsity), 1)
    row = np.zeros(d, np.float32)
    row[rng.choice(d, nnz, replace=False)] = 1.0
    sample = np.tile(row, (8, 1))
    lab = np.zeros((8, k), np.float32)
    mod = Dataset if torch_side else JDataset
    return est.optimize([mod.of(sample), mod.of(lab)], n)


def _kind(chosen):
    inner = chosen.estimator if hasattr(chosen, "estimator") else chosen
    outer = type(chosen.transformer).__name__ if hasattr(chosen, "transformer") else None
    return type(inner).__name__, outer


@pytest.mark.parametrize("case", [(10**6, 128, 4, 1.0), (10**6, 100_000, 2, 0.0001)],
                         ids=["dense_small", "sparse_huge"])
def test_least_squares_estimator_picks_what_jax_picks(case):
    """Given JAX's TPU weights and the same num_machines, the port's choice
    is JAX's (tests/ops/test_classifiers.py:74-95's regimes)."""
    weights = dict(cpu_weight=TPU_CPU_WEIGHT, mem_weight=TPU_MEM_WEIGHT,
                   network_weight=TPU_NETWORK_WEIGHT)
    j = _choose(JLeastSquares(lam=1e-3, num_machines=16), *case, seed=2, torch_side=False)
    t = _choose(LeastSquaresEstimator(lam=1e-3, num_machines=16, **weights), *case, seed=2,
                torch_side=True)
    assert _kind(t) == _kind(j)
    if case[1] == 100_000:
        assert isinstance(t, TransformerLabelEstimatorChain)
        assert isinstance(t.estimator, tlbfgs.SparseLBFGSwithL2)


def test_least_squares_estimator_on_one_card_and_sparse_samples():
    est = LeastSquaresEstimator(lam=1e-3)
    x = _sparse_counts(8, 2000, 0.001, seed=25)
    x[:, 0] = 1.0
    sparse_sample = Sparsify().apply_batch(Dataset.of(x))
    chosen = est.optimize([sparse_sample, Dataset.of(np.zeros((8, 2), np.float32))], 10**7)
    assert _kind(chosen)[0] in ("SparseLBFGSwithL2", "BlockLeastSquaresEstimator",
                                "LinearMapEstimator", "DenseLBFGSwithL2")
    rng = np.random.default_rng(3)
    A = rng.standard_normal((96, 6)).astype(np.float32)
    b = A @ rng.standard_normal((6, 2)).astype(np.float32)
    model = est.fit(Dataset.of(A), Dataset.of(b))
    pred = np_(model.apply_batch(Dataset.of(A)).array())
    assert np.abs(pred - b).max() < 0.1
