"""Every estimator of the port on rows sharded over 2 and 4 processes,
held against the JAX package at as many devices.

``parallel/virtual.launch`` starts the processes (gloo, a ``FileStore``
rendezvous, a time limit per launch, one launch per group size,
module-scoped); each runs ``_fits`` on its own rows of the same seeded
numpy inputs (``Dataset.shard``): the weighted solver on both paths
(``chol`` in the grouped and the gathered layout, ``pcg`` in memory and
from host blocks, also on skewed classes), the per-class weighted solver,
``LinearMapEstimator`` exact and l2, ``LocalLeastSquaresEstimator``,
``StandardScaler``, dense L-BFGS with and without the intercept,
logistic regression, naive Bayes, LDA, the local and the sketch PCA, ZCA,
the Gaussian kernel's blocks, kernel ridge regression (kernel cached and
not, and its model exported with ``convert.krr_params`` and loaded back)
and the ELL solver (sharded by the caller, and by the fit itself). The JAX side
fits the same inputs on an N-device sub-mesh of its 8 virtual devices,
each N in a spawned process of its own, beside the launches.

Bars are each estimator's JAX test's own: atol 2e-2 for the weighted
solvers (tests/ops/test_weighted_ls.py:84-87), 1e-3 / 2e-3 for the exact
linear maps (tests/ops/test_linear_solvers.py), rtol 1e-4 / 1e-3 for the
scaler (tests/ops/test_stats.py), 5e-3 for L-BFGS against ridge and 0.05
for its predictions (tests/ops/test_lbfgs.py), accuracy above 0.95 for
logistic regression, principal angles above 0.99 for the sketch PCA
(tests/ops/test_pca_zca.py), 2e-3 for the local PCA and 0.15 for ZCA's
whitened covariance (tests/ops/test_pca_zca.py), 1e-4 for kernel blocks
and 1e-3 for KRR (tests/ops/test_kernel.py), rtol 2e-2 / atol 2e-3 for ELL
(tests/ops/test_sparse_ell.py:93). Each fitted model must be identical on
every process.

``mesh.STATS`` must show that no fit gathered X. No ``all_gather`` runs
but TSQR's (width, width) R factors (the PCAs, ZCA). No row crosses
processes (STATS ``rows``, counted where ``Dataset.rows_piece`` places a
process's rows for an ``all_reduce``, the one way rows move in one) but
in three fits, each capped: kernel ridge regression and the kernel block
move a block's training rows with their K_BB and Y_B rows, each row at
most once an epoch; ``LocalLeastSquaresEstimator``'s (n, n) Gram pairs
every row, so each process's X goes to the others once, with its rows of
K and b. Every other fit's largest ``all_reduce`` is smaller than the
whole X and the same at 2 and 4 processes (a sum has the widths' size,
while a gather's pieces follow the rows a process holds), and a fit of one
pass reduces fewer bytes in all than the whole X.

Then in this process, at one shard (no process group): each sharded fit
equals the unsharded fit bit for bit, and the fits of one whole sample
(k-means++, the GMM) raise on sharded rows rather than gather them."""

import multiprocessing
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import pytest
import torch

from keystone_tpu_torch.parallel import virtual

LAUNCH_S = 150.0
WORLDS = (2, 4)
W_ATOL = 2e-2  # tests/ops/test_weighted_ls.py:84-87


def _weighted_problem(n, D, C, seed):
    """tests/ops/test_weighted_ls.py's ``_weighted_problem``."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, C, n)
    centers = rng.standard_normal((C, D)) * 2
    X = (centers[y] + rng.standard_normal((n, D))).astype(np.float32)
    return X, (2.0 * np.eye(C, dtype=np.float32)[y] - 1.0)


def _inputs():
    """Seeded numpy inputs shared by both sides; row counts that pad at 2
    or 4 shards, or both."""
    rng = np.random.default_rng(23)
    inp = {}
    inp["Xw"], inp["Yw"] = _weighted_problem(50, 10, 4, 0)
    ys = np.concatenate([np.zeros(84, np.int64), np.full(3, 1), np.full(2, 2), [3]])
    Xs = (rng.standard_normal((4, 10)) * 2)[ys] + rng.standard_normal((90, 10))
    inp["Xs"], inp["Ys"] = Xs.astype(np.float32), 2.0 * np.eye(4, dtype=np.float32)[ys] - 1.0
    A = rng.standard_normal((66, 8)).astype(np.float32)
    inp["A"], inp["Wt"] = A, rng.standard_normal((8, 3)).astype(np.float32)
    inp["b"] = A @ inp["Wt"]
    inp["b2"] = rng.standard_normal((66, 2)).astype(np.float32)
    inp["Al"] = rng.standard_normal((22, 100)).astype(np.float32)
    inp["bl"] = rng.standard_normal((22, 4)).astype(np.float32)
    inp["xs"] = (rng.standard_normal((102, 5)) * 3 + 7).astype(np.float32)
    inp["Ar"] = rng.standard_normal((202, 6)).astype(np.float32)
    inp["br"] = rng.standard_normal((202, 2)).astype(np.float32)
    A0 = rng.standard_normal((130, 10)).astype(np.float32)
    inp["A0"], inp["b0"] = A0, A0 @ rng.standard_normal((10, 3)).astype(np.float32) + 0.7
    Xl = rng.standard_normal((202, 4)).astype(np.float32)
    inp["Xl"], inp["yl"] = Xl, (Xl[:, 0] + 0.5 * Xl[:, 1] > 0).astype(np.int32)
    ynb = rng.integers(0, 3, 62)
    inp["Xnb"] = (rng.poisson(1.0, (62, 6)) + 3 * np.eye(3, 6)[ynb]).astype(np.float32)
    inp["ynb"] = ynb.astype(np.int32)
    X0 = rng.standard_normal((51, 5)) + np.array([3, 0, 0, 0, 0])
    X1 = rng.standard_normal((51, 5)) - np.array([3, 0, 0, 0, 0])
    inp["Xlda"] = np.concatenate([X0, X1]).astype(np.float32)
    inp["ylda"] = np.array([0] * 51 + [1] * 51, np.int32)
    inp["Xp"] = (rng.standard_normal((122, 3)) @ rng.standard_normal((3, 16))
                 + 0.01 * rng.standard_normal((122, 16))).astype(np.float32)
    inp["Xk"] = rng.standard_normal((62, 4)).astype(np.float32)
    inp["Yk"] = rng.standard_normal((62, 3)).astype(np.float32)
    inp["Xkb"] = rng.standard_normal((42, 5)).astype(np.float32)
    n, d, nnz = 1001, 32, 3  # tests/ops/test_sparse_ell.py:118
    idx = rng.integers(0, d, (n, nnz)).astype(np.int32)
    vals = rng.standard_normal((n, nnz)).astype(np.float32)
    dense = np.zeros((n, d), np.float32)
    np.add.at(dense, (np.repeat(np.arange(n), nnz), idx.ravel()), vals.ravel())
    inp["idx"], inp["vals"] = idx, vals
    inp["Ye"] = (dense @ rng.standard_normal((d, 2))).astype(np.float32)
    inp["Xz"] = (rng.standard_normal((102, 6)) @ rng.standard_normal((6, 6))).astype(np.float32)
    return inp


# each case: a fit of the port (``sh``: a numpy array -> its Dataset,
# placed) returning tensors; the weighted ones serve the JAX side too
def _weighted(block, iters, **kw):
    def fit(est_mod, sh, X, Y):
        m = est_mod.BlockWeightedLeastSquaresEstimator(block, iters, 0.1, 0.6, class_chunk=2,
                                                       **kw).fit(sh(X), sh(Y))
        return {"W": m.W, "b": m.intercept}
    return fit


WEIGHTED = {
    "chol_grouped": ("Xw", "Yw", _weighted(4, 2, solve="chol", layout="grouped")),
    "chol_gathered": ("Xw", "Yw", _weighted(4, 2, solve="chol", layout="gathered")),
    "pcg": ("Xw", "Yw", _weighted(4, 2, solve="pcg")),
    "skewed_chol_grouped": ("Xs", "Ys", _weighted(10, 1, solve="chol", layout="grouped")),
    "skewed_chol_gathered": ("Xs", "Ys", _weighted(10, 1, solve="chol", layout="gathered")),
    "skewed_pcg": ("Xs", "Ys", _weighted(10, 1, solve="pcg")),
}


def _cases(place, inp):
    """name -> (X's input key, a no-argument fit returning tensors), each
    dataset given to ``place`` (``Dataset.shard``, or left as it is)."""
    from keystone_tpu_torch import convert
    from keystone_tpu_torch.ops.learning import (
        classifiers,
        kernel,
        lbfgs,
        linear,
        pca,
        sparse_ell,
        weighted_ls,
        zca,
    )
    from keystone_tpu_torch.ops.stats.nodes import StandardScaler
    from keystone_tpu_torch.parallel.dataset import Dataset

    t = torch.as_tensor
    sh = lambda a: place(Dataset.from_array(t(a)))  # noqa: E731
    cases = {f"weighted_{k}": (x, lambda x=x, y=y, f=f: f(weighted_ls, sh, inp[x], inp[y]))
             for k, (x, y, f) in WEIGHTED.items()}

    def weighted_host():
        data = place(Dataset.from_host_array(t(inp["Xw"]), 4, device="cpu"))
        m = weighted_ls.BlockWeightedLeastSquaresEstimator(4, 2, 0.1, 0.6).fit(
            data, Dataset.from_array(t(inp["Yw"])))
        return {"W": m.W, "b": m.intercept}

    def per_class():
        m = weighted_ls.PerClassWeightedLeastSquaresEstimator(4, 2, 0.1, 0.6).fit(
            sh(inp["Xw"]), sh(inp["Yw"]))
        return {"W": m.W, "b": m.intercept}

    def scaler():
        ds = sh(inp["xs"])
        m = StandardScaler().fit(ds)
        return {"mean": m.mean, "std": m.std, "out": m.apply_batch(ds).local()}

    def lbfgs_icpt():
        m = lbfgs.DenseLBFGSwithL2(num_iterations=60).fit(sh(inp["A0"]), sh(inp["b0"]))
        return {"W": m.W, "pred": m.apply_batch(sh(inp["A0"])).local()}

    def logreg():
        m = classifiers.LogisticRegressionEstimator(2, num_iters=50).fit(
            sh(inp["Xl"]), Dataset.from_array(t(inp["yl"])))
        return {"W": m.W, "pred": m.apply_batch(sh(inp["Xl"])).local()}

    def nb():
        m = classifiers.NaiveBayesEstimator(3).fit(sh(inp["Xnb"]), sh(inp["ynb"]))
        return {"pi": m.pi, "theta": m.theta}

    def krr(**kw):
        m = kernel.KernelRidgeRegression(kernel.GaussianKernelGenerator(0.5), 0.1, block_size=16,
                                         num_epochs=5, **kw).fit(sh(inp["Xk"]), sh(inp["Yk"]))

        def export():  # after the fit's collectives are read: it moves every row
            back = convert.krr_from_numpy(convert.krr_params(m), device="cpu")
            return {"export_pred": back(Dataset.from_array(t(inp["Xk"]))).padded()}
        return {"W": m.model, "pred": m.apply_batch(sh(inp["Xk"])).local(), "export": export}

    def zca_fit():
        w = zca.ZCAWhitenerEstimator(eps=1e-6).fit(sh(inp["Xz"]))
        return {"whitener": w.whitener, "means": w.means}

    def kernel_block():
        tr = kernel.GaussianKernelGenerator(0.3).fit(sh(inp["Xkb"]))
        return {"K": tr.kernel_matrix(sh(inp["Xkb"])).block(0, 16)}

    def ell(where):
        data = sparse_ell.ell_dataset(inp["idx"], inp["vals"])
        m = sparse_ell.EllLeastSquaresEstimator(d=32, lam=1e-3, chunk=64).fit(
            where(data), Dataset.from_array(t(inp["Ye"])))
        return {"W": m.W}

    cases.update({
        "weighted_pcg_host": ("Xw", weighted_host),
        "per_class": ("Xw", per_class),
        "linear_map": ("A", lambda: {"W": linear.LinearMapEstimator().fit(
            sh(inp["A"]), sh(inp["b"])).W}),
        "linear_map_l2": ("A", lambda: {"W": linear.LinearMapEstimator(lam=0.7).fit(
            sh(inp["A"]), sh(inp["b2"])).W}),
        "local_ls": ("Al", lambda: {"W": linear.LocalLeastSquaresEstimator(lam=0.1).fit(
            sh(inp["Al"]), sh(inp["bl"])).W}),
        "scaler": ("xs", scaler),
        "lbfgs_l2": ("Ar", lambda: {"W": lbfgs.DenseLBFGSwithL2(
            num_iterations=100, reg_param=0.1, fit_intercept=False,
            convergence_tol=1e-10).fit(sh(inp["Ar"]), sh(inp["br"])).W}),
        "lbfgs_icpt": ("A0", lbfgs_icpt),
        "logreg": ("Xl", logreg),
        "naive_bayes": ("Xnb", nb),
        "lda": ("Xlda", lambda: {"W": classifiers.LinearDiscriminantAnalysis(1).fit(
            sh(inp["Xlda"]), sh(inp["ylda"])).W}),
        "approx_pca": ("Xp", lambda: {"P": pca.ApproximatePCAEstimator(3, seed=0).fit(
            sh(inp["Xp"])).pca_mat}),
        "pca": ("Xp", lambda: {"P": pca.PCAEstimator(3).fit(sh(inp["Xp"])).pca_mat}),
        "zca": ("Xz", zca_fit),
        "kernel_block": ("Xkb", kernel_block),
        "krr": ("Xk", krr),
        "krr_uncached": ("Xk", lambda: krr(cache_kernel=False)),
        "ell": ("idx", lambda: ell(place)),
        "ell_self_sharded": ("idx", lambda: ell(lambda d: d)),  # the fit shards it
    })
    return cases


# the model's tensors, each held whole on every process
MODEL_KEYS = ("W", "b", "mean", "std", "pi", "theta", "P", "whitener", "means",
              "export_pred")


def _run(fit):
    """A case's tensors, with what its ``export`` step (if any) gives,
    and the collectives of the fit alone."""
    import keystone_tpu_torch.parallel.mesh as mesh_lib

    mesh_lib.reset_stats()
    got = fit()
    stats = {k: list(v) for k, v in mesh_lib.STATS.items()}
    after = got.pop("export", None)
    if after is not None:
        got.update(after())
    return got, stats


def _fits(inp):
    """One process's part of every sharded fit, with the collectives each
    ran, the bytes of this process's rows of X, and each model gathered
    from every process."""
    import keystone_tpu_torch.parallel.mesh as mesh_lib
    from keystone_tpu_torch.parallel import runtime
    from keystone_tpu_torch.parallel.dataset import Dataset

    mesh = mesh_lib.current_mesh()
    out = {"rank": runtime.process_index(), "jax_imported": "jax" in sys.modules}
    for name, (xkey, fit) in _cases(Dataset.shard, inp).items():
        got, stats = _run(fit)
        every = {k: mesh_lib.all_gather_rows(v[None].contiguous(), mesh) for k, v in got.items()
                 if k in MODEL_KEYS}
        x = inp[xkey]
        row_bytes = x[0].nbytes + (inp["vals"][0].nbytes if xkey == "idx" else 0)
        per = Dataset.from_array(torch.as_tensor(x)).shard(mesh).local_n
        out[name] = dict(got, stats=stats, every=every, x_local_bytes=per * row_bytes,
                         local_n=per)
    out["jax_imported_after"] = "jax" in sys.modules
    return out


def _launch(inp, world):
    t0 = time.monotonic()
    got = virtual.launch(_fits, world, (inp,), device="cpu", timeout_s=LAUNCH_S, threads=1)
    return got, time.monotonic() - t0


def _jax_mesh(world):
    import jax

    from keystone_tpu.parallel import mesh as jmesh

    return jmesh.make_mesh(n_data=world, devices=jax.devices()[:world])


def _jax_fits(inp, world):
    """The JAX package's fits of the same inputs on a ``world``-device
    sub-mesh, as numpy."""
    import jax.numpy as jnp

    from keystone_tpu.ops.learning import classifiers as jcls
    from keystone_tpu.ops.learning import kernel as jkernel
    from keystone_tpu.ops.learning import lbfgs as jlbfgs
    from keystone_tpu.ops.learning import linear as jlinear
    from keystone_tpu.ops.learning import pca as jpca
    from keystone_tpu.ops.learning import sparse_ell as jell
    from keystone_tpu.ops.learning import weighted_ls as jwls
    from keystone_tpu.ops.learning import zca as jzca
    from keystone_tpu.ops.stats.nodes import StandardScaler as JScaler
    from keystone_tpu.parallel import mesh as jmesh
    from keystone_tpu.parallel.dataset import Dataset as JDataset

    jm = _jax_mesh(world)
    sh = lambda a: JDataset.of(a).shard(jm)  # noqa: E731
    np_ = lambda a: np.asarray(a)  # noqa: E731
    got = {}
    with jmesh.use_mesh(jm):
        for k, (x, y, f) in WEIGHTED.items():
            got[f"weighted_{k}"] = {k2: np_(v) for k2, v in f(jwls, sh, inp[x], inp[y]).items()}
        m = jwls.BlockWeightedLeastSquaresEstimator(4, 2, 0.1, 0.6).fit(
            JDataset.from_host_array(inp["Xw"], 4), JDataset.of(inp["Yw"]))
        got["weighted_pcg_host"] = {"W": np_(m.W), "b": np_(m.intercept)}
        m = jwls.PerClassWeightedLeastSquaresEstimator(4, 2, 0.1, 0.6).fit(sh(inp["Xw"]),
                                                                           sh(inp["Yw"]))
        got["per_class"] = {"W": np_(m.W), "b": np_(m.intercept)}
        got["linear_map"] = {"W": np_(jlinear.LinearMapEstimator().fit(
            sh(inp["A"]), sh(inp["b"])).W)}
        got["linear_map_l2"] = {"W": np_(jlinear.LinearMapEstimator(lam=0.7).fit(
            sh(inp["A"]), sh(inp["b2"])).W)}
        got["local_ls"] = {"W": np_(jlinear.LocalLeastSquaresEstimator(lam=0.1).fit(
            sh(inp["Al"]), sh(inp["bl"])).W)}
        m = JScaler().fit(sh(inp["xs"]))
        got["scaler"] = {"mean": np_(m.mean), "std": np_(m.std),
                         "out": np_(m.apply_batch(sh(inp["xs"])).padded())}
        got["lbfgs_l2"] = {"W": np_(jlbfgs.DenseLBFGSwithL2(
            num_iterations=100, reg_param=0.1, fit_intercept=False,
            convergence_tol=1e-10).fit(sh(inp["Ar"]), sh(inp["br"])).W)}
        m = jlbfgs.DenseLBFGSwithL2(num_iterations=60).fit(sh(inp["A0"]), sh(inp["b0"]))
        got["lbfgs_icpt"] = {"pred": np_(m.apply_batch(JDataset.of(inp["A0"])).array())}
        m = jcls.LogisticRegressionEstimator(2, num_iters=50).fit(sh(inp["Xl"]),
                                                                  JDataset.of(inp["yl"]))
        got["logreg"] = {"W": np_(m.W)}
        m = jcls.NaiveBayesEstimator(3).fit(sh(inp["Xnb"]), sh(inp["ynb"]))
        got["naive_bayes"] = {"pi": np_(m.pi), "theta": np_(m.theta)}
        got["lda"] = {"W": np_(jcls.LinearDiscriminantAnalysis(1).fit(
            sh(inp["Xlda"]), sh(inp["ylda"])).W)}
        got["approx_pca"] = {"P": np_(jpca.ApproximatePCAEstimator(3, seed=0).fit(
            sh(inp["Xp"])).pca_mat)}
        got["pca"] = {"P": np_(jpca.PCAEstimator(3).fit(sh(inp["Xp"])).pca_mat)}
        w = jzca.ZCAWhitenerEstimator(eps=1e-6).fit(sh(inp["Xz"]))
        got["zca"] = {"whitener": np_(w.whitener), "means": np_(w.means)}
        tr = jkernel.GaussianKernelGenerator(0.3).fit(sh(inp["Xkb"]))
        got["kernel_block"] = {"K": np_(tr.kernel_matrix(sh(inp["Xkb"])).block(0, 16))}
        m = jkernel.KernelRidgeRegression(jkernel.GaussianKernelGenerator(0.5), 0.1,
                                          block_size=16, num_epochs=5).fit(sh(inp["Xk"]),
                                                                           sh(inp["Yk"]))
        got["krr"] = {"W": np_(m.model), "pred": np_(m.apply_batch(sh(inp["Xk"])).padded())}
        m = jell.EllLeastSquaresEstimator(d=32, lam=1e-3, chunk=64).fit(
            jell.ell_dataset(jnp.asarray(inp["idx"]), jnp.asarray(inp["vals"])),
            JDataset.from_array(jnp.asarray(inp["Ye"])))
        got["ell"] = {"W": np_(m.W)}
    got["krr_uncached"] = got["krr"]
    got["ell_self_sharded"] = got["ell"]
    return got


def _jax_process(inp, world):
    """``_jax_fits`` in a spawned process of its own: its 8 virtual
    devices are set before JAX starts there."""
    from keystone_tpu.parallel.virtual import provision_devices

    provision_devices(8, probe_real=False)
    return _jax_fits(inp, world)


@pytest.fixture(scope="module")
def runs():
    """Both launches side by side, and beside them the JAX fits of each
    group size in a process of its own (each sets the JAX package's
    current mesh; their XLA compiles take longer than the launches)."""
    inp = _inputs()
    spawn = multiprocessing.get_context("spawn")
    with ThreadPoolExecutor(len(WORLDS)) as threads, \
            ProcessPoolExecutor(len(WORLDS), mp_context=spawn) as procs:
        jax_side = {w: procs.submit(_jax_process, inp, w) for w in WORLDS}
        launches = {w: threads.submit(_launch, inp, w) for w in WORLDS}
        got = {w: f.result() for w, f in launches.items()}
        return inp, got, {w: f.result(timeout=LAUNCH_S) for w, f in jax_side.items()}


NAMES = ["weighted_" + k for k in WEIGHTED] + [
    "weighted_pcg_host", "per_class", "linear_map", "linear_map_l2", "local_ls", "scaler",
    "lbfgs_l2", "lbfgs_icpt", "logreg", "naive_bayes", "lda", "approx_pca", "pca", "zca",
    "kernel_block", "krr", "krr_uncached", "ell", "ell_self_sharded"]
# the all_gathers a fit may run: TSQR's (width, width) R factors
R_WIDTH = {"approx_pca": 13, "pca": 16, "zca": 6}  # the sketch: dims 3 + oversampling 10
# the fits of one pass over the rows (the others iterate)
ONE_PASS = {"linear_map", "linear_map_l2", "scaler", "naive_bayes", "lda", "pca", "zca",
            "ell", "ell_self_sharded"}
# the fits whose algorithm pairs rows held by different processes
ROW_MOVERS = ("local_ls", "kernel_block", "krr", "krr_uncached")


def _row_cap(inp, name, local_n):
    """The bytes of this process's rows that a fit whose algorithm moves
    rows may place for an ``all_reduce`` (None: it may move none)."""
    if name not in ROW_MOVERS:
        return None
    if name == "local_ls":  # its X once, and its rows of K (n wide) and b
        n, d = inp["Al"].shape
        return 4 * local_n * (d + n + inp["bl"].shape[1])
    if name == "kernel_block":  # the block's rows, their norms and mask
        return 4 * 16 * (inp["Xkb"].shape[1] + 2)
    # kernel ridge regression: each row at most once an epoch, and once
    # more for the cached kernel or the predictions, with its K_BB and Y_B
    # rows
    d, k = inp["Xk"].shape[1], inp["Yk"].shape[1]
    return 4 * (5 + 1) * local_n * (d + 2 + 16 + k)


def _local_cat(res, name, key):
    return np.concatenate([np.asarray(r[name][key]) for r in res])


# -- the launches ---------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_workers_import_no_jax_and_launch_in_time(runs, world):
    _, got, _ = runs
    res, seconds = got[world]
    assert [r["rank"] for r in res] == list(range(world))
    for r in res:
        assert not r["jax_imported"] and not r["jax_imported_after"], r["rank"]
    assert seconds < LAUNCH_S


@pytest.mark.parametrize("name", [n for n in NAMES if n != "kernel_block"])  # rows, no model
@pytest.mark.parametrize("world", WORLDS)
def test_model_identical_on_every_rank(runs, world, name):
    _, got, _ = runs
    res, _ = got[world]
    for r in res:
        assert r[name]["every"], name
        for key, every in r[name]["every"].items():
            for other in every:  # gathered on each process: the same bytes
                np.testing.assert_array_equal(np.asarray(other), np.asarray(r[name][key]))
            np.testing.assert_array_equal(np.asarray(r[name][key]), np.asarray(res[0][name][key]))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("world", WORLDS)
def test_no_fit_gathers_x(runs, world, name):
    """No ``all_gather`` but TSQR's R factors; rows cross processes only
    in the three fits whose algorithm pairs rows, each within its cap;
    every other fit reduces less than the whole X in one call, and in all
    when it makes one pass."""
    inp, got, _ = runs
    res, _ = got[world]
    for r in res:
        stats, x_local = r[name]["stats"], r[name]["x_local_bytes"]
        gathers = stats.get("all_gather", [0, 0, 0])
        if name in R_WIDTH:
            assert 0 < gathers[2] <= R_WIDTH[name] ** 2 * 4 < x_local, gathers
        else:
            assert gathers[0] == 0, (name, gathers)
        calls, total, largest = stats["all_reduce"]
        assert calls >= 1, (name, stats)
        rows = stats.get("rows", [0, 0, 0])
        cap = _row_cap(inp, name, r[name]["local_n"])
        if cap is None:
            assert rows[0] == 0, (name, rows)
            assert largest < world * x_local, (name, stats, x_local)
            if name in ONE_PASS:
                assert total < world * x_local, (name, stats, x_local)
        else:
            assert rows[1] <= cap, (name, rows, cap)
        if name.startswith("krr"):
            w, d, k = 16, inp["Xk"].shape[1], inp["Yk"].shape[1]
            block = 4 * max(w * d + 2 * w, w * k + w * w + w * k)
            assert largest <= block, stats


@pytest.mark.parametrize("name", [n for n in NAMES if n not in ROW_MOVERS])
def test_reduces_do_not_grow_with_the_rows_a_process_holds(runs, name):
    """A fit's largest ``all_reduce`` is a sum of the widths' size: the
    same at 2 processes as at 4, where each holds about half as many rows
    (a gather's pieces would shrink with them)."""
    _, got, _ = runs
    largest = {w: {r[name]["stats"]["all_reduce"][2] for r in got[w][0]} for w in WORLDS}
    assert largest[2] == largest[4], largest


# -- against the JAX package ----------------------------------------------------


@pytest.mark.parametrize("name", ["weighted_" + k for k in WEIGHTED]
                         + ["weighted_pcg_host", "per_class"])
@pytest.mark.parametrize("world", WORLDS)
def test_weighted_solvers_match_jax(runs, world, name):
    _, got, jax_got = runs
    want = jax_got[world][name]
    for r in got[world][0]:
        np.testing.assert_allclose(np.asarray(r[name]["W"]), want["W"], atol=W_ATOL)
        np.testing.assert_allclose(np.asarray(r[name]["b"]), want["b"], atol=W_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_weighted_fit_classifies_its_training_rows(runs, world):
    inp, got, _ = runs
    W, b = (np.asarray(got[world][0][0]["weighted_pcg"][k]) for k in ("W", "b"))
    assert ((inp["Xw"] @ W + b).argmax(1) == inp["Yw"].argmax(1)).mean() > 0.9


@pytest.mark.parametrize("world", WORLDS)
def test_linear_maps_match_jax(runs, world):
    inp, got, jax_got = runs
    want = jax_got[world]
    for r in got[world][0]:
        np.testing.assert_allclose(np.asarray(r["linear_map"]["W"]), inp["Wt"], atol=1e-3)
        np.testing.assert_allclose(np.asarray(r["linear_map"]["W"]), want["linear_map"]["W"],
                                   atol=1e-3)
        np.testing.assert_allclose(np.asarray(r["linear_map_l2"]["W"]),
                                   want["linear_map_l2"]["W"], atol=2e-3)
        A, b = inp["Al"].astype(np.float64), inp["bl"].astype(np.float64)
        expect = A.T @ np.linalg.solve(A @ A.T + 0.1 * len(A) * np.eye(len(A)), b)
        np.testing.assert_allclose(np.asarray(r["local_ls"]["W"]), expect, atol=2e-3)
        np.testing.assert_allclose(np.asarray(r["local_ls"]["W"]), want["local_ls"]["W"],
                                   atol=2e-3)


@pytest.mark.parametrize("world", WORLDS)
def test_standard_scaler_matches_jax(runs, world):
    inp, got, jax_got = runs
    res = got[world][0]
    want = jax_got[world]["scaler"]
    for r in res:
        np.testing.assert_allclose(np.asarray(r["scaler"]["mean"]), want["mean"], rtol=1e-4)
        np.testing.assert_allclose(np.asarray(r["scaler"]["std"]), want["std"], rtol=1e-3)
    out = _local_cat(res, "scaler", "out")
    np.testing.assert_allclose(out, want["out"], rtol=1e-3, atol=1e-4)
    assert not out[len(inp["xs"]):].any()  # pad rows stay zero


@pytest.mark.parametrize("world", WORLDS)
def test_dense_lbfgs_matches_ridge_and_jax(runs, world):
    inp, got, jax_got = runs
    A, b = inp["Ar"].astype(np.float64), inp["br"].astype(np.float64)
    n = len(A)
    ridge = np.linalg.solve(A.T @ A / n + 0.1 * np.eye(A.shape[1]), A.T @ b / n)
    res = got[world][0]
    for r in res:
        np.testing.assert_allclose(np.asarray(r["lbfgs_l2"]["W"]), ridge, atol=5e-3)
        np.testing.assert_allclose(np.asarray(r["lbfgs_l2"]["W"]),
                                   jax_got[world]["lbfgs_l2"]["W"], atol=5e-3)
    pred = _local_cat(res, "lbfgs_icpt", "pred")[: len(inp["b0"])]
    assert np.abs(pred - inp["b0"]).max() < 0.05
    assert np.abs(pred - jax_got[world]["lbfgs_icpt"]["pred"]).max() < 0.05


@pytest.mark.parametrize("world", WORLDS)
def test_logistic_regression_separates_as_jax(runs, world):
    inp, got, jax_got = runs
    res = got[world][0]
    pred = _local_cat(res, "logreg", "pred")[: len(inp["yl"])]
    assert (pred == inp["yl"]).mean() > 0.95
    jpred = (inp["Xl"] @ jax_got[world]["logreg"]["W"]).argmax(1)
    assert (pred == jpred).mean() > 0.95


@pytest.mark.parametrize("world", WORLDS)
def test_naive_bayes_and_lda_match_jax(runs, world):
    _, got, jax_got = runs
    want = jax_got[world]
    for r in got[world][0]:
        np.testing.assert_allclose(np.asarray(r["naive_bayes"]["pi"]), want["naive_bayes"]["pi"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(r["naive_bayes"]["theta"]),
                                   want["naive_bayes"]["theta"], rtol=1e-5, atol=1e-5)
        w, jw = np.asarray(r["lda"]["W"])[:, 0], want["lda"]["W"][:, 0]
        np.testing.assert_allclose(w * np.sign(w @ jw), jw, atol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_sketch_pca_spans_the_principal_subspace_as_jax(runs, world):
    inp, got, jax_got = runs
    X = inp["Xp"].astype(np.float64)
    exact = np.linalg.svd(X - X.mean(0), full_matrices=False)[2][:3].T
    for r in got[world][0]:
        P = np.asarray(r["approx_pca"]["P"])
        assert np.linalg.svd(exact.T @ P, compute_uv=False).min() > 0.99
        assert np.linalg.svd(jax_got[world]["approx_pca"]["P"].T @ P, compute_uv=False).min() > 0.99


@pytest.mark.parametrize("world", WORLDS)
def test_kernel_blocks_and_krr_match_jax(runs, world):
    inp, got, jax_got = runs
    res = got[world][0]
    want = jax_got[world]
    n = len(inp["Xkb"])
    K = _local_cat(res, "kernel_block", "K")
    np.testing.assert_allclose(K[:n], want["kernel_block"]["K"][:n], atol=1e-4)
    assert not K[n:].any()
    nk = len(inp["Xk"])
    for name in ("krr", "krr_uncached"):
        for r in res:
            np.testing.assert_allclose(np.asarray(r[name]["W"])[:nk], want["krr"]["W"][:nk],
                                       atol=1e-3)
        pred = _local_cat(res, name, "pred")[:nk]
        np.testing.assert_allclose(pred, want["krr"]["pred"][:nk], atol=1e-3)
        for r in res:  # exported with convert.krr_params, loaded back whole
            np.testing.assert_allclose(np.asarray(r[name]["export_pred"]),
                                       want["krr"]["pred"][:nk], atol=1e-3)


@pytest.mark.parametrize("world", WORLDS)
def test_local_pca_and_zca_match_jax(runs, world):
    inp, got, jax_got = runs
    want = jax_got[world]
    X = inp["Xz"].astype(np.float64)
    for r in got[world][0]:
        np.testing.assert_allclose(np.asarray(r["pca"]["P"]), want["pca"]["P"], atol=2e-3)
        W, mu = np.asarray(r["zca"]["whitener"]), np.asarray(r["zca"]["means"])
        np.testing.assert_allclose(mu, want["zca"]["means"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(W, W.T, atol=1e-4)
        out = (X - mu) @ W
        np.testing.assert_allclose(out.T @ out / (len(X) - 1), np.eye(6), atol=0.15)
        np.testing.assert_allclose(W, want["zca"]["whitener"], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("name", ["ell", "ell_self_sharded"])
@pytest.mark.parametrize("world", WORLDS)
def test_ell_solve_on_sharded_rows_matches_jax(runs, world, name):
    _, got, jax_got = runs
    for r in got[world][0]:
        np.testing.assert_allclose(np.asarray(r[name]["W"]), jax_got[world]["ell"]["W"],
                                   rtol=2e-2, atol=2e-3)
        assert r[name]["stats"]["all_reduce"][0] == 1  # G and AᵀY together


# -- one shard, in this process ----------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_one_shard_fit_equals_the_unsharded_fit_bit_for_bit(name):
    """No process group: a sharded dataset's mesh is this process alone,
    its sums go through ``all_sum``'s reduce path, and the fit must give
    the unsharded fit's bytes."""
    from keystone_tpu_torch.parallel.dataset import Dataset

    inp = _inputs()
    got, _ = _run(_cases(Dataset.shard, inp)[name][1])
    want, _ = _run(_cases(lambda ds: ds, inp)[name][1])
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), (name, k)


@pytest.mark.parametrize("make", ["kmeans", "gmm"])
def test_one_sample_fits_refuse_sharded_rows(make):
    from keystone_tpu_torch.ops.learning import gmm, kmeans
    from keystone_tpu_torch.parallel.dataset import Dataset

    est = {"kmeans": kmeans.KMeansPlusPlusEstimator(2, 3),
           "gmm": gmm.GaussianMixtureModelEstimator(2)}[make]
    X = torch.as_tensor(np.random.default_rng(0).standard_normal((40, 3)).astype(np.float32))
    with pytest.raises(NotImplementedError, match="A12"):
        est.fit(Dataset.from_array(X).shard())
    est.fit(Dataset.from_array(X))  # unsharded rows fit as before
