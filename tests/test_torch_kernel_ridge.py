"""Kernel ridge regression (``keystone_tpu_torch/ops/learning/kernel.py``)
on the CPU, held against the JAX package and its numpy translation of the
reference on the same seeded inputs: the RBF kernel block, the device and
host solves, the permuted block order, the cached kernel against the
uncached one, checkpoint resume, and ``KernelBlockLinearMapper`` single
against batch. Bars are the JAX tests' own (tests/ops/test_kernel.py):
kernel block atol 1e-4 (:38), iterates against the reference atol 1e-3
(:73), the exact solution atol 5e-3 (:94), single against batch atol 1e-4
(:112), cached against uncached rtol 2e-5 / atol 1e-6 (:149), device
against host rtol 5e-4 / atol 5e-5 (:189)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.ops.learning import kernel as jk
from keystone_tpu.parallel.dataset import Dataset as JDataset
from keystone_tpu_torch.ops.learning import kernel as tk
from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.utils import profiling


def _rbf(A, B, gamma):
    d2 = (A * A).sum(1)[:, None] + (B * B).sum(1)[None, :] - 2 * A @ B.T
    return np.exp(-gamma * np.maximum(d2, 0))


def _np_gauss_seidel(K, Y, lam, block_size, num_epochs, permuter=None):
    """numpy translation of KernelRidgeRegression.scala:86-235, with the
    estimator's per-(permuter, epoch) block order."""
    n = K.shape[0]
    W = np.zeros((n, Y.shape[1]))
    nb = (n + block_size - 1) // block_size
    for epoch in range(num_epochs):
        order = list(range(nb))
        if permuter is not None:
            np.random.default_rng((permuter, epoch)).shuffle(order)
        for b in order:
            s, e = b * block_size, min((b + 1) * block_size, n)
            rhs = Y[s:e] - (K[:, s:e].T @ W - K[s:e, s:e].T @ W[s:e])
            W[s:e] = np.linalg.solve(K[s:e, s:e] + lam * np.eye(e - s), rhs)
    return W


def _problem(n, d, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((n, k)).astype(np.float32))


def tds(x, n=None):
    return Dataset.from_array(torch.as_tensor(x), n=n)


def jds(x, n=None):
    return JDataset.from_array(jnp.asarray(x), n=n)


def W_of(model):
    return model.model.detach().cpu().numpy()


def test_kernel_block_matches_jax_and_numpy_with_pad_rows_zero():
    rng = np.random.default_rng(0)
    X = np.zeros((44, 5), np.float32)
    X[:40] = rng.standard_normal((40, 5))
    t = tk.GaussianKernelGenerator(gamma=0.3).fit(tds(X, n=40))
    j = jk.GaussianKernelGenerator(gamma=0.3).fit(jds(X, n=40))
    got = t.kernel_matrix(tds(X, n=40)).block(0, 16).numpy()
    K = _rbf(X[:40], X[:40], 0.3)
    np.testing.assert_allclose(got[:40, :16], K[:, :16], atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(j.kernel_matrix(jds(X, n=40)).block(0, 16)),
                               atol=1e-5)
    assert not got[40:].any()
    assert not t.kernel_matrix(tds(X, n=40)).block(32, 12).numpy()[:, 8:].any()  # pad columns
    np.testing.assert_allclose(t.train_block(16, 16).numpy()[:40], K[:, 16:32], atol=1e-4)
    km = t.kernel_matrix(tds(X, n=40))
    np.testing.assert_allclose(km.diag_block(8, 8).numpy(), K[8:16, 8:16], atol=1e-4)
    rows = t.apply_batch(tds(X[:7])).array().numpy()
    np.testing.assert_allclose(rows[:, :40], K[:7], atol=1e-4)
    np.testing.assert_allclose(t.apply(torch.as_tensor(X[3])).numpy(), rows[3], atol=1e-5)
    with pytest.raises(ValueError, match="square"):
        t.kernel_matrix(tds(X[:10])).diag_block(8, 8)


@pytest.mark.parametrize("solve", ["device", "host"])
@pytest.mark.parametrize("permuter", [None, 7])
def test_krr_matches_jax_and_the_reference_iterates(solve, permuter):
    """Same epochs, same block order => the reference's iterates, and the
    JAX package's fit; n = 60 with blocks of 16 leaves a ragged last
    block."""
    X, Y = _problem(60, 4, 3, 1)
    kw = dict(lam=0.1, block_size=16, num_epochs=5, block_permuter=permuter, solve=solve)
    model = tk.KernelRidgeRegression(tk.GaussianKernelGenerator(0.5), **kw).fit(tds(X), tds(Y))
    K = _rbf(X, X, 0.5).astype(np.float64)
    W_ref = _np_gauss_seidel(K, Y.astype(np.float64), 0.1, 16, 5, permuter)
    np.testing.assert_allclose(W_of(model), W_ref, atol=1e-3)
    jmodel = jk.KernelRidgeRegression(jk.GaussianKernelGenerator(0.5), **kw).fit(jds(X), jds(Y))
    np.testing.assert_allclose(W_of(model), np.asarray(jmodel.model)[:60], atol=1e-3)
    assert tk.KernelRidgeRegression(
        tk.GaussianKernelGenerator(0.5), 0.1, 16, 5, block_permuter=permuter
    )._epoch_order(3, 9) == jk.KernelRidgeRegression(
        jk.GaussianKernelGenerator(0.5), 0.1, 16, 5, block_permuter=permuter
    )._epoch_order(3, 9)


def test_krr_converges_to_exact_and_predicts_k_w():
    X, Y = _problem(60, 4, 3, 1)
    model = tk.KernelRidgeRegression(tk.GaussianKernelGenerator(0.5), 2.0, 16, 30).fit(
        tds(X), tds(Y))
    K = _rbf(X, X, 0.5).astype(np.float64)
    W_exact = np.linalg.solve(K + 2.0 * np.eye(60), Y.astype(np.float64))
    np.testing.assert_allclose(W_of(model), W_exact, atol=5e-3)
    pred = model.apply_batch(tds(X)).array().numpy()
    np.testing.assert_allclose(pred, K @ W_exact, atol=5e-2)


def test_device_solve_matches_host_solve():
    X, Y = _problem(96, 6, 2, 9)
    base = tk.KernelRidgeRegression(tk.GaussianKernelGenerator(gamma=0.1), lam=0.4,
                                    block_size=32, num_epochs=2)
    W_dev = W_of(dataclasses.replace(base, solve="device").fit(tds(X), tds(Y)))
    W_host = W_of(dataclasses.replace(base, solve="host").fit(tds(X), tds(Y)))
    np.testing.assert_allclose(W_dev, W_host, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("n", [96, 100])
def test_cached_kernel_matches_uncached(n, monkeypatch):
    """cache_kernel=True (column blocks built once, each diagonal block
    factored once) reproduces the regenerate-per-block fit, with uniform
    blocks and with a ragged last block; auto turns it on for more than
    one epoch only."""
    X, Y = _problem(n, 5, 3, 11)
    base = tk.KernelRidgeRegression(tk.GaussianKernelGenerator(gamma=0.2), lam=0.3,
                                    block_size=32, num_epochs=3, block_permuter=5)
    W_cached = W_of(dataclasses.replace(base, cache_kernel=True).fit(tds(X), tds(Y)))
    W_plain = W_of(dataclasses.replace(base, cache_kernel=False).fit(tds(X), tds(Y)))
    np.testing.assert_allclose(W_cached, W_plain, rtol=2e-5, atol=1e-6)
    K = _rbf(X, X, 0.2).astype(np.float64)
    W_ref = _np_gauss_seidel(K, Y.astype(np.float64), 0.3, 32, 3, 5)
    np.testing.assert_allclose(W_cached, W_ref, atol=1e-3)
    cached = []
    orig = tk.KernelRidgeRegression._cached_sweeps
    monkeypatch.setattr(tk.KernelRidgeRegression, "_cached_sweeps",
                        lambda self, *a: cached.append(1) or orig(self, *a))
    base.fit(tds(X), tds(Y))
    dataclasses.replace(base, num_epochs=1).fit(tds(X), tds(Y))
    assert cached == [1]


def test_checkpoint_resume_and_block_callback(tmp_path):
    """A fit cut after 5 blocks resumes from its snapshot (every 2 blocks)
    and ends where an uninterrupted fit ends; the callback counts the
    blocks each run completed."""
    X, Y = _problem(80, 4, 2, 3)
    path = str(tmp_path / "krr.npz")
    kw = dict(lam=0.3, block_size=16, num_epochs=3, block_permuter=2)
    whole = W_of(tk.KernelRidgeRegression(tk.GaussianKernelGenerator(0.4), **kw)
                 .fit(tds(X), tds(Y)))

    class Cut(Exception):
        pass

    def cut(done):
        if done == 5:
            raise Cut

    with pytest.raises(Cut):
        tk.KernelRidgeRegression(tk.GaussianKernelGenerator(0.4), checkpoint_path=path,
                                 checkpoint_every=2, block_callback=cut, **kw).fit(tds(X), tds(Y))
    seen = []
    resumed = tk.KernelRidgeRegression(
        tk.GaussianKernelGenerator(0.4), checkpoint_path=path, checkpoint_every=2,
        block_callback=seen.append, **kw).fit(tds(X), tds(Y))
    assert seen == list(range(1, 15 - 4 + 1))  # resumed after block 4 of 15
    np.testing.assert_allclose(W_of(resumed), whole, rtol=2e-5, atol=1e-6)
    assert not (tmp_path / "krr.npz").exists()
    with pytest.warns(UserWarning, match="cache_kernel"):
        tk.KernelRidgeRegression(tk.GaussianKernelGenerator(0.4), cache_kernel=True,
                                 solve="host", **kw).fit(tds(X), tds(Y))
    with pytest.raises(ValueError, match="solve"):
        tk.KernelRidgeRegression(tk.GaussianKernelGenerator(0.4), solve="gpu",
                                 **kw).fit(tds(X), tds(Y))


def test_mapper_single_against_batch_and_phase_times(monkeypatch):
    X, Y = _problem(30, 4, 2, 2)
    published = []
    monkeypatch.setattr(profiling.PhaseTimer, "publish",
                        lambda self, registry=None: published.append(dict(self.times)))
    model = tk.KernelRidgeRegression(tk.GaussianKernelGenerator(0.4), 0.2, 8, 10).fit(
        tds(X), tds(Y))
    tk.KernelRidgeRegression(tk.GaussianKernelGenerator(0.4), 0.2, 8, 1).fit(tds(X), tds(Y))
    tk.KernelRidgeRegression(tk.GaussianKernelGenerator(0.4), 0.2, 8, 1, solve="host").fit(
        tds(X), tds(Y))
    # 10 epochs cache the kernel; one epoch on the device times whole
    # block steps; the host solve times each part of a step
    assert [list(p) for p in published] == [
        ["kernel_cache", "epoch_scan"],
        ["block_step"],
        ["kernel_block", "residual", "host_solve", "model_update"]]
    batch = model.apply_batch(tds(X)).array().numpy()
    np.testing.assert_allclose(model.apply(torch.as_tensor(X[0])).numpy(), batch[0], atol=1e-4)
    jmodel = jk.KernelRidgeRegression(jk.GaussianKernelGenerator(0.4), 0.2, 8, 10).fit(
        jds(X), jds(Y))
    np.testing.assert_allclose(batch, np.asarray(jmodel.apply_batch(jds(X)).array()), atol=1e-4)
