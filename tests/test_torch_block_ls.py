"""The block coordinate-descent solver and its substrate on the CPU, held
against the JAX package on the same seeded numpy inputs:
``utils/checkpoint.py``, ``ops/learning/hostsolve.py``, the host-blocks
mode of ``Dataset`` and ``ops/learning/block_ls.py`` (device and host
solves, host column blocks, checkpoint resume, bf16 features, the mapper's
blockwise apply, ``weight`` and ``cost``). Bars are the JAX tests' own:
rtol 2e-4 / atol 2e-5 between fits (tests/parallel/test_host_blocks.py:69,
tests/ops/test_checkpoint.py), 2e-3 / 2e-4 for bf16 features
(test_host_blocks.py:107), 2e-5 for a blockwise apply
(test_host_blocks.py:205)."""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from keystone_tpu.ops.learning import block_ls as jbls
from keystone_tpu.ops.learning.hostsolve import psd_solve_host as j_psd_solve_host
from keystone_tpu.parallel.dataset import Dataset as JDataset
from keystone_tpu.utils import checkpoint as jckpt
from keystone_tpu_torch.ops.learning import block_ls as tbls
from keystone_tpu_torch.ops.learning.hostsolve import psd_solve_host
from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.utils import checkpoint as tckpt

FIT_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=2e-3, atol=2e-4)
APPLY_TOL = dict(rtol=2e-5, atol=2e-5)


def _problem(n=96, d=48, k=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    Y = (
        X @ rng.standard_normal((d, k)) + 0.3 * rng.standard_normal((n, k))
    ).astype(np.float32)
    return X, Y


def jds(x, n=None):
    return JDataset.from_array(jnp.asarray(x), n=n)


def tds(x, n=None):
    return Dataset.from_array(torch.as_tensor(np.asarray(x)), n=n)


def np_(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _bf16(X):
    return X.astype(ml_dtypes.bfloat16)


# -- the substrate -----------------------------------------------------------


@pytest.mark.parametrize("lam", [0.0, 0.5])
def test_psd_solve_host_matches_jax_on_psd_and_indefinite(lam):
    rng = np.random.default_rng(1)
    A = rng.standard_normal((12, 6))
    psd = (A @ A.T).astype(np.float32)  # rank 6 of 12: Cholesky may fail at lam 0
    indefinite = np.diag(np.array([3.0, -1.0, 2.0, 0.5], np.float32))
    for G, k in ((psd, 3), (indefinite, 2)):
        rhs = rng.standard_normal((G.shape[0], k)).astype(np.float32)
        if G is indefinite:
            rhs[1] = 0.0  # the clamped eigen-direction: no component there
        got = psd_solve_host(G, rhs, lam)
        want = j_psd_solve_host(G, rhs, lam)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)
        assert np.all(np.isfinite(got))


def test_psd_solve_device_cholesky_and_its_failure_branch(monkeypatch):
    """A positive definite system takes the Cholesky path with two
    refinement steps; an indefinite one (exactly representable, so the
    clamped eigen-direction has no right-hand side) fails the factor and
    takes eigh with clamped eigenvalues, as in the JAX package and
    ``psd_solve_host``."""
    rng = np.random.default_rng(2)
    B = rng.standard_normal((40, 16)).astype(np.float32)
    gram = B.T @ B
    rhs = rng.standard_normal((16, 3)).astype(np.float32)
    want = np.asarray(jbls._psd_solve_device(jnp.asarray(gram), jnp.asarray(rhs), 0.1))
    got = tbls._psd_solve_device(torch.as_tensor(gram.copy()), torch.as_tensor(rhs), 0.1)
    np.testing.assert_allclose(np_(got), want, **FIT_TOL)

    calls = []
    eigh = torch.linalg.eigh
    monkeypatch.setattr(torch.linalg, "eigh", lambda A: calls.append(A.shape) or eigh(A))
    d = np.array([3.0, -1.0, 2.0, 0.5, 4.0, 1.5], np.float32)
    perm = rng.permutation(6)
    G = np.diag(d)[perm][:, perm]
    rhs = rng.standard_normal((6, 2)).astype(np.float32)
    rhs[np.flatnonzero(d[perm] < 0)] = 0.0
    got = np_(tbls._psd_solve_device(torch.as_tensor(G.copy()), torch.as_tensor(rhs), 0.0))
    assert calls == [(6, 6)]
    want = np.asarray(jbls._psd_solve_device(jnp.asarray(G), jnp.asarray(rhs), 0.0))
    np.testing.assert_allclose(got, want, **FIT_TOL)
    np.testing.assert_allclose(got, psd_solve_host(G, rhs), **FIT_TOL)


def test_loop_checkpointer_and_schedule_match_jax(tmp_path):
    p = str(tmp_path / "state.npz")
    ck = tckpt.LoopCheckpointer(p, every=3)
    saves = []
    for i in range(7):
        ck.tick(lambda: saves.append(i) or {"i": np.int64(i)})
    assert saves == [2, 5]
    assert int(ck.load()["i"]) == 5
    ck.clear()
    assert ck.load() is None
    with pytest.raises(ValueError):
        tckpt.LoopCheckpointer(p, every=0)
    for start in ((0, 0), (1, 2), (2, 0)):
        assert list(tckpt.two_level_schedule(3, 4, start)) == list(
            jckpt.two_level_schedule(3, 4, start))
    # the probe sees a change anywhere, and a reordering
    X, Y = _problem()
    tX, tY = torch.as_tensor(X), torch.as_tensor(Y)
    base = tckpt.data_probe(tX, tY)
    assert tckpt.data_probe(tX.clone(), tY.clone()) == base
    X2 = X.copy()
    X2[50, 7] += 1.0
    assert tckpt.data_probe(torch.as_tensor(X2), tY) != base
    assert tckpt.data_probe(torch.as_tensor(X[::-1].copy()), tY) != base
    assert tckpt.data_probe(tX.to(torch.bfloat16), tY) != base


def test_dataset_host_block_contracts():
    X, _ = _problem()
    ds = Dataset.from_host_array(X, block_size=16, device="cpu")
    want = JDataset.from_host_array(X, block_size=16)
    assert ds.is_host and not ds.is_array
    assert (ds.n, ds.padded_n, ds.block_widths) == (want.n, want.padded_n, want.block_widths)
    assert Dataset.from_host_array(X, 20, device="cpu").block_widths == [20, 20, 8]
    assert all(b.is_contiguous() and b.device.type == "cpu" for b in ds.host_blocks)
    np.testing.assert_array_equal(np_(ds.to_array_mode().array()), X)
    np.testing.assert_array_equal(np_(ds.padded()), X)
    assert ds.device.type == "cpu" and ds.mask().device.type == "cpu"
    padded = Dataset.from_host_blocks([X[:, :16]], n=90, device="cpu")
    np.testing.assert_array_equal(np_(padded.mask()), np.asarray(JDataset.from_host_blocks([X[:, :16]], n=90).mask()))
    assert "host_blocks" in repr(ds)
    with pytest.raises(ValueError):
        Dataset.from_host_blocks([], device="cpu")
    with pytest.raises(ValueError):
        Dataset.from_host_blocks([X[:10], X[:20]], device="cpu")
    with pytest.raises(ValueError):
        Dataset(arrays=torch.zeros(2), host_blocks=[torch.zeros(2, 2)])
    with pytest.raises(ValueError):
        tds(X).host_blocks
    # bf16 host blocks, from JAX's ml_dtypes arrays or from tensors
    hb = Dataset.from_host_array(_bf16(X), 16, device="cpu")
    assert hb.host_blocks[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        np_(hb.padded().to(torch.float32)), _bf16(X).astype(np.float32))


def test_host_blocks_from_batches_matches_jax():
    X, _ = _problem(n=70, d=40)
    batches = [X[:32], X[32:64], X[64:]]
    want = JDataset.host_blocks_from_batches(batches, block_size=16)
    got = Dataset.host_blocks_from_batches(
        [torch.as_tensor(b) for b in batches], block_size=16, device="cpu")
    assert got.n == want.n == 70 and got.block_widths == want.block_widths == [16, 16, 8]
    for g, w in zip(got.host_blocks, want.host_blocks):
        np.testing.assert_array_equal(np_(g), w)
    assert Dataset.host_blocks_from_batches(batches, 16, n=60, device="cpu").n == 60
    with pytest.raises(ValueError, match="changed mid-stream"):
        Dataset.host_blocks_from_batches([X[:4], X[:4, :8]], 16, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        Dataset.host_blocks_from_batches([], 16, device="cpu")
    with pytest.raises(ValueError, match="zero-width"):
        Dataset.host_blocks_from_batches([X[:4, :0]], 16, device="cpu")


# -- the solver against the JAX package --------------------------------------


def _fit_both(X, Y, n=None, host=None, **kw):
    """(JAX model, port model) on the same inputs; ``host`` = a column
    block width fits from host blocks in both packages."""
    jest = jbls.BlockLeastSquaresEstimator(**kw)
    test = tbls.BlockLeastSquaresEstimator(**kw)
    if host is None:
        jm = jest.fit(JDataset.from_array(jnp.asarray(X), n=n), jds(Y, n))
        tm = test.fit(Dataset.from_array(_torch(X), n=n), tds(Y, n))
    else:
        blocks = [X[:, s : s + host] for s in range(0, X.shape[1], host)]
        jm = jest.fit(JDataset.from_host_blocks(blocks, n=n), jds(Y, n))
        tm = test.fit(Dataset.from_host_blocks(blocks, n=n, device="cpu"), tds(Y, n))
    return jm, tm


def _torch(X):
    if X.dtype.name == "bfloat16":
        return torch.as_tensor(X.astype(np.float32)).to(torch.bfloat16)
    return torch.as_tensor(X)


def _pad(X, Y, pad):
    return (np.concatenate([X, np.zeros((pad, X.shape[1]), X.dtype)]),
            np.concatenate([Y, np.zeros((pad, Y.shape[1]), Y.dtype)]))


CASES = {
    "single_block": dict(shape=(96, 48), kw=dict(block_size=48, num_iter=1, lam=0.1)),
    "blocks_and_sweeps": dict(shape=(96, 48), kw=dict(block_size=16, num_iter=3, lam=0.1)),
    "ragged_last_block": dict(shape=(96, 40), kw=dict(block_size=16, num_iter=2, lam=0.05)),
    "padded_rows": dict(shape=(90, 48), pad=6, kw=dict(block_size=24, num_iter=2, lam=0.1)),
    "lam_0": dict(shape=(96, 32), kw=dict(block_size=16, num_iter=2, lam=0.0)),
    "host_solve": dict(shape=(96, 48), kw=dict(block_size=16, num_iter=2, lam=0.1, solve="host")),
    "host_blocks": dict(shape=(96, 48), host=16, kw=dict(block_size=16, num_iter=2, lam=0.1)),
    "host_blocks_padded": dict(shape=(90, 48), pad=6, host=24, kw=dict(block_size=24, num_iter=1, lam=0.1)),
    "bf16": dict(shape=(96, 32), bf16=True, kw=dict(block_size=16, num_iter=1, lam=0.1)),
    "bf16_host_blocks": dict(shape=(96, 32), bf16=True, host=16, kw=dict(block_size=16, num_iter=1, lam=0.1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_ls_matches_jax(case):
    c = CASES[case]
    X, Y = _problem(*c["shape"])
    n = None
    if "pad" in c:
        n = X.shape[0]
        X, Y = _pad(X, Y, c["pad"])
    if c.get("bf16"):
        X = _bf16(X)
    jm, tm = _fit_both(X, Y, n=n, host=c.get("host"), **c["kw"])
    tol = BF16_TOL if c.get("bf16") else FIT_TOL
    np.testing.assert_allclose(np_(tm.W), np.asarray(jm.W), **tol)
    np.testing.assert_allclose(np_(tm.feature_mean), np.asarray(jm.feature_mean), **tol)
    np.testing.assert_allclose(np_(tm.label_mean), np.asarray(jm.label_mean), **tol)
    np.testing.assert_allclose(np_(tm.intercept), np.asarray(jm.intercept), **tol)
    assert tm.W.dtype == torch.float32 and tm.block_size == jm.block_size
    # and the predictions, pad rows zero
    Xt = JDataset.from_array(jnp.asarray(X), n=n)
    want = np.asarray(jm.apply_batch(Xt).padded())
    got = np_(tm.apply_batch(Dataset.from_array(_torch(X), n=n)).padded())
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("num_iter", [1, 2])
def test_host_fit_matches_in_memory_fit(num_iter):
    X, Y = _problem()
    est = tbls.BlockLeastSquaresEstimator(block_size=16, num_iter=num_iter, lam=0.1)
    mem = est.fit(tds(X), tds(Y))
    host = est.fit(Dataset.from_host_array(X, 16, device="cpu"), tds(Y))
    np.testing.assert_allclose(np_(host.W), np_(mem.W), **FIT_TOL)
    np.testing.assert_allclose(np_(host.feature_mean), np_(mem.feature_mean), rtol=1e-6, atol=1e-7)
    again = est.fit(Dataset.from_host_array(X, 16, device="cpu"), tds(Y))
    np.testing.assert_array_equal(np_(again.W), np_(host.W))


def test_lam_0_with_fewer_rows_than_a_block_takes_eigh(monkeypatch):
    """n < block width: every centered Gram is singular, the factor fails
    at λ = 0, and each block is solved through eigh with its eigenvalues
    clamped (in both packages). The null space's share of W is float32
    noise amplified by the clamp, so the packages' W are not compared; the
    fit is finite and reproduces the training labels it interpolates."""
    calls = []
    eigh = torch.linalg.eigh
    monkeypatch.setattr(torch.linalg, "eigh", lambda A: calls.append(A.shape) or eigh(A))
    X, Y = _problem(n=12, d=32)
    model = tbls.BlockLeastSquaresEstimator(block_size=32, num_iter=1, lam=0.0).fit(tds(X), tds(Y))
    assert calls == [(32, 32)]
    assert bool(torch.isfinite(model.W).all())
    pred = np_(model.apply_batch(tds(X)).array())
    np.testing.assert_allclose(pred, Y, atol=0.05 * np.abs(Y).max())


def test_block_linear_mapper_blockwise_apply_matches_jax():
    X, Y = _problem()
    kw = dict(block_size=16, num_iter=1, lam=0.1)
    jm, tm = _fit_both(X, Y, **kw)
    want_seen = []
    jm.apply_and_evaluate(jds(X), lambda out: want_seen.append(np.asarray(out)))
    seen = []
    tm.apply_and_evaluate(tds(X), lambda out: seen.append(np_(out)))
    assert len(seen) == len(want_seen) == 3
    for g, w in zip(seen, want_seen):
        np.testing.assert_allclose(g, w, **APPLY_TOL)
    dense = np_(tm.apply_batch(tds(X)).array())
    np.testing.assert_allclose(seen[-1], dense, **APPLY_TOL)
    blockwise = np_(tm.apply_batch(Dataset.from_host_array(X, 16, device="cpu")).array())
    np.testing.assert_allclose(blockwise, dense, **APPLY_TOL)
    want = np.asarray(jm.apply_batch(JDataset.from_host_array(X, 16)).array())
    np.testing.assert_allclose(blockwise, want, **APPLY_TOL)
    with pytest.raises(ValueError, match="cover 32 features"):
        tm.apply_batch(Dataset.from_host_array(X[:, :32], 16, device="cpu"))


class _Interrupt(RuntimeError):
    pass


def _fail_after(k):
    def cb(done):
        if done >= k:
            raise _Interrupt(f"injected failure after {k} blocks")
    return cb


@pytest.mark.parametrize("host", [False, True])
def test_checkpoint_resume_matches_uninterrupted_fit(tmp_path, host):
    X, Y = _problem(d=40)

    def data():
        return Dataset.from_host_array(X, 16, device="cpu") if host else tds(X)

    base = tbls.BlockLeastSquaresEstimator(block_size=16, num_iter=2, lam=0.1)
    W_ref = np_(base.fit(data(), tds(Y)).W)
    jW = np.asarray(jbls.BlockLeastSquaresEstimator(block_size=16, num_iter=2, lam=0.1).fit(
        JDataset.from_host_array(X, 16) if host else jds(X), jds(Y)).W)
    np.testing.assert_allclose(W_ref, jW, **FIT_TOL)

    p = str(tmp_path / "bls.npz")
    # interrupt mid second sweep (3 blocks a sweep): a snapshot every 2
    # blocks, a failure after 4 completed block updates
    est = dataclasses.replace(base, checkpoint_path=p, checkpoint_every=2,
                              block_callback=_fail_after(4))
    with pytest.raises(_Interrupt):
        est.fit(data(), tds(Y))
    assert tckpt.LoopCheckpointer(p).load() is not None
    done = []
    resumed = dataclasses.replace(base, checkpoint_path=p, checkpoint_every=2,
                                  block_callback=done.append)
    W_res = np_(resumed.fit(data(), tds(Y)).W)
    assert done == [1, 2]  # resumed at block 5 of 6
    np.testing.assert_allclose(W_res, W_ref, **FIT_TOL)
    # a completed fit clears its snapshot
    assert tckpt.LoopCheckpointer(p).load() is None


@pytest.mark.parametrize("host", [False, True])
def test_stale_and_corrupt_snapshots_are_discarded(tmp_path, host):
    X, Y = _problem(n=64, d=32, k=2, seed=2)

    def data():
        return Dataset.from_host_array(X, 16, device="cpu") if host else tds(X)

    p = str(tmp_path / "bls.npz")
    est = tbls.BlockLeastSquaresEstimator(
        block_size=16, num_iter=2, lam=0.1, checkpoint_path=p,
        checkpoint_every=1, block_callback=_fail_after(2))
    with pytest.raises(_Interrupt):
        est.fit(data(), tds(Y))
    # resumed with another lam: the stale snapshot is ignored, and the fit
    # equals a fresh one at the new lam
    changed = tbls.BlockLeastSquaresEstimator(
        block_size=16, num_iter=2, lam=5.0, checkpoint_path=p, checkpoint_every=1)
    W_res = np_(changed.fit(data(), tds(Y)).W)
    W_ref = np_(tbls.BlockLeastSquaresEstimator(block_size=16, num_iter=2, lam=5.0).fit(
        data(), tds(Y)).W)
    np.testing.assert_allclose(W_res, W_ref, rtol=1e-6)
    # other data with the same shape: discarded too
    with pytest.raises(_Interrupt):
        est.fit(data(), tds(Y))
    W_res = np_(dataclasses.replace(est, block_callback=None).fit(data(), tds(-Y)).W)
    W_ref = np_(tbls.BlockLeastSquaresEstimator(block_size=16, num_iter=2, lam=0.1).fit(
        data(), tds(-Y)).W)
    np.testing.assert_allclose(W_res, W_ref, rtol=1e-6)
    with open(p, "wb") as f:
        f.write(b"not an npz at all")
    assert tckpt.LoopCheckpointer(p, fingerprint="x").load() is None
    np.testing.assert_allclose(
        np_(dataclasses.replace(est, block_callback=None).fit(data(), tds(Y)).W),
        np_(tbls.BlockLeastSquaresEstimator(block_size=16, num_iter=2, lam=0.1).fit(data(), tds(Y)).W),
        rtol=1e-6)


def test_weight_cost_and_bad_solve_match_jax():
    for it in (1, 3):
        j = jbls.BlockLeastSquaresEstimator(64, num_iter=it, lam=0.1)
        t = tbls.BlockLeastSquaresEstimator(64, num_iter=it, lam=0.1)
        assert t.weight == j.weight == 3 * it + 1
        for args in ((1000, 4096, 20, 1.0, 1, 1e-9, 1e-8, 1e-6), (10, 100, 2, 0.5, 8, 1.0, 2.0, 3.0)):
            assert t.cost(*args) == pytest.approx(j.cost(*args), rel=1e-12)
    assert tbls.BlockLinearMapper(torch.zeros(2, 2), 2).weight == 2
    with pytest.raises(ValueError, match="solve must be"):
        tbls.BlockLeastSquaresEstimator(16, solve="lapack").fit(tds(np.ones((4, 2))), tds(np.ones((4, 1))))


def test_host_blocks_need_cuda_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, _ = _problem()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Dataset.from_host_array(X, 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Dataset.host_blocks_from_batches([X], 16)
    assert Dataset.from_host_array(X, 16, device="cpu").device.type == "cpu"
