"""Fits past the card's memory, and the flagship's other estimators, on
the CPU against the JAX package on the same seeded numpy inputs: the
weighted solver on host column blocks (``_fit_pcg_host``), the streamed
featurize → host blocks → weighted fit composition of
tests/pipelines/test_stream_to_hostblocks.py, and
``PerClassWeightedLeastSquaresEstimator`` and ``ApproximatePCAEstimator``.

Bars are the JAX tests' own: rtol 2e-4 / atol 2e-5 between fits
(test_stream_to_hostblocks.py:111, test_host_blocks.py:69), the port's
solver bar 5e-4 against JAX's solves (tests/test_torch_training.py), the
principal-angle bar 0.99 (tests/ops/test_pca_zca.py:55-61), and 1e-4
between the two packages' sketch PCAs given the same draw. Where the two
packages fit features that they computed each on their own, the solver
bar holds them."""

import io
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_fixtures import jpeg_array
from keystone_tpu.loaders.streaming import StreamingImageNetLoader as JStreamingImageNetLoader
from keystone_tpu.ops.learning import pca as jpca
from keystone_tpu.ops.learning import weighted_ls as jwls
from keystone_tpu.ops.util.nodes import ClassLabelIndicators as JIndicators
from keystone_tpu.parallel.dataset import Dataset as JDataset
from keystone_tpu_torch.loaders.streaming import StreamingImageNetLoader
from keystone_tpu_torch.ops.learning import pca as tpca
from keystone_tpu_torch.ops.learning import weighted_ls as twls
from keystone_tpu_torch.ops.util.nodes import ClassLabelIndicators
from keystone_tpu_torch.parallel.dataset import Dataset
from ops.test_weighted_ls import _weighted_problem

FIT_TOL = dict(rtol=2e-4, atol=2e-5)
SOLVER_TOL = 5e-4
SKETCH_TOL = 1e-4
CHOL_ON_HOST = "host-blocks datasets require the pcg solver"


def np_(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def tds(x, n=None):
    return Dataset.from_array(torch.as_tensor(np.asarray(x)), n=n)


def _split(X, widths):
    starts = np.cumsum([0] + list(widths[:-1]))
    return [np.ascontiguousarray(X[:, s : s + w]) for s, w in zip(starts, widths)]


def _host(X, widths):
    return Dataset.from_host_blocks(_split(X, widths), device="cpu")


def _jhost(X, widths):
    return JDataset.from_host_blocks(_split(X, widths))


@pytest.fixture
def host_dataset_spy(monkeypatch):
    """Records every ``to_array_mode`` of a host-blocks dataset: the call
    that would put the whole feature matrix on the card."""
    calls = []
    orig = Dataset.to_array_mode

    def spy(self):
        if self.is_host:
            calls.append(self)
        return orig(self)

    monkeypatch.setattr(Dataset, "to_array_mode", spy)
    return calls


# -- the repaired fault: host blocks in the weighted solver ------------------


def test_chol_on_host_blocks_raises_as_in_jax(host_dataset_spy):
    """The port used to gather every host block onto the card and fit with
    the chol solver; the JAX package refuses. Both raise now, before any
    block moves."""
    X, Y, _ = _weighted_problem(n=60, D=16, C=3, seed=4)
    kw = dict(block_size=8, num_iter=1, lam=0.1, mixture_weight=0.5, solve="chol")
    with pytest.raises(ValueError, match=CHOL_ON_HOST):
        jwls.BlockWeightedLeastSquaresEstimator(**kw).fit(_jhost(X, [8, 8]), JDataset.of(Y))
    with pytest.raises(ValueError, match=CHOL_ON_HOST):
        twls.BlockWeightedLeastSquaresEstimator(**kw).fit(_host(X, [8, 8]), tds(Y))
    assert host_dataset_spy == []


HOST_CASES = [
    # (widths of the host blocks, block_size the estimator is given, num_iter)
    ([8, 8, 8], 8, 1),
    ([8, 8, 8], 8, 2),
    ([10, 10, 4], 7, 2),  # ragged tail; block_size is not read
    ([24], 3, 1),
]


@pytest.mark.parametrize("widths,block_size,num_iter", HOST_CASES,
                         ids=[f"{w}-bs{b}-it{i}" for w, b, i in HOST_CASES])
@pytest.mark.parametrize("solve", ["auto", "pcg"])
def test_fit_pcg_host_matches_jax(host_dataset_spy, widths, block_size, num_iter, solve):
    X, Y, _ = _weighted_problem(n=120, D=24, C=4, seed=3)
    kw = dict(block_size=block_size, num_iter=num_iter, lam=0.05, mixture_weight=0.4,
              solve=solve)
    want = jwls.BlockWeightedLeastSquaresEstimator(**kw).fit(_jhost(X, widths), JDataset.of(Y))
    got = twls.BlockWeightedLeastSquaresEstimator(**kw).fit(_host(X, widths), tds(Y))
    assert host_dataset_spy == []
    np.testing.assert_allclose(np_(got.W), np.asarray(want.W), **FIT_TOL)
    np.testing.assert_allclose(np_(got.intercept), np.asarray(want.intercept), **FIT_TOL)
    assert float(got.solver_info["pcg_max_rel_residual"]) < 1e-5
    assert 0 < got.solver_info["pcg_iterations"] <= 96


@pytest.mark.parametrize("num_iter", [1, 2])
def test_host_fit_matches_in_device_fit_on_the_datasets_own_blocks(num_iter):
    """The host path's coordinate blocks are the dataset's column blocks,
    whatever ``block_size`` says: a fit from blocks of widths (10, 10, 4)
    given block_size 5 equals the in-device fit at block_size 10."""
    X, Y, _ = _weighted_problem(n=96, D=24, C=3, seed=6)
    common = dict(num_iter=num_iter, lam=0.1, mixture_weight=0.5, solve="pcg")
    host = twls.BlockWeightedLeastSquaresEstimator(5, **common).fit(_host(X, [10, 10, 4]), tds(Y))
    dense = twls.BlockWeightedLeastSquaresEstimator(10, **common).fit(tds(X), tds(Y))
    np.testing.assert_allclose(np_(host.W), np_(dense.W), **FIT_TOL)
    np.testing.assert_allclose(np_(host.intercept), np_(dense.intercept), **FIT_TOL)
    assert host.block_size == 5  # the estimator's, as JAX's mapper keeps it


def test_host_fit_warns_or_raises_like_the_in_device_fit():
    X, Y, _ = _weighted_problem(n=300, D=128, C=3, seed=2)
    X = X * np.logspace(0, -3, 128).astype(np.float32)
    kw = dict(block_size=128, num_iter=1, lam=1e-7, mixture_weight=0.99, solve="pcg",
              pcg_tol=1e-7, convergence_check="raise")
    with pytest.raises(RuntimeError, match="iteration cap"):
        twls.BlockWeightedLeastSquaresEstimator(**kw).fit(_host(X, [128]), tds(Y))
    # bf16 host blocks fit as the JAX package fits the same bf16 values
    bf16 = [b.astype(jnp.bfloat16) for b in _split(X[:, :16], [8, 8])]
    got = twls.BlockWeightedLeastSquaresEstimator(8, 1, 0.1, 0.5).fit(
        Dataset.from_host_blocks([torch.as_tensor(b.astype(np.float32)).to(torch.bfloat16)
                                  for b in bf16], device="cpu"), tds(Y))
    want = jwls.BlockWeightedLeastSquaresEstimator(8, 1, 0.1, 0.5).fit(
        JDataset.from_host_blocks(bf16), JDataset.of(Y))
    np.testing.assert_allclose(np_(got.W), np.asarray(want.W), atol=SOLVER_TOL)
    np.testing.assert_allclose(np_(got.intercept), np.asarray(want.intercept), atol=SOLVER_TOL)


# -- the streamed flagship composition --------------------------------------
# (tests/pipelines/test_stream_to_hostblocks.py:79-118: tar stream →
# featurize per batch → host column blocks → weighted host-block fit)


def _class_tar(tar_path, wnid, cls, n):
    """A tar of images whose channel signature follows the class, over a
    per-image texture (test_stream_to_hostblocks.py's ``_class_tar``)."""
    from PIL import Image as PILImage

    gains = np.eye(3, dtype=np.float32) * 0.8 + 0.2
    with tarfile.open(tar_path, "w") as tf:
        for i in range(n):
            arr = jpeg_array(40, 40, cls * 977 + i).astype(np.float32)
            arr = np.clip(arr * gains[cls][None, None, :], 0, 255)
            buf = io.BytesIO()
            PILImage.fromarray(arr.astype(np.uint8)).save(buf, format="JPEG", quality=92)
            info = tarfile.TarInfo(f"{wnid}_{i}.JPEG")
            data = buf.getvalue()
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


@pytest.fixture
def tar_dir(tmp_path):
    d = tmp_path / "tars"
    d.mkdir()
    wnids = ["n02000001", "n02000002", "n02000003"]
    for i, wnid in enumerate(wnids):
        _class_tar(str(d / f"{wnid}.tar"), wnid, i, 8)
    labels = tmp_path / "labels.txt"
    labels.write_text("".join(f"{w} {i}\n" for i, w in enumerate(wnids)))
    return str(d), str(labels)


def _projection(width):
    rng = np.random.default_rng(0)
    return rng.standard_normal((width, 96)).astype(np.float32) / 10


def _featurize_torch(u8_batch):
    """The JAX test's stand-in for the FV chain (downsample, flatten, a
    fixed random projection), in PyTorch."""
    x = torch.as_tensor(u8_batch).to(torch.float32) / 255.0
    pooled = x.reshape(x.shape[0], 8, 4, 8, 4, 3).mean(dim=(2, 4))
    flat = pooled.reshape(x.shape[0], -1)
    return flat @ torch.as_tensor(_projection(flat.shape[1]))


def _featurize_jax(u8_batch):
    x = jnp.asarray(u8_batch, jnp.float32) / 255.0
    pooled = x.reshape(x.shape[0], 8, 4, 8, 4, 3).mean(axis=(2, 4))
    flat = pooled.reshape(x.shape[0], -1)
    return flat @ jnp.asarray(_projection(flat.shape[1]))


def _stream_to_host_blocks(loader_cls, featurize, from_batches, loc, labels_path):
    loader = loader_cls(loc, labels_path, decode_size=32, shard_index=0, num_shards=1)
    ys = []

    def batches():
        for imgs, labs, nv in loader.batches(8, np.uint8):
            ys.extend(labs[:nv])
            yield featurize(imgs[:nv])

    return from_batches(batches()), np.asarray(ys, np.int32)


def test_streamed_featurize_host_block_fit_matches_in_device_fit_and_jax(tar_dir, host_dataset_spy):
    loc, labels_path = tar_dir
    host_ds, y = _stream_to_host_blocks(
        StreamingImageNetLoader, _featurize_torch,
        lambda b: Dataset.host_blocks_from_batches(b, block_size=32, device="cpu"),
        loc, labels_path)
    assert host_ds.is_host and host_ds.n == 24 and host_ds.block_widths == [32, 32, 32]
    labels = ClassLabelIndicators(3).apply_batch(Dataset.from_array(torch.as_tensor(y)))
    kw = dict(block_size=32, num_iter=2, lam=1e-3, mixture_weight=0.5, solve="pcg")
    model = twls.BlockWeightedLeastSquaresEstimator(**kw).fit(host_ds, labels)
    assert host_dataset_spy == []

    # the same features fit in device memory
    dense = torch.cat(host_ds.host_blocks, dim=1)
    in_device = twls.BlockWeightedLeastSquaresEstimator(**kw).fit(Dataset.from_array(dense), labels)
    np.testing.assert_allclose(np_(model.W), np_(in_device.W), **FIT_TOL)
    # and the JAX package's own composition on the same tars
    jhost, jy = _stream_to_host_blocks(
        JStreamingImageNetLoader, _featurize_jax,
        lambda b: JDataset.host_blocks_from_batches(b, block_size=32), loc, labels_path)
    assert np.array_equal(jy, y)
    np.testing.assert_allclose(np.concatenate(jhost.host_blocks, axis=1), np_(dense), rtol=1e-6, atol=1e-6)
    jlabels = JIndicators(3).apply_batch(JDataset.from_array(jnp.asarray(jy)))
    want = jwls.BlockWeightedLeastSquaresEstimator(**kw).fit(jhost, jlabels)
    # across the packages, the port's bar for the weighted solver against
    # JAX's: the two featurizers round apart by up to 1e-6, and 24 rows of
    # 96 features at lam 1e-3 amplify that (8.7e-5 read)
    np.testing.assert_allclose(np_(model.W), np.asarray(want.W), atol=SOLVER_TOL)
    np.testing.assert_allclose(np_(model.intercept), np.asarray(want.intercept), atol=SOLVER_TOL)
    # the composed flow learned the classes, scored from the host blocks
    preds = np_(model.apply_batch(host_ds).array())
    assert (preds.argmax(1) == y).mean() == 1.0


# -- PerClassWeightedLeastSquaresEstimator ----------------------------------

PER_CLASS_CASES = [
    # (n, D, C, seed, block_size, num_iter, lam, w)
    (90, 10, 3, 0, 10, 1, 0.1, 0.6),
    (90, 10, 3, 0, 4, 2, 0.1, 0.6),  # ragged tail block
    (100, 6, 2, 2, 6, 8, 0.05, 0.5),  # the JAX test's problem
    (120, 12, 4, 5, 5, 3, 0.01, 0.25),
]


@pytest.mark.parametrize("n,D,C,seed,block_size,num_iter,lam,w", PER_CLASS_CASES)
def test_per_class_weighted_matches_jax(n, D, C, seed, block_size, num_iter, lam, w):
    X, Y, y = _weighted_problem(n=n, D=D, C=C, seed=seed)
    want = jwls.PerClassWeightedLeastSquaresEstimator(block_size, num_iter, lam, w).fit(
        JDataset.of(X), JDataset.of(Y))
    got = twls.PerClassWeightedLeastSquaresEstimator(block_size, num_iter, lam, w).fit(tds(X), tds(Y))
    np.testing.assert_allclose(np_(got.W), np.asarray(want.W), atol=SOLVER_TOL)
    np.testing.assert_allclose(np_(got.intercept), np.asarray(want.intercept), atol=SOLVER_TOL)


def test_per_class_weighted_is_close_to_block_weighted_and_order_free():
    """As the JAX tests: both solvers of the same objective classify the
    training set (> 0.95), and a permutation of the rows leaves the
    per-class fit where it was."""
    X, Y, y = _weighted_problem(n=100, D=6, C=2, seed=2)
    lam, w = 0.05, 0.5
    m1 = twls.BlockWeightedLeastSquaresEstimator(6, 8, lam, w).fit(tds(X), tds(Y))
    m2 = twls.PerClassWeightedLeastSquaresEstimator(6, 8, lam, w).fit(tds(X), tds(Y))
    for m in (m1, m2):
        assert (np_(m.apply_batch(tds(X)).array()).argmax(1) == y).mean() > 0.95
    perm = np.random.default_rng(0).permutation(len(X))
    m3 = twls.PerClassWeightedLeastSquaresEstimator(6, 8, lam, w).fit(tds(X[perm]), tds(Y[perm]))
    np.testing.assert_allclose(np_(m3.W), np_(m2.W), atol=1e-3)


def test_per_class_weighted_on_padded_rows_and_an_empty_class():
    X, Y, _ = _weighted_problem(n=64, D=8, C=3, seed=7)
    Xp = np.concatenate([X, np.zeros((8, 8), np.float32)])
    Yp = np.concatenate([Y, np.zeros((8, 3), np.float32)])
    est = twls.PerClassWeightedLeastSquaresEstimator(4, 2, 0.1, 0.5)
    np.testing.assert_allclose(np_(est.fit(tds(Xp, n=64), tds(Yp, n=64)).W),
                               np_(est.fit(tds(X), tds(Y)).W), atol=1e-5)
    Y4 = np.concatenate([Y, -np.ones((64, 1), np.float32)], axis=1)
    for est_cls, ds in ((jwls.PerClassWeightedLeastSquaresEstimator, JDataset.of),
                        (twls.PerClassWeightedLeastSquaresEstimator, tds)):
        with pytest.raises(ValueError, match="every class"):
            est_cls(4, 1, 0.1, 0.5).fit(ds(X), ds(Y4))


# -- ApproximatePCAEstimator -------------------------------------------------


def _random_lowrank(n, d, rank, seed):
    """tests/ops/test_pca_zca.py's low-rank data with noise."""
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((n, rank))
    V = rng.standard_normal((rank, d))
    return (U @ V + 0.01 * rng.standard_normal((n, d))).astype(np.float32)


def _np_pca(X, k):
    Xc = X - X.mean(0)
    _, _, vt = np.linalg.svd(Xc, full_matrices=False)
    return vt.T[:, :k]


@pytest.mark.parametrize("n,d,rank,dims,p,q,seed", [
    (120, 16, 3, 3, 10, 2, 0), (200, 32, 8, 6, 4, 1, 5), (64, 12, 12, 5, 10, 0, 2),
])
def test_approximate_pca_given_jaxs_draw_matches_jax(n, d, rank, dims, p, q, seed):
    X = _random_lowrank(n, d, rank, seed=seed)
    want = jpca.ApproximatePCAEstimator(dims, p=p, q=q, seed=seed).fit(JDataset.of(X)).pca_mat
    l = min(dims + p, d)
    omega = np.array(jax.random.normal(jax.random.PRNGKey(seed), (d, l), jnp.float32))
    A = torch.as_tensor(X - X.mean(0, dtype=np.float32))
    got = tpca.approximate_pca(A, torch.as_tensor(omega), q, dims)
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=SKETCH_TOL)


def test_approximate_pca_own_draw_spans_the_principal_subspace():
    """The JAX test's bar on the port's own draw: the principal angles
    against the exact PCA all have cosines above 0.99."""
    X = _random_lowrank(120, 16, 3, seed=2)
    approx = np_(tpca.ApproximatePCAEstimator(3, seed=0).fit(tds(X)).pca_mat)
    s = np.linalg.svd(_np_pca(X, 3).T @ approx, compute_uv=False)
    assert s.min() > 0.99
    # the draw is the seed's on every call
    again = np_(tpca.ApproximatePCAEstimator(3, seed=0).fit(tds(X)).pca_mat)
    assert np.array_equal(approx, again)


def test_approximate_pca_cost_matches_jax():
    args = (10_000, 128, 64, 1.0, 1, 1.0, 2.0, 3.0)
    for kw in (dict(dims=64), dict(dims=8, p=4, q=3)):
        assert tpca.ApproximatePCAEstimator(**kw).cost(*args) == \
            jpca.ApproximatePCAEstimator(**kw).cost(*args)
