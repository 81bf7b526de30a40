"""The random-features statistics nodes and ZCA on the CPU, held against
the JAX package on the same seeded numpy inputs: RandomSignNode,
PaddedFFT, RandomFFTFeatures (fused against the gathered branches, with
and without a rectify threshold over pad rows), LinearRectifier,
StandardScaler over padded rows, Sampler's draw, VectorSplitter,
MaxClassifier and the ZCA whitener. Bars: rtol 1e-5 / atol 1e-5 for the
FFT features (tests/ops/test_stats.py:158), and for the whitener the JAX
test's decorrelation bar (tests/ops/test_pca_zca.py:90, atol 0.15) with
the whitener itself within atol 1e-4 of the JAX one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.ops.learning.zca import ZCAWhitenerEstimator as JZCA
from keystone_tpu.ops.stats import nodes as jn
from keystone_tpu.ops.util import nodes as ju
from keystone_tpu.parallel.dataset import Dataset as JDataset
from keystone_tpu_torch.ops.learning.zca import ZCAWhitenerEstimator
from keystone_tpu_torch.ops.stats import nodes as tn
from keystone_tpu_torch.ops.util import nodes as tu
from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.utils import chunks

FFT_TOL = dict(rtol=1e-5, atol=1e-5)


def np_(x):
    if isinstance(x, (Dataset, JDataset)):
        x = x.padded()
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pair(x, n=None):
    return JDataset.from_array(jnp.asarray(x), n=n), Dataset.from_array(torch.as_tensor(x), n=n)


def test_random_sign_node_and_padded_fft_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 100)).astype(np.float32)
    jds, tds = _pair(x)
    js, ts = jn.RandomSignNode.create(100, seed=4), tn.RandomSignNode.create(100, seed=4)
    np.testing.assert_array_equal(np_(ts.signs), np_(js.signs))
    signed = np_(ts.apply_batch(tds))
    np.testing.assert_array_equal(signed, np_(js.apply_batch(jds)))
    want = np_(jn.PaddedFFT().apply_batch(JDataset.from_array(jnp.asarray(signed))))
    got = np_(tn.PaddedFFT().apply_batch(Dataset.from_array(torch.as_tensor(signed))))
    assert got.shape == want.shape == (6, 64)
    np.testing.assert_allclose(got, want, **FFT_TOL)
    np.testing.assert_allclose(np_(tn.PaddedFFT().apply(torch.as_tensor(signed[2]))), want[2],
                               **FFT_TOL)


@pytest.mark.parametrize("thresh", [0.0, 0.25])
def test_random_fft_features_fused_against_gathered_and_jax(thresh, monkeypatch):
    """Fused == the gathered RandomSignNode -> PaddedFFT -> LinearRectifier
    branches, feature for feature; pad rows stay zero when the threshold
    would lift them; and both match the JAX node."""
    rng = np.random.default_rng(1)
    d, f, n, pad_n = 64, 3, 5, 8
    x = np.zeros((pad_n, d), np.float32)
    x[:n] = rng.standard_normal((n, d))
    jds, tds = _pair(x, n=n)
    fused = tn.RandomFFTFeatures.create(d, f, seed=3, rectify_threshold=thresh)
    monkeypatch.setattr(chunks, "CHUNK_BYTES", 3 * f * 64 * 4)  # 3 rows a chunk
    got = np_(fused.apply_batch(tds))
    assert got.shape == (pad_n, fused.out_dim) and not got[n:].any()
    parts = [
        np_(tn.LinearRectifier(thresh).apply_batch(tn.PaddedFFT().apply_batch(
            tn.RandomSignNode.create(d, seed=3 + i).apply_batch(tds))))
        for i in range(f)
    ]
    np.testing.assert_allclose(got[:n], np.concatenate(parts, axis=1)[:n], **FFT_TOL)
    want = np_(jn.RandomFFTFeatures.create(d, f, seed=3, rectify_threshold=thresh).apply_batch(jds))
    np.testing.assert_allclose(got, want, **FFT_TOL)
    np.testing.assert_allclose(np_(fused.apply(torch.as_tensor(x[0]))), want[0], **FFT_TOL)


@pytest.mark.parametrize("max_val,alpha", [(0.0, 0.0), (0.5, -0.1)])
def test_linear_rectifier_matches_jax(max_val, alpha):
    rng = np.random.default_rng(2)
    x = np.zeros((6, 5), np.float32)
    x[:4] = rng.standard_normal((4, 5))
    jds, tds = _pair(x, n=4)
    got = np_(tn.LinearRectifier(max_val, alpha).apply_batch(tds))
    np.testing.assert_array_equal(got, np_(jn.LinearRectifier(max_val, alpha).apply_batch(jds)))
    assert not got[4:].any()


@pytest.mark.parametrize("normalize", [True, False])
def test_standard_scaler_respects_padding(normalize):
    """10 valid rows padded to 16: the statistics use n = 10 and the pad
    rows stay zero after centering (a constant column takes std 1)."""
    rng = np.random.default_rng(3)
    x = np.zeros((16, 4), np.float32)
    x[:10] = rng.standard_normal((10, 4)) * 3 + 5
    x[:10, 2] = 7.0
    jds, tds = _pair(x, n=10)
    jm = jn.StandardScaler(normalize_std_dev=normalize).fit(jds)
    tm = tn.StandardScaler(normalize_std_dev=normalize).fit(tds)
    np.testing.assert_allclose(np_(tm.mean), np_(jm.mean), rtol=1e-6)
    if normalize:
        np.testing.assert_allclose(np_(tm.std), np_(jm.std), rtol=1e-5)
        assert np_(tm.std)[2] == 1.0
    else:
        assert tm.std is None and jm.std is None
    out = np_(tm.apply_batch(tds))
    np.testing.assert_allclose(out, np_(jm.apply_batch(jds)), rtol=1e-5, atol=1e-6)
    assert not out[10:].any()
    np.testing.assert_allclose(np_(tm.apply(torch.as_tensor(x[0]))), out[0], rtol=1e-6)


def test_sampler_draws_the_jax_rows_and_items():
    x = np.arange(200.0, dtype=np.float32).reshape(100, 2)
    want = np_(jn.Sampler(10, seed=3).apply(x).array())
    got = tn.Sampler(10, seed=3).apply(torch.as_tensor(x))
    assert got.n == 10
    np.testing.assert_array_equal(np_(got.array()), want)
    items = [f"row{i}" for i in range(100)]
    assert tn.Sampler(7, seed=1).apply(items).items() == jn.Sampler(7, seed=1).apply(items).items()
    assert tn.Sampler(500, seed=0).apply(torch.as_tensor(x)).n == 100


def test_vector_splitter_and_max_classifier_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((7, 10)).astype(np.float32)
    x[3, 4] = x[3, 7] = x[3].max() + 1.0  # a tie: the first index wins
    jds, tds = _pair(x)
    jb, tb = ju.VectorSplitter(4).apply(jds), tu.VectorSplitter(4).apply(tds)
    assert [b.padded().shape[1] for b in tb] == [4, 4, 2]
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(np_(a), np_(b))
    assert [b.padded().shape[1] for b in tu.VectorSplitter(4, num_features=6).apply(tds)] == [4, 2]
    got = np_(tu.MaxClassifier().apply_batch(tds))
    np.testing.assert_array_equal(got, np_(ju.MaxClassifier().apply_batch(jds)))
    assert got[3] == 4 and int(tu.MaxClassifier().apply(torch.as_tensor(x[3]))) == 4


def test_zca_matches_jax_and_decorrelates():
    rng = np.random.default_rng(5)
    X = (rng.standard_normal((500, 6)) @ rng.standard_normal((6, 6))).astype(np.float32)
    w = ZCAWhitenerEstimator(eps=1e-6).fit(Dataset.of(torch.as_tensor(X)))
    jw = JZCA(eps=1e-6).fit(JDataset.of(X))
    out = np_(w.apply(torch.as_tensor(X)))
    cov = out.T @ out / (out.shape[0] - 1)
    np.testing.assert_allclose(cov, np.eye(6), atol=0.15)
    W = np_(w.whitener)
    np.testing.assert_allclose(W, W.T, atol=1e-4)
    np.testing.assert_allclose(W, np_(jw.whitener), atol=1e-4)
    np.testing.assert_allclose(np_(w.means), np_(jw.means), rtol=1e-6, atol=1e-6)
    # the patch-sample regime of RandomPatchCifar: eps 0.1 on a tall sample
    S = rng.uniform(0, 1, (400, 27)).astype(np.float32)
    np.testing.assert_allclose(np_(ZCAWhitenerEstimator(0.1).fit_single(torch.as_tensor(S)).whitener),
                               np_(JZCA(0.1).fit_single(jnp.asarray(S)).whitener), atol=1e-4)
    batch = ZCAWhitenerEstimator(0.1).fit_single(torch.as_tensor(S)).apply_batch(
        Dataset.from_array(torch.as_tensor(S[:5]), n=3))
    assert not np_(batch)[3:].any()
