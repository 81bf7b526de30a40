"""One parity test per ported node of the flagship path: the same seeded
numpy inputs through the JAX package's node (``apply_batch`` on an
array-mode Dataset, Pallas in interpret mode) and the port's counterpart
on the CPU, at small sizes, with the tolerance stated per test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.ops.images import core as jcore
from keystone_tpu.ops.images import fisher_vector as jfv
from keystone_tpu.ops.images import lcs as jlcs
from keystone_tpu.ops.images import sift as jsift
from keystone_tpu.ops.learning import block_ls as jbls
from keystone_tpu.ops.learning import gmm as jgmm
from keystone_tpu.ops.learning import pca as jpca
from keystone_tpu.ops.stats import nodes as jstats
from keystone_tpu.ops.util import nodes as jutil
from keystone_tpu.parallel.dataset import Dataset as JDataset
from keystone_tpu_torch.ops.images import core as tcore
from keystone_tpu_torch.ops.images import fisher_vector as tfv
from keystone_tpu_torch.ops.images import lcs as tlcs
from keystone_tpu_torch.ops.images import sift as tsift
from keystone_tpu_torch.ops.learning import block_ls as tbls
from keystone_tpu_torch.ops.learning import gmm as tgmm
from keystone_tpu_torch.ops.learning import pca as tpca
from keystone_tpu_torch.ops.stats import nodes as tstats
from keystone_tpu_torch.ops.util import nodes as tutil
from keystone_tpu_torch.parallel.dataset import Dataset as TDataset


def jrun(node, x, n=None):
    ds = JDataset.from_array(
        tuple(jnp.asarray(a) for a in x) if isinstance(x, tuple) else jnp.asarray(x),
        n=n,
    )
    return np.asarray(node.apply_batch(ds).padded())


def trun(node, x, n=None):
    ds = TDataset.from_array(
        tuple(torch.as_tensor(a) for a in x) if isinstance(x, tuple) else torch.as_tensor(x),
        n=n,
    )
    return node.apply_batch(ds).padded().numpy()


def images(seed, n=3, size=48):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def gmm_params(rng, d, k):
    means = rng.standard_normal((d, k)).astype(np.float32)
    variances = (0.5 + rng.random((d, k))).astype(np.float32)
    w = rng.random(k).astype(np.float32) + 0.1
    return means, variances, (w / w.sum()).astype(np.float32)


def test_pixel_and_gray_scaler():
    raw = images(0)
    np.testing.assert_allclose(
        trun(tcore.PixelScaler(), raw), jrun(jcore.PixelScaler(), raw), rtol=1e-7
    )
    x = raw.astype(np.float32) / 255.0
    np.testing.assert_allclose(
        trun(tcore.GrayScaler(), x), jrun(jcore.GrayScaler(), x), rtol=1e-6, atol=1e-7
    )


def _jax_unquantized(img, step, bin_, num_scales, scale_step):
    """SIFTExtractor.apply of the JAX package without its final x512
    quantization, from the package's own stage functions."""
    descs = []
    for scale in range(num_scales):
        bin_size = bin_ + 2 * scale
        sm = jsift._sep_conv2d(
            jnp.asarray(img)[None], jsift._gaussian_kernel(bin_size / jsift.MAGNIF)
        )[0]
        desc, norms = jsift._dsift_one_scale(
            sm, bin_size=bin_size, step=step + scale * scale_step,
            bound_min=(1 + 2 * num_scales) - 3 * scale,
        )
        descs.append(jnp.where((norms >= jsift.CONTRAST_THRESHOLD)[:, None], desc, 0.0))
    return np.asarray(jnp.concatenate(descs, axis=0))


@pytest.mark.parametrize("step,num_scales", [(4, 2), (3, 3)])
def test_sift(step, num_scales):
    """Before quantization rtol 1e-4; after floor(x512), within ±1 on
    >= 99.5 % of entries (a floor flips on a last-bit difference — the
    repo's golden bar)."""
    gray = images(1, n=2).astype(np.float32) @ np.float32([0.2989, 0.587, 0.114]) / 255.0
    gray = gray.astype(np.float32)
    got = tsift.SIFTExtractor(step=step, bin=4, num_scales=num_scales).unquantized(
        torch.as_tensor(gray)
    ).numpy()
    for i in range(2):
        want = _jax_unquantized(gray[i], step, 4, num_scales, 1)
        np.testing.assert_allclose(got[i], want, rtol=1e-4, atol=1e-6)
    jnode = jsift.SIFTExtractor(step=step, bin=4, num_scales=num_scales)
    tnode = tsift.SIFTExtractor(step=step, bin=4, num_scales=num_scales)
    q_t = trun(tnode, gray[..., None])
    q_j = np.stack([np.asarray(jnode.apply(jnp.asarray(g[..., None]))) for g in gray])
    assert q_t.shape == q_j.shape
    assert np.mean(np.abs(q_t - q_j) <= 1) >= 0.995


def test_lcs():
    raw = images(2)
    jnode = jlcs.LCSExtractor(4, 16, 6)
    want = np.stack([np.asarray(jnode.apply(jnp.asarray(r))) for r in raw])
    got = trun(tlcs.LCSExtractor(4, 16, 6), raw)
    assert got.shape == want.shape == (3, 96, 16)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    img = raw[0].astype(np.float32)
    np.testing.assert_allclose(
        tlcs._box_filter_same(torch.as_tensor(img), 6).numpy(),
        np.asarray(jlcs._box_filter_same(jnp.asarray(img), 6)),
        rtol=1e-5, atol=1e-4,
    )


def test_batch_pca():
    rng = np.random.default_rng(3)
    pca = rng.standard_normal((12, 5)).astype(np.float32)
    x = rng.standard_normal((3, 12, 30)).astype(np.float32)
    np.testing.assert_allclose(
        trun(tpca.BatchPCATransformer(torch.as_tensor(pca)), x),
        jrun(jpca.BatchPCATransformer(jnp.asarray(pca)), x),
        rtol=1e-5, atol=1e-5,
    )


def test_gmm_posteriors_with_pad_rows():
    rng = np.random.default_rng(4)
    means, variances, weights = gmm_params(rng, 6, 5)
    x = np.zeros((6, 6), np.float32)
    x[:4] = rng.standard_normal((4, 6))
    tnode = tgmm.GaussianMixtureModel(*(torch.as_tensor(a) for a in (means, variances, weights)))
    jnode = jgmm.GaussianMixtureModel(*(jnp.asarray(a) for a in (means, variances, weights)))
    got, want = trun(tnode, x, n=4), jrun(jnode, x, n=4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert not got[4:].any()


@pytest.mark.parametrize("fused", [False, True])
def test_fisher_vector(fused):
    rng = np.random.default_rng(5)
    d, k = 8, 32 if fused else 8
    means, variances, weights = gmm_params(rng, d, k)
    x = rng.standard_normal((2, d, 90)).astype(np.float32)
    tg = tgmm.GaussianMixtureModel(*(torch.as_tensor(a) for a in (means, variances, weights)))
    jg = jgmm.GaussianMixtureModel(*(jnp.asarray(a) for a in (means, variances, weights)))
    tcls, jcls = (tfv.FisherVectorFused, jfv.FisherVectorFused) if fused else (tfv.FisherVector, jfv.FisherVector)
    got, want = trun(tcls(tg), x), jrun(jcls(jg), x)
    assert got.shape == (2, d, 2 * k)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_signed_hellinger_and_normalize_rows():
    x = np.random.default_rng(6).standard_normal((4, 10)).astype(np.float32)
    x[3] = 0.0
    np.testing.assert_allclose(
        trun(tstats.SignedHellingerMapper(), x), jrun(jstats.SignedHellingerMapper(), x), rtol=1e-6
    )
    np.testing.assert_allclose(
        trun(tstats.NormalizeRows(), x, n=3), jrun(jstats.NormalizeRows(), x, n=3), rtol=1e-6
    )


def test_matrix_vectorizer_float_to_double_vector_combiner():
    rng = np.random.default_rng(7)
    m = rng.standard_normal((3, 4, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        trun(tutil.MatrixVectorizer(), m), jrun(jutil.MatrixVectorizer(), m)
    )
    f = trun(tutil.FloatToDouble(), m)
    assert f.dtype == np.float32 == jrun(jutil.FloatToDouble(), m).dtype
    parts = (m, rng.standard_normal((3, 5)).astype(np.float32))
    np.testing.assert_array_equal(
        trun(tutil.VectorCombiner(), parts), jrun(jutil.VectorCombiner(), parts)
    )


def test_block_linear_mapper_keeps_pad_rows_zero():
    rng = np.random.default_rng(8)
    W = rng.standard_normal((20, 7)).astype(np.float32)
    b = rng.standard_normal(7).astype(np.float32)
    x = np.zeros((5, 20), np.float32)
    x[:3] = rng.standard_normal((3, 20))
    got = trun(tbls.BlockLinearMapper(torch.as_tensor(W), 20, explicit_intercept=torch.as_tensor(b)), x, n=3)
    want = jrun(jbls.BlockLinearMapper(jnp.asarray(W), 20, explicit_intercept=jnp.asarray(b)), x, n=3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not got[3:].any()


def test_top_k():
    x = np.random.default_rng(9).standard_normal((4, 30)).astype(np.float32)
    np.testing.assert_array_equal(
        trun(tutil.TopKClassifier(5), x), jrun(jutil.TopKClassifier(5), x)
    )


def test_top_k_breaks_ties_as_jax():
    """200 tie-heavy rows (integer scores in 0..3, all-zero rows, a row
    shorter than k): the lower index first, as ``jax.lax.top_k``."""
    rng = np.random.default_rng(10)
    x = rng.integers(0, 4, (200, 1000)).astype(np.float32)
    x[:20] = 0.0
    for node in (tutil.TopKClassifier(5),):
        got = trun(node, x)
        want = jrun(jutil.TopKClassifier(5), x)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[:20], np.tile(np.arange(5), (20, 1)))
        for row in x[:5]:
            np.testing.assert_array_equal(
                node.apply(torch.as_tensor(row)).numpy(),
                np.asarray(jutil.TopKClassifier(5).apply(jnp.asarray(row))),
            )
    short = np.zeros((3, 3), np.float32)
    np.testing.assert_array_equal(
        trun(tutil.TopKClassifier(5), short), jrun(jutil.TopKClassifier(5), short)
    )
