"""The whole slice on the CPU: the flagship SIFT+LCS→FV serving chain of
the port against the JAX package's, with weights carried across through
``convert.flagship_from_numpy`` and with the same seed drawing the same
warm-start parameters in both; and the serving engine's padding and
chunking. Small geometry: 48² images, desc_dim 8, two SIFT scales."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.ops.images.fisher_vector import FisherVector, FisherVectorFused
from keystone_tpu.ops.learning import BatchPCATransformer
from keystone_tpu.ops.learning.block_ls import BlockLinearMapper
from keystone_tpu.ops.util.nodes import TopKClassifier
from keystone_tpu.serving.featurize import (
    build_flagship_featurize_pipeline as jax_build,
)
from keystone_tpu_torch import convert
from keystone_tpu_torch.serving.engine import CompiledPipeline
from keystone_tpu_torch.serving.featurize import (
    build_flagship_featurize_pipeline as torch_build,
)
from keystone_tpu_torch.workflow.executor import PipelineEnv as TEnv

IMG, DESC = 48, 8
GEOMETRY = dict(sift_step=4, sift_bin=4, sift_scales=2, sift_scale_step=1,
                lcs_stride=4, lcs_border=16, lcs_patch=6)
CLASSES = 10
# the features' bar of tests/serving/test_device_featurize.py
FEAT_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def reset_port_env():
    TEnv.get_or_create().reset()
    yield
    TEnv.get_or_create().reset()


def jax_params(fitted):
    """numpy parameters of a JAX flagship chain, keyed by branch: each
    BatchPCATransformer (128 rows for SIFT, 96 for LCS) and the FV node
    that consumes it."""
    g = fitted.graph
    out = {}
    for nid, op in g.operators.items():
        if not isinstance(op, BatchPCATransformer):
            continue
        fv = next(
            o for n, o in g.operators.items()
            if isinstance(o, (FisherVector, FisherVectorFused))
            and g.dependencies[n] == (nid,)
        )
        pca = np.asarray(op.pca_mat)
        gmm = fv.gmm
        out["sift" if pca.shape[0] == 128 else "lcs"] = {
            "pca": pca, "means": np.asarray(gmm.means),
            "variances": np.asarray(gmm.variances),
            "weights": np.asarray(gmm.weights),
            "threshold": gmm.weight_threshold,
        }
    assert set(out) == {"sift", "lcs"}
    return out


def head(feat_dim, seed=3):
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((feat_dim, CLASSES)).astype(np.float32)
    b = rng.standard_normal(CLASSES).astype(np.float32)
    return W, b


@pytest.fixture(scope="module", params=[8, 32], ids=["vocab8", "vocab32_fused"])
def jax_chain(request):
    vocab = request.param
    feat, feat_dim = jax_build(img=IMG, desc_dim=DESC, vocab=vocab, **GEOMETRY)
    W, b = head(feat_dim)
    model = BlockLinearMapper(
        jnp.asarray(W), feat_dim, explicit_intercept=jnp.asarray(b)
    ).and_then(TopKClassifier(5)).fit()
    raw = np.random.default_rng(5).integers(0, 256, (3, IMG, IMG, 3), dtype=np.uint8)
    feats = np.asarray(feat._batch_run(jnp.asarray(raw)))
    top5 = np.asarray(model._batch_run(jnp.asarray(feats)))
    return vocab, feat, feat_dim, (W, b), raw, feats, top5


def test_slice_matches_jax_with_converted_weights(jax_chain):
    vocab, jfeat, feat_dim, (W, b), raw, want_feats, want_top5 = jax_chain
    params = jax_params(jfeat)
    params["model"] = {"W": W, "intercept": b}
    feat, model = convert.flagship_from_numpy(params, device="cpu", **GEOMETRY)
    got = feat._batch_run(torch.as_tensor(raw))
    assert got.shape == (3, feat_dim) == (3, 4 * DESC * vocab)
    np.testing.assert_allclose(got.numpy(), want_feats, **FEAT_TOL)
    np.testing.assert_array_equal(model._batch_run(got).numpy(), want_top5)


def test_same_seed_draws_the_same_warm_start(jax_chain):
    vocab, _, feat_dim, _, raw, want_feats, _ = jax_chain
    feat, dim = torch_build(img=IMG, desc_dim=DESC, vocab=vocab, device="cpu", **GEOMETRY)
    assert dim == feat_dim
    np.testing.assert_allclose(
        feat._batch_run(torch.as_tensor(raw)).numpy(), want_feats, **FEAT_TOL
    )


@pytest.fixture(scope="module")
def torch_chain():
    feat, feat_dim = torch_build(img=IMG, desc_dim=DESC, vocab=8, device="cpu", **GEOMETRY)
    W, b = head(feat_dim)
    return feat, convert.model_head(W, b, 5, "cpu")


@pytest.mark.parametrize("rows", [1, 5, 9])
def test_engine_padding_and_chunking(torch_chain, rows):
    """Buckets (4, 8): 1 row pads to 4, 5 to 8, 9 chunks as 8 + 1 (pad
    to 4). Each row comes out as in an unpadded run."""
    feat, model = torch_chain
    eng = CompiledPipeline(model, (8, 4), featurize=feat, device="cpu")
    assert eng.buckets == (4, 8) and eng.bucket_for(5) == 8
    raw = np.random.default_rng(rows).integers(0, 256, (rows, IMG, IMG, 3), dtype=np.uint8)
    got = eng.apply(raw)
    want = model._batch_run(feat._batch_run(torch.as_tensor(raw)))
    assert got.shape == (rows, 5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    fitted_eng = model.compiled((4, 8), featurize=feat, device="cpu")
    torch.testing.assert_close(fitted_eng.apply(raw), want, rtol=0, atol=0)


def test_engine_rejects_empty_and_bad_buckets(torch_chain):
    feat, model = torch_chain
    with pytest.raises(ValueError, match="positive"):
        CompiledPipeline(model, (0, 4), device="cpu")
    eng = CompiledPipeline(model, (4,), featurize=feat, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        eng.apply(np.zeros((0, IMG, IMG, 3), np.uint8))
    with pytest.raises(ValueError, match="largest bucket"):
        eng.bucket_for(5)
