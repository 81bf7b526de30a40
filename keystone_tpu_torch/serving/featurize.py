"""The flagship ImageNetSiftLcsFV featurize chain for serving (counterpart
of ``keystone_tpu/serving/featurize.py``: the seeded warm-start path;
fitting PCA/GMM on ``fit_images`` waits for the training slice).

A branched DAG: gray → SIFT and LCS branches, each PCA → GMM Fisher
vector → Hellinger/L2 normalization, gathered through ``VectorCombiner``.
Parameters are drawn from ``np.random.default_rng(seed)`` in the same
order as the JAX package (SIFT's PCA, SIFT's GMM means, then LCS's), so
both packages freeze identical parameters from one seed.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from keystone_tpu_torch._device import resolve_device


def flagship_branches(
    sift_prefix, lcs_prefix, sift_params: dict, lcs_params: dict, device
):
    """Gather the two featurize branches behind their prefixes. Each
    params dict holds ``pca`` (in_dim, desc_dim) and ``means``,
    ``variances`` (desc_dim, vocab), ``weights`` (vocab,) and
    ``threshold``; the FV node is the fused kernel at vocab >= 32."""
    from keystone_tpu_torch.ops.images.fisher_vector import (
        FisherVector,
        FisherVectorFused,
    )
    from keystone_tpu_torch.ops.learning.gmm import GaussianMixtureModel
    from keystone_tpu_torch.ops.learning.pca import BatchPCATransformer
    from keystone_tpu_torch.ops.stats.nodes import (
        NormalizeRows,
        SignedHellingerMapper,
    )
    from keystone_tpu_torch.ops.util.nodes import (
        FloatToDouble,
        MatrixVectorizer,
        VectorCombiner,
    )
    from keystone_tpu_torch.workflow.api import Pipeline

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    def branch(prefix, p):
        gmm = GaussianMixtureModel(
            t(p["means"]), t(p["variances"]), t(p["weights"]),
            float(p.get("threshold", 1e-4)),
        )
        vocab = gmm.means.shape[1]
        fv = FisherVectorFused(gmm) if vocab >= 32 else FisherVector(gmm)
        return (
            prefix
            .and_then(BatchPCATransformer(t(p["pca"])))
            .and_then(fv)
            .and_then(FloatToDouble())
            .and_then(MatrixVectorizer())
            .and_then(NormalizeRows())
            .and_then(SignedHellingerMapper())
            .and_then(NormalizeRows())
        )

    return Pipeline.gather([
        branch(sift_prefix, sift_params), branch(lcs_prefix, lcs_params),
    ]).and_then(VectorCombiner())


def flagship_prefixes(
    *, sift_step=3, sift_bin=4, sift_scales=4, sift_scale_step=1,
    lcs_stride=4, lcs_border=16, lcs_patch=6,
):
    """The SIFT branch's prefix (scale → gray → SIFT → Hellinger) and the
    LCS branch's (LCS on the raw image)."""
    from keystone_tpu_torch.ops.images.core import GrayScaler, PixelScaler
    from keystone_tpu_torch.ops.images.lcs import LCSExtractor
    from keystone_tpu_torch.ops.images.sift import SIFTExtractor
    from keystone_tpu_torch.ops.stats.nodes import SignedHellingerMapper

    sift = (
        PixelScaler().and_then(GrayScaler())
        .and_then(SIFTExtractor(
            step=sift_step, bin=sift_bin, num_scales=sift_scales,
            scale_step=sift_scale_step,
        ))
        .and_then(SignedHellingerMapper())
    )
    lcs = LCSExtractor(lcs_stride, lcs_border, lcs_patch).to_pipeline()
    return sift, lcs


def flagship_pipeline(
    rng: np.random.Generator,
    desc_dim: int = 64,
    vocab: int = 16,
    *,
    device: Optional[Union[str, torch.device]] = None,
    sift_step: int = 3,
    sift_bin: int = 4,
    sift_scales: int = 4,
    sift_scale_step: int = 1,
    lcs_stride: int = 4,
    lcs_border: int = 16,
    lcs_patch: int = 6,
):
    """The unfitted warm-start featurize chain: seeded random PCA
    projections and unit GMMs stand in for fitted parameters, placed on
    ``device`` (``None`` means ``cuda``)."""
    dev = resolve_device(device)

    def draw(in_dim):
        pca = rng.standard_normal((desc_dim, in_dim)).astype(np.float32) * 0.1
        means = rng.standard_normal((desc_dim, vocab)).astype(np.float32)
        return {
            "pca": pca.T,
            "means": means,
            "variances": np.ones((desc_dim, vocab), np.float32),
            "weights": np.ones((vocab,), np.float32) / vocab,
        }

    sift_params = draw(128)
    lcs_params = draw(96)
    sift, lcs = flagship_prefixes(
        sift_step=sift_step, sift_bin=sift_bin, sift_scales=sift_scales,
        sift_scale_step=sift_scale_step, lcs_stride=lcs_stride,
        lcs_border=lcs_border, lcs_patch=lcs_patch,
    )
    return flagship_branches(sift, lcs, sift_params, lcs_params, dev)


def build_flagship_featurize_pipeline(
    img: int = 64,
    desc_dim: int = 16,
    vocab: int = 16,
    *,
    sift_step: int = 4,
    sift_bin: int = 4,
    sift_scales: int = 2,
    sift_scale_step: int = 1,
    lcs_stride: int = 4,
    lcs_border: int = 16,
    lcs_patch: int = 6,
    seed: int = 7,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[object, int]:
    """The flagship SIFT+LCS→FV featurize chain as a frozen serving stage
    — raw ``(img, img, 3)`` uint8 in, ``(2·2·desc_dim·vocab,)`` float32
    features out — with its parameters on ``device`` (``None`` means
    ``cuda``). Returns ``(fitted_featurize, feature_dim)``."""
    dev = resolve_device(device)
    if img <= 2 * lcs_border:
        raise ValueError(
            f"img={img} leaves the LCS keypoint grid empty "
            f"(needs img > 2*lcs_border = {2 * lcs_border})"
        )
    pipe = flagship_pipeline(
        np.random.default_rng(seed), desc_dim, vocab, device=dev,
        sift_step=sift_step, sift_bin=sift_bin, sift_scales=sift_scales,
        sift_scale_step=sift_scale_step, lcs_stride=lcs_stride,
        lcs_border=lcs_border, lcs_patch=lcs_patch,
    )
    # two branches, each a (desc_dim, 2·vocab) Fisher vector
    return pipe.fit(), 2 * 2 * desc_dim * vocab


__all__ = [
    "build_flagship_featurize_pipeline",
    "flagship_branches",
    "flagship_pipeline",
    "flagship_prefixes",
]
