"""Image featurize chains for serving (counterpart of
``keystone_tpu/serving/featurize.py``).

Two chains:

- ``build_featurize_pipeline`` — the dense-conv stack (PixelScaler →
  Convolver → rectify → pool → vectorize) of the RandomPatchCifar family,
  with seeded random filters;
- ``build_flagship_featurize_pipeline`` — the flagship ImageNetSiftLcsFV
  featurization: a branched DAG (gray → SIFT and LCS branches, each PCA →
  GMM Fisher vector → Hellinger/L2 normalization, gathered through
  ``VectorCombiner``) with seeded warm-start parameters, or PCA and GMMs
  fitted on ``fit_images``.

Parameters are drawn from ``np.random.default_rng(seed)`` in the same
order as the JAX package (for the flagship: SIFT's PCA, SIFT's GMM means,
then LCS's), so both packages freeze identical parameters from one seed.

``pipeline_token`` (the JAX package's ``serving/aot.py:161``; it lives
here until the port has an AOT module) and ``featurize_token`` are the
content digest of a fitted pipeline: the zoo's proof that two co-hosted
models' featurize chains compute the same function (``zoo/cse.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from keystone_tpu_torch._device import resolve_device


def build_featurize_pipeline(
    img: int = 16,
    channels: int = 3,
    filters: int = 96,
    conv_size: int = 5,
    pool_stride: int = 6,
    pool_size: int = 6,
    seed: int = 7,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[object, int]:
    """The dense-conv featurize chain — raw ``(img, img, C)`` uint8 in,
    ``(F,)`` float32 features out: PixelScaler → Convolver (patch
    normalization folded around one convolution) → SymmetricRectifier →
    sum Pooler → channel-major ImageVectorizer, with seeded random filters
    on ``device`` (``None`` means ``cuda``). Returns
    ``(fitted_featurize, feature_dim)``. At the default geometry 16·16·3
    = 768 raw bytes an example featurize to 768 float32 features."""
    from keystone_tpu_torch.ops.images.core import (
        Convolver,
        ImageVectorizer,
        PixelScaler,
        Pooler,
        SymmetricRectifier,
    )

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    packed = torch.as_tensor(
        rng.standard_normal((filters, conv_size * conv_size * channels))
        .astype(np.float32) * 0.1,
        device=dev,
    )
    pipe = (
        PixelScaler()
        .and_then(Convolver(packed, img, img, channels))
        .and_then(SymmetricRectifier())
        .and_then(Pooler(stride=pool_stride, pool_size=pool_size))
        .and_then(ImageVectorizer())
    )
    fitted = pipe.fit()
    probe = torch.zeros((1, img, img, channels), dtype=torch.uint8, device=dev)
    return fitted, int(fitted._batch_run(probe).shape[-1])


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
    fit_images: Optional[Any] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[object, int]:
    """The flagship SIFT+LCS→FV featurize chain as a frozen serving stage
    — raw ``(img, img, 3)`` uint8 in, ``(2·2·desc_dim·vocab,)`` float32
    features out — with its parameters on ``device`` (``None`` means
    ``cuda``). Returns ``(fitted_featurize, feature_dim)``.

    With ``fit_images`` (a ``Dataset`` of ``(img, img, 3)`` images, or an
    array of them) the PCA projections and GMMs are fitted on them, on
    ``device``, through ``compute_pca_and_fisher_branch`` (ColumnSampler →
    ColumnPCA, sampled and projected descriptors → GMM); without it, the
    seeded warm start stands in. Both freeze to the same graph."""
    dev = resolve_device(device)
    if img <= 2 * lcs_border:
        raise ValueError(
            f"img={img} leaves the LCS keypoint grid empty "
            f"(needs img > 2*lcs_border = {2 * lcs_border})"
        )
    if fit_images is None:
        pipe = flagship_pipeline(
            np.random.default_rng(seed), desc_dim, vocab, device=dev,
            sift_step=sift_step, sift_bin=sift_bin, sift_scales=sift_scales,
            sift_scale_step=sift_scale_step, lcs_stride=lcs_stride,
            lcs_border=lcs_border, lcs_patch=lcs_patch,
        )
    else:
        from keystone_tpu_torch.ops.util.nodes import VectorCombiner
        from keystone_tpu_torch.parallel.dataset import Dataset, on_device
        from keystone_tpu_torch.pipelines.images.imagenet_sift_lcs_fv import (
            ImageNetSiftLcsFVConfig,
            compute_pca_and_fisher_branch,
        )
        from keystone_tpu_torch.workflow.api import Pipeline

        # an array stays one array; a list (of images of any sizes), items
        images = on_device(Dataset.of(fit_images), dev)
        conf = ImageNetSiftLcsFVConfig(
            desc_dim=desc_dim, vocab_size=vocab, seed=seed,
            sift_scale_step=sift_scale_step, lcs_stride=lcs_stride,
            lcs_border=lcs_border, lcs_patch=lcs_patch,
        )
        sift, lcs = flagship_prefixes(
            sift_step=sift_step, sift_bin=sift_bin, sift_scales=sift_scales,
            sift_scale_step=sift_scale_step, lcs_stride=lcs_stride,
            lcs_border=lcs_border, lcs_patch=lcs_patch,
        )
        pipe = Pipeline.gather([
            compute_pca_and_fisher_branch(sift, images, conf, None, None, device=dev),
            compute_pca_and_fisher_branch(lcs, images, conf, None, None, device=dev),
        ]).and_then(VectorCombiner())
    # two branches, each a (desc_dim, 2·vocab) Fisher vector
    return pipe.fit(), 2 * 2 * desc_dim * vocab


def _hash_update(h, value: Any) -> None:
    """Fold one operator attribute into a pipeline token, every component
    framed (a type tag and a terminator: unframed, ``(1, 23)`` and
    ``(12, 3)`` would both fold to ``123``). Tensors and arrays hash by
    shape, dtype and bytes, read on the host, so a tensor on the card and
    its copy on the CPU hash alike; containers and nested dataclasses (a
    Fisher vector's GMM) recurse; primitives hash by repr; anything else
    contributes its type name only."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        h.update(b"a<" + str(tuple(t.shape)).encode() + b"|" + str(t.dtype).encode() + b"|")
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        h.update(b">")
    elif isinstance(value, (np.ndarray, np.generic)):
        arr = np.asarray(value)
        h.update(b"a<" + str(arr.shape).encode() + b"|" + str(arr.dtype).encode() + b"|")
        h.update(arr.tobytes())
        h.update(b">")
    elif isinstance(value, (str, bytes, int, float, bool, type(None))):
        h.update(b"p<" + repr(value).encode() + b">")
    elif isinstance(value, dict):
        h.update(b"d<")
        for k in sorted(value, key=repr):
            h.update(b"k<" + repr(k).encode() + b">")
            _hash_update(h, value[k])
        h.update(b">")
    elif isinstance(value, (list, tuple)):
        h.update(b"l<")
        for v in value:
            _hash_update(h, v)
        h.update(b">")
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        h.update(b"o<" + type(value).__qualname__.encode() + b"|")
        for f in dataclasses.fields(value):
            h.update(b"f<" + f.name.encode() + b">")
            _hash_update(h, getattr(value, f.name, None))
        h.update(b">")
    else:
        h.update(b"t<" + type(value).__qualname__.encode() + b">")


def operator_state(op) -> dict:
    """One operator's parameters by name: its declared dataclass fields
    (transformers are dataclasses whose fields are their parameters),
    else its ``__dict__``, without the underscore-prefixed caches that
    appear once it has run."""
    if dataclasses.is_dataclass(op):
        state = {f.name: getattr(op, f.name, None) for f in dataclasses.fields(op)}
    else:
        state = getattr(op, "__dict__", None) or {}
    return {k: v for k, v in state.items() if not k.startswith("_")}


def pipeline_token(fitted) -> str:
    """Content digest of a ``FittedPipeline``: for each node in
    topological order its id and its dependencies (the wiring), its
    operator's class and every declared field (parameters by shape, dtype
    and bytes; ``operator_state``), then the sink. Equal tokens mean the
    same operators, wired the same way, with the same parameters.
    Memoized on the pipeline (a ``FittedPipeline`` does not change once
    fit)."""
    cached = getattr(fitted, "_pipeline_token", None)
    if cached is not None:
        return cached
    h = hashlib.sha256()
    for nid in fitted._topo:
        op = fitted.graph.operators[nid]
        h.update(
            b"n<" + repr(nid).encode() + b"|"
            + ",".join(repr(d) for d in fitted.graph.dependencies[nid]).encode()
            + b">"
        )
        h.update(b"op<" + type(op).__qualname__.encode() + b">")
        state = operator_state(op)
        for name in sorted(state):
            h.update(b"f<" + name.encode() + b">")
            _hash_update(h, state[name])
    h.update(b"s<" + repr(fitted.graph.sink_dependencies[fitted.sink]).encode() + b">")
    token = h.hexdigest()
    fitted._pipeline_token = token
    return token


def featurize_token(fitted) -> str:
    """Content digest of a fitted featurize chain: the zoo's grouping key
    (``zoo/cse.py``). The same digest as ``pipeline_token``: two chains
    share a prefix only when their operators, wiring and parameters are
    equal."""
    return pipeline_token(fitted)


__all__ = [
    "build_featurize_pipeline",
    "build_flagship_featurize_pipeline",
    "featurize_token",
    "flagship_branches",
    "flagship_pipeline",
    "flagship_prefixes",
    "operator_state",
    "pipeline_token",
]
