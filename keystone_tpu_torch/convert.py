"""Carry the flagship's fitted parameters as numpy arrays.

``flagship_from_numpy`` takes the fitted parameters of an ImageNetSiftLcsFV
serving chain as numpy arrays — as taken out of the JAX package's
``FittedPipeline``, or by ``flagship_params`` out of the port's — and
returns the port's frozen featurize chain and model head:

    params = {
        "sift": {"pca": (128, desc_dim), "means": (desc_dim, vocab),
                 "variances": (desc_dim, vocab), "weights": (vocab,),
                 "threshold": float},
        "lcs":  {... the same, with "pca": (96, desc_dim)},
        "model": {"W": (features, classes), "intercept": (classes,)},
    }

``pca`` is ``BatchPCATransformer.pca_mat`` (projection = ``pcaᵀ · x``).

``voc_from_numpy`` does the same for a fitted VOCSIFTFisher pipeline, whole
(featurize chain and model), from

    params = {"pca": (128, desc_dim), "means": (desc_dim, vocab),
              "variances": (desc_dim, vocab), "weights": (vocab,),
              "threshold": float,
              "W": (2 · desc_dim · vocab, classes),
              "feature_mean": (features,), "label_mean": (classes,)}

or ``"intercept"`` (classes,) in place of the two means; ``voc_params``
takes them out of the port's fitted pipeline.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from keystone_tpu_torch._device import resolve_device


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def flagship_params(fitted_featurize, model=None) -> dict:
    """numpy parameters of a fitted flagship chain of the port, in the
    layout ``flagship_from_numpy`` takes: each branch's
    ``BatchPCATransformer`` (128 input rows for SIFT, 96 for LCS) and the
    Fisher-vector node that consumes it, and ``"model"`` from the
    ``BlockLinearMapper`` of ``model`` (a mapper or a fitted pipeline that
    holds one) or, when ``model`` is None, of ``fitted_featurize`` if it
    holds one."""
    from keystone_tpu_torch.ops.images.fisher_vector import (
        FisherVector,
        FisherVectorFused,
    )
    from keystone_tpu_torch.ops.learning.block_ls import BlockLinearMapper
    from keystone_tpu_torch.ops.learning.pca import BatchPCATransformer

    g = fitted_featurize.graph
    out = {}
    for nid, op in g.operators.items():
        if not isinstance(op, BatchPCATransformer):
            continue
        fv = next(
            o for n, o in g.operators.items()
            if isinstance(o, (FisherVector, FisherVectorFused))
            and g.dependencies[n] == (nid,)
        )
        pca = _numpy(op.pca_mat)
        branch = {128: "sift", 96: "lcs"}[pca.shape[0]]
        gmm = fv.gmm
        out[branch] = {
            "pca": pca, "means": _numpy(gmm.means),
            "variances": _numpy(gmm.variances), "weights": _numpy(gmm.weights),
            "threshold": gmm.weight_threshold,
        }
    if set(out) != {"sift", "lcs"}:
        raise ValueError(f"expected a SIFT and an LCS branch, found {sorted(out)}")

    def mappers(p):
        return [o for o in p.graph.operators.values() if isinstance(o, BlockLinearMapper)]

    if model is None:
        found = mappers(fitted_featurize)
        model = found[0] if len(found) == 1 else None
    elif not isinstance(model, BlockLinearMapper):
        (model,) = mappers(model)
    if model is not None:
        icpt = model.intercept
        out["model"] = {
            "W": _numpy(model.W),
            "intercept": None if icpt is None else _numpy(icpt),
        }
    return out


def _only(fitted, types) -> object:
    found = [o for o in fitted.graph.operators.values() if isinstance(o, types)]
    if len(found) != 1:
        raise ValueError(f"expected one {types} node, found {len(found)}")
    return found[0]


def voc_params(fitted) -> dict:
    """numpy parameters of a fitted VOCSIFTFisher pipeline of the port, in
    the layout ``voc_from_numpy`` takes."""
    from keystone_tpu_torch.ops.images.fisher_vector import (
        FisherVector,
        FisherVectorFused,
    )
    from keystone_tpu_torch.ops.learning.block_ls import BlockLinearMapper
    from keystone_tpu_torch.ops.learning.pca import BatchPCATransformer

    gmm = _only(fitted, (FisherVector, FisherVectorFused)).gmm
    model = _only(fitted, BlockLinearMapper)
    out = {
        "pca": _numpy(_only(fitted, BatchPCATransformer).pca_mat),
        "means": _numpy(gmm.means), "variances": _numpy(gmm.variances),
        "weights": _numpy(gmm.weights), "threshold": gmm.weight_threshold,
        "W": _numpy(model.W),
    }
    if model.explicit_intercept is None and model.label_mean is not None:
        out["label_mean"] = _numpy(model.label_mean)
        if model.feature_mean is not None:
            out["feature_mean"] = _numpy(model.feature_mean)
    elif model.intercept is not None:
        out["intercept"] = _numpy(model.intercept)
    return out


def voc_from_numpy(params: dict, *, scale_step: int = 0,
                   device=None) -> Tuple[object, object]:
    """(featurize, model) fitted pipelines of a VOCSIFTFisher pipeline's
    ``params`` on ``device`` (``None`` means ``cuda``): the chain of
    ``voc_sift_fisher.featurizer`` and the ``BlockLinearMapper``, as
    ``build_pipeline`` fits them; ``featurize.and_then(model)`` maps raw
    images to class scores."""
    from keystone_tpu_torch.ops.learning.block_ls import BlockLinearMapper
    from keystone_tpu_torch.ops.learning.gmm import GaussianMixtureModel
    from keystone_tpu_torch.pipelines.images.voc_sift_fisher import (
        BLOCK_SIZE,
        featurizer,
    )

    dev = resolve_device(device)

    def t(name):
        a = params.get(name)
        return None if a is None else torch.tensor(np.asarray(a, np.float32), device=dev)

    gmm = GaussianMixtureModel(t("means"), t("variances"), t("weights"),
                               float(params.get("threshold", 1e-4)))
    mapper = BlockLinearMapper(
        t("W"), BLOCK_SIZE, feature_mean=t("feature_mean"),
        label_mean=t("label_mean"), explicit_intercept=t("intercept"),
    )
    return featurizer(t("pca"), gmm, scale_step).fit(), mapper.to_pipeline().fit()


def model_head(W: np.ndarray, intercept: Optional[np.ndarray], top_k: int,
               device) -> object:
    """``BlockLinearMapper(W, intercept) → TopKClassifier(top_k)``, fitted."""
    from keystone_tpu_torch.ops.learning.block_ls import BlockLinearMapper
    from keystone_tpu_torch.ops.util.nodes import TopKClassifier

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    mapper = BlockLinearMapper(
        t(W), int(W.shape[0]),
        explicit_intercept=None if intercept is None else t(intercept),
    )
    return mapper.and_then(TopKClassifier(top_k)).fit()


def flagship_from_numpy(
    params: dict,
    *,
    top_k: int = 5,
    sift_step: int = 3,
    sift_bin: int = 4,
    sift_scales: int = 4,
    sift_scale_step: int = 1,
    lcs_stride: int = 4,
    lcs_border: int = 16,
    lcs_patch: int = 6,
    device=None,
) -> Tuple[object, Optional[object]]:
    """(featurize, model) fitted pipelines on ``device`` (``None`` means
    ``cuda``). ``model`` is None when ``params`` has no ``"model"``."""
    from keystone_tpu_torch.serving.featurize import (
        flagship_branches,
        flagship_prefixes,
    )

    dev = resolve_device(device)
    sift, lcs = flagship_prefixes(
        sift_step=sift_step, sift_bin=sift_bin, sift_scales=sift_scales,
        sift_scale_step=sift_scale_step, lcs_stride=lcs_stride,
        lcs_border=lcs_border, lcs_patch=lcs_patch,
    )
    featurize = flagship_branches(
        sift, lcs, params["sift"], params["lcs"], dev
    ).fit()
    model = None
    if "model" in params:
        m = params["model"]
        model = model_head(
            np.asarray(m["W"]), m.get("intercept"), top_k, dev
        )
    return featurize, model
