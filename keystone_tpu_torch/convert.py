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

The random-features apps carry across the same way, each ``*_params``
taking the numpy parameters out of the port's fitted pipeline and each
``*_from_numpy`` building the port's fitted pipeline from them:

- RandomPatchCifar (``random_patch_cifar_*``), raw images to class ids:
  ``{"filters": (F, k·k·3), "img_size", "whitener": (k·k·3, k·k·3),
  "whitener_means": (k·k·3,)`` (both absent without a whitener)``, "alpha", "pool_stride", "pool_size",
  "scaler_mean": (D,), "scaler_std": (D,), "W": (D, classes),
  "feature_mean", "label_mean"}`` (or ``"intercept"``);
- MnistRandomFFT (``mnist_random_fft_*``), pixel rows to class ids:
  ``{"signs": (num_ffts, d), "rectify_threshold", "W", "feature_mean",
  "label_mean"}``;
- a kernel ridge regression model (``krr_*``), feature rows to scores:
  ``{"train_X": (n, d), "n_train", "gamma", "W": (n, classes),
  "block_size"}``.

The text models carry across from either package: ``text_params`` reads
a fitted text pipeline of the JAX package or of the port (by its nodes'
class names and attributes; it imports neither package's node classes)
and ``text_from_numpy`` builds the port's fitted pipeline, raw documents
to predictions, from

    params = {"orders": [1, ..., n],
              "feature_index": {term: column}, "dim": d   (string-keyed)
              or "num_features": d, "binarize": bool     (hashed),
              "naive_bayes": {"pi": (k,), "theta": (k, d)}
              or "logistic": {"W": (d, k)}}

Each model also converts alone: ``naive_bayes_from_numpy``,
``logistic_regression_from_numpy``, ``linear_mapper_from_numpy`` (a
``LinearMapper`` or, with ``ell=True``, an ``EllLinearMapper``: ``{"W":
(d, k), "intercept": (k,)}``); a feature index of either package goes
straight into the port's ``SparseFeatureVectorizer``.
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
    }
    out.update(_block_model_params(model))
    return out


def _block_model_params(model) -> dict:
    """A ``BlockLinearMapper``'s ``W`` and its means (or its intercept)."""
    out = {"W": _numpy(model.W)}
    if model.explicit_intercept is None and model.label_mean is not None:
        out["label_mean"] = _numpy(model.label_mean)
        if model.feature_mean is not None:
            out["feature_mean"] = _numpy(model.feature_mean)
    elif model.intercept is not None:
        out["intercept"] = _numpy(model.intercept)
    return out


def _tensors(params: dict, dev):
    """``t(name)``: ``params[name]`` as a float32 tensor on ``dev``, or None."""
    def t(name):
        a = params.get(name)
        return None if a is None else torch.tensor(np.asarray(a, np.float32), device=dev)
    return t


def _block_model(t, block_size: int):
    from keystone_tpu_torch.ops.learning.block_ls import BlockLinearMapper

    return BlockLinearMapper(
        t("W"), block_size, feature_mean=t("feature_mean"),
        label_mean=t("label_mean"), explicit_intercept=t("intercept"),
    )


def voc_from_numpy(params: dict, *, scale_step: int = 0,
                   device=None) -> Tuple[object, object]:
    """(featurize, model) fitted pipelines of a VOCSIFTFisher pipeline's
    ``params`` on ``device`` (``None`` means ``cuda``): the chain of
    ``voc_sift_fisher.featurizer`` and the ``BlockLinearMapper``, as
    ``build_pipeline`` fits them; ``featurize.and_then(model)`` maps raw
    images to class scores."""
    from keystone_tpu_torch.ops.learning.gmm import GaussianMixtureModel
    from keystone_tpu_torch.pipelines.images.voc_sift_fisher import (
        BLOCK_SIZE,
        featurizer,
    )

    t = _tensors(params, resolve_device(device))
    gmm = GaussianMixtureModel(t("means"), t("variances"), t("weights"),
                               float(params.get("threshold", 1e-4)))
    mapper = _block_model(t, BLOCK_SIZE)
    return featurizer(t("pca"), gmm, scale_step).fit(), mapper.to_pipeline().fit()


def random_patch_cifar_params(fitted) -> dict:
    """numpy parameters of a fitted RandomPatchCifar pipeline of the port
    (or of RandomCifar's conv chain with a block model), in the layout
    ``random_patch_cifar_from_numpy`` takes."""
    from keystone_tpu_torch.ops.images.core import Convolver, Pooler, SymmetricRectifier
    from keystone_tpu_torch.ops.learning.block_ls import BlockLinearMapper
    from keystone_tpu_torch.ops.stats.nodes import StandardScalerModel

    conv = _only(fitted, Convolver)
    pool = _only(fitted, Pooler)
    scaler = _only(fitted, StandardScalerModel)
    out = {
        "filters": _numpy(conv.filters), "img_size": conv.img_width,
        "alpha": _only(fitted, SymmetricRectifier).alpha,
        "pool_stride": pool.stride, "pool_size": pool.pool_size,
        "scaler_mean": _numpy(scaler.mean),
        "scaler_std": None if scaler.std is None else _numpy(scaler.std),
    }
    if conv.whitener is not None:
        out["whitener"] = _numpy(conv.whitener.whitener)
        out["whitener_means"] = _numpy(conv.whitener.means)
    out.update(_block_model_params(_only(fitted, BlockLinearMapper)))
    return out


def random_patch_cifar_from_numpy(params: dict, *, block_size: int = 4096,
                                  device=None):
    """The fitted RandomPatchCifar pipeline of ``params`` on ``device``
    (``None`` means ``cuda``): Convolver → SymmetricRectifier → Pooler →
    ImageVectorizer → StandardScalerModel → BlockLinearMapper →
    MaxClassifier, raw (size, size, 3) images to class ids."""
    from keystone_tpu_torch.ops.learning.zca import ZCAWhitener
    from keystone_tpu_torch.ops.stats.nodes import StandardScalerModel
    from keystone_tpu_torch.ops.util.nodes import MaxClassifier
    from keystone_tpu_torch.pipelines.images.random_patch_cifar import featurizer

    t = _tensors(params, resolve_device(device))
    whitener = None
    if params.get("whitener") is not None:
        whitener = ZCAWhitener(t("whitener"), t("whitener_means"))
    return (
        featurizer(t("filters"), whitener, float(params["alpha"]), int(params["pool_stride"]),
                   int(params["pool_size"]), int(params["img_size"]))
        .and_then(StandardScalerModel(t("scaler_mean"), t("scaler_std")))
        .and_then(_block_model(t, block_size))
        .and_then(MaxClassifier())
        .fit()
    )


def mnist_random_fft_params(fitted) -> dict:
    """numpy parameters of a fitted fused MnistRandomFFT pipeline of the
    port (its ``RandomFFTFeatures`` node and block model)."""
    from keystone_tpu_torch.ops.learning.block_ls import BlockLinearMapper
    from keystone_tpu_torch.ops.stats.nodes import RandomFFTFeatures

    fft = _only(fitted, RandomFFTFeatures)
    out = {"signs": _numpy(fft.signs), "rectify_threshold": fft.rectify_threshold}
    out.update(_block_model_params(_only(fitted, BlockLinearMapper)))
    return out


def mnist_random_fft_from_numpy(params: dict, *, block_size: int = 2048, device=None):
    """The fitted MnistRandomFFT pipeline of ``params`` on ``device``
    (``None`` means ``cuda``): RandomFFTFeatures → BlockLinearMapper →
    MaxClassifier, pixel rows to class ids."""
    from keystone_tpu_torch.ops.stats.nodes import RandomFFTFeatures
    from keystone_tpu_torch.ops.util.nodes import MaxClassifier

    t = _tensors(params, resolve_device(device))
    fft = RandomFFTFeatures(t("signs"), float(params.get("rectify_threshold", 0.0)))
    return fft.and_then(_block_model(t, block_size)).and_then(MaxClassifier()).fit()


def krr_params(fitted) -> dict:
    """numpy parameters of the ``KernelBlockLinearMapper`` a fitted
    pipeline of the port holds (or of the mapper itself). A model fitted on
    training rows sharded over processes holds only this process's rows:
    every shard's rows are brought here (``Dataset.global_rows``) to pair
    with the whole of ``W``, so every process of the group calls this
    together, and each gets the same parameters."""
    from keystone_tpu_torch.ops.learning.kernel import KernelBlockLinearMapper

    m = fitted if isinstance(fitted, KernelBlockLinearMapper) else _only(
        fitted, KernelBlockLinearMapper)
    kt = m.kernel_transformer
    rows = kt.train_rows
    train_X = rows.global_rows(kt.train_X, 0, rows.padded_n)
    return {"train_X": _numpy(train_X), "n_train": int(kt.n_train),
            "gamma": float(kt.gamma), "W": _numpy(m.model), "block_size": m.block_size}


def krr_from_numpy(params: dict, *, device=None):
    """The fitted kernel ridge regression model of ``params`` on ``device``
    (``None`` means ``cuda``): feature rows to (rows, classes) scores,
    K(x, train) · W accumulated block by block."""
    from keystone_tpu_torch.ops.learning.kernel import (
        GaussianKernelTransformer,
        KernelBlockLinearMapper,
    )
    from keystone_tpu_torch.parallel.dataset import Dataset

    t = _tensors(params, resolve_device(device))
    n = int(params["n_train"])
    train_X = t("train_X")
    kt = GaussianKernelTransformer(train_X, n, float(params["gamma"]),
                                   train_rows=Dataset.from_array(train_X, n=n))
    return KernelBlockLinearMapper(t("W"), int(params["block_size"]), kt, n).to_pipeline().fit()


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


def _host(a) -> np.ndarray:
    """A tensor of either package (a torch tensor or a JAX array) as numpy."""
    return _numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)


def _nodes_named(fitted, *names):
    return [o for o in fitted.graph.operators.values() if type(o).__name__ in names]


def text_params(fitted) -> dict:
    """numpy parameters of a fitted NewsgroupsPipeline or
    AmazonReviewsPipeline, of the JAX package or the port, in the layout
    ``text_from_numpy`` takes."""
    out: dict = {}
    (grams,) = _nodes_named(fitted, "NGramsFeaturizer", "FusedTextHashTF") or [None]
    if grams is None:
        raise ValueError("no n-gram featurizer in the pipeline")
    out["orders"] = [int(o) for o in grams.orders]
    if type(grams).__name__ == "FusedTextHashTF":
        out.update(num_features=int(grams.num_features), binarize=bool(grams.binarize))
    else:
        (vec,) = _nodes_named(fitted, "SparseFeatureVectorizer")
        out.update(feature_index=dict(vec.feature_index), dim=int(vec.dim))
    nb = _nodes_named(fitted, "NaiveBayesModel")
    if nb:
        out["naive_bayes"] = {"pi": _host(nb[0].pi), "theta": _host(nb[0].theta)}
    else:
        (lr,) = _nodes_named(fitted, "LogisticRegressionModel")
        out["logistic"] = {"W": _host(lr.W)}
    return out


def naive_bayes_from_numpy(params: dict, *, device=None):
    """``NaiveBayesModel(pi, theta)`` on ``device`` (``None``: cuda)."""
    from keystone_tpu_torch.ops.learning.classifiers import NaiveBayesModel

    t = _tensors(params, resolve_device(device))
    return NaiveBayesModel(t("pi"), t("theta"))


def logistic_regression_from_numpy(params: dict, *, device=None):
    """``LogisticRegressionModel(W)`` on ``device`` (``None``: cuda)."""
    from keystone_tpu_torch.ops.learning.classifiers import LogisticRegressionModel

    return LogisticRegressionModel(_tensors(params, resolve_device(device))("W"))


def linear_mapper_from_numpy(params: dict, *, ell: bool = False, device=None):
    """``LinearMapper(W, intercept)`` on ``device`` (``None``: cuda), or
    with ``ell`` an ``EllLinearMapper``, which takes ELL rows."""
    from keystone_tpu_torch.ops.learning.linear import LinearMapper
    from keystone_tpu_torch.ops.learning.sparse_ell import EllLinearMapper

    t = _tensors(params, resolve_device(device))
    return (EllLinearMapper if ell else LinearMapper)(t("W"), intercept=t("intercept"))


def text_from_numpy(params: dict, *, device=None):
    """The port's fitted text pipeline, raw documents to predicted class
    ids, from ``params`` (``text_params``' layout) on ``device``
    (``None``: cuda): the string-keyed featurizer and vectorizer or the
    fused hashed featurizer, then Naive Bayes and ``MaxClassifier`` or
    logistic regression."""
    from keystone_tpu_torch.ops.nlp import FusedTextHashTF, LowerCase, NGramsFeaturizer, Tokenizer, Trim
    from keystone_tpu_torch.ops.stats.nodes import TermFrequency, presence
    from keystone_tpu_torch.ops.util.nodes import MaxClassifier, SparseFeatureVectorizer

    dev = resolve_device(device)
    orders = list(params["orders"])
    if "num_features" in params:
        pipe = FusedTextHashTF(orders, int(params["num_features"]),
                               binarize=bool(params["binarize"])).to_pipeline()
    else:
        pipe = (Trim().and_then(LowerCase()).and_then(Tokenizer())
                .and_then(NGramsFeaturizer(orders)).and_then(TermFrequency(presence))
                .and_then(SparseFeatureVectorizer(dict(params["feature_index"]),
                                                  int(params["dim"]))))
    if "naive_bayes" in params:
        pipe = pipe.and_then(naive_bayes_from_numpy(params["naive_bayes"], device=dev))
        pipe = pipe.and_then(MaxClassifier())
    else:
        pipe = pipe.and_then(logistic_regression_from_numpy(params["logistic"], device=dev))
    return pipe.fit()


def affine_params(fitted) -> list:
    """numpy ``(W, b)`` of every ``tanh(x @ W + b)`` node of the demo
    model (``serving/bench.py`` ``build_pipeline``) of either package, in
    chain order."""
    nodes = sorted(
        ((nid, op) for nid, op in fitted.graph.operators.items()
         if type(op).__name__ == "_Affine"),
        key=lambda item: item[0].id,
    )
    if not nodes:
        raise ValueError("no affine node in the pipeline")
    return [(_host(op.W), _host(op.b)) for _, op in nodes]
