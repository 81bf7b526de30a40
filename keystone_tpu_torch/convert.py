"""Build the port's flagship pipelines from numpy parameters.

``flagship_from_numpy`` takes the fitted parameters of an ImageNetSiftLcsFV
serving chain as numpy arrays — as taken out of the JAX package's
``FittedPipeline``, or from anywhere else — and returns the port's frozen
featurize chain and model head:

    params = {
        "sift": {"pca": (128, desc_dim), "means": (desc_dim, vocab),
                 "variances": (desc_dim, vocab), "weights": (vocab,),
                 "threshold": float},
        "lcs":  {... the same, with "pca": (96, desc_dim)},
        "model": {"W": (features, classes), "intercept": (classes,)},
    }

``pca`` is ``BatchPCATransformer.pca_mat`` (projection = ``pcaᵀ · x``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from keystone_tpu_torch._device import resolve_device


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
