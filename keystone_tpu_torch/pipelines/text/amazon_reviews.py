"""AmazonReviewsPipeline — n-gram logistic regression sentiment
(counterpart of ``keystone_tpu/pipelines/text/amazon_reviews.py``).

Reference: pipelines/text/AmazonReviewsPipeline.scala:18-60 — Trim ->
LowerCase -> Tokenizer -> NGramsFeaturizer(1..n) -> TermFrequency(x=>1) ->
CommonSparseFeatures -> LogisticRegression(2 classes), evaluated with the
binary evaluator; or, with ``--hashing``, the fused native hashed n-gram
featurizer. The text is featurized on the host into sparse rows; the
L-BFGS fit and the scoring run on ``device`` (``None`` means ``cuda``).

    python -m keystone_tpu_torch.pipelines.text.amazon_reviews \
        --trainLocation train.json --testLocation test.json
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Union

import torch

from keystone_tpu_torch._device import resolve_device
from keystone_tpu_torch.evaluation import BinaryClassifierEvaluator
from keystone_tpu_torch.evaluation.multiclass import host_array
from keystone_tpu_torch.loaders.csv_loader import LabeledData
from keystone_tpu_torch.loaders.text_loaders import AmazonReviewsDataLoader
from keystone_tpu_torch.ops.learning.classifiers import LogisticRegressionEstimator
from keystone_tpu_torch.ops.nlp import FusedTextHashTF
from keystone_tpu_torch.ops.util.nodes import CommonSparseFeatures
from keystone_tpu_torch.parallel.dataset import on_device
from keystone_tpu_torch.pipelines.text.newsgroups import featurizer
from keystone_tpu_torch.workflow.api import Pipeline


@dataclasses.dataclass
class AmazonReviewsConfig:
    train_location: str = ""
    test_location: str = ""
    threshold: float = 3.5
    n_grams: int = 2
    common_features: int = 100_000
    num_iters: int = 20
    hashing: bool = False  # hashed n-gram features through the fused
    # native featurizer instead of the string-keyed chain (the
    # reference's alternative: nodes/nlp/HashingTF.scala)


def build_pipeline(train: LabeledData, conf: AmazonReviewsConfig,
                   device: Optional[Union[str, torch.device]] = None) -> Pipeline:
    """The unfitted predictor, logistic regression fit on ``train`` on
    ``device`` (``None`` means ``cuda``)."""
    dev = resolve_device(device)
    labels = on_device(train.labels, dev)
    estimator = LogisticRegressionEstimator(2, num_iters=conf.num_iters)
    if conf.hashing:
        hashed = FusedTextHashTF(
            range(1, conf.n_grams + 1), conf.common_features, binarize=True
        ).to_pipeline()
        return hashed.and_then(estimator, train.data, labels)
    return featurizer(conf).and_then(
        CommonSparseFeatures(conf.common_features), train.data
    ).and_then(estimator, train.data, labels)


def run(train: LabeledData, test: LabeledData, conf: AmazonReviewsConfig,
        device: Optional[Union[str, torch.device]] = None):
    """Fit on ``train`` and classify ``test`` on ``device`` (``None`` means
    ``cuda``); returns the unfitted predictor and the test metrics."""
    predictor = build_pipeline(train, conf, device=device)
    pred = host_array(predictor(test.data).get().array())
    metrics = BinaryClassifierEvaluator().evaluate(
        pred > 0, host_array(test.labels.array()) > 0
    )
    return predictor, metrics


def main(argv: Optional[List[str]] = None,
         device: Optional[Union[str, torch.device]] = None) -> int:
    """The JAX package's flags and defaults, on ``device`` (``None`` means
    ``cuda``); prints the metrics."""
    p = argparse.ArgumentParser(description="AmazonReviewsPipeline")
    p.add_argument("--trainLocation", required=True)
    p.add_argument("--testLocation", required=True)
    p.add_argument("--threshold", type=float, default=3.5)
    p.add_argument("--nGrams", type=int, default=2)
    p.add_argument("--commonFeatures", type=int, default=100_000)
    p.add_argument("--numIters", type=int, default=20)
    p.add_argument("--hashing", action="store_true",
                   help="fused native hashed n-gram features")
    a = p.parse_args(argv)
    dev = resolve_device(device)  # before the data is read
    conf = AmazonReviewsConfig(
        a.trainLocation, a.testLocation, a.threshold, a.nGrams,
        a.commonFeatures, a.numIters, a.hashing,
    )
    train = AmazonReviewsDataLoader(conf.train_location, conf.threshold)
    test = AmazonReviewsDataLoader(conf.test_location, conf.threshold)
    _, metrics = run(train, test, conf, device=dev)
    print(metrics.summary())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
