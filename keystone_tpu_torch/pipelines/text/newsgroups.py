"""NewsgroupsPipeline — n-gram Naive Bayes text classification
(counterpart of ``keystone_tpu/pipelines/text/newsgroups.py``).

Reference: pipelines/text/NewsgroupsPipeline.scala:18-45 — Trim ->
LowerCase -> Tokenizer -> NGramsFeaturizer(1..n) -> TermFrequency(x=>1) ->
CommonSparseFeatures(100k) -> NaiveBayes -> MaxClassifier; or, with
``--hashing``, the fused native hashed n-gram featurizer in place of the
string-keyed chain. The text is featurized on the host into sparse rows;
Naive Bayes fits and scores on ``device`` (``None`` means ``cuda``).

    python -m keystone_tpu_torch.pipelines.text.newsgroups \
        --trainLocation 20news-bydate-train --testLocation 20news-bydate-test
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Union

import torch

from keystone_tpu_torch._device import resolve_device
from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
from keystone_tpu_torch.loaders.csv_loader import LabeledData
from keystone_tpu_torch.loaders.text_loaders import NEWSGROUPS_CLASSES, NewsgroupsDataLoader
from keystone_tpu_torch.ops.learning.classifiers import NaiveBayesEstimator
from keystone_tpu_torch.ops.nlp import FusedTextHashTF, LowerCase, NGramsFeaturizer, Tokenizer, Trim
from keystone_tpu_torch.ops.stats.nodes import TermFrequency, presence
from keystone_tpu_torch.ops.util.nodes import CommonSparseFeatures, MaxClassifier
from keystone_tpu_torch.parallel.dataset import on_device
from keystone_tpu_torch.workflow.api import Pipeline


@dataclasses.dataclass
class NewsgroupsConfig:
    train_location: str = ""
    test_location: str = ""
    n_grams: int = 2
    common_features: int = 100_000
    hashing: bool = False  # hashed n-gram features through the fused
    # native featurizer instead of string-keyed top-K selection (the
    # reference's alternative: nodes/nlp/HashingTF.scala)


def featurizer(conf) -> Pipeline:
    """The string-keyed chain up to the term-presence dicts (shared with
    AmazonReviewsPipeline)."""
    return (
        Trim()
        .and_then(LowerCase())
        .and_then(Tokenizer())
        .and_then(NGramsFeaturizer(range(1, conf.n_grams + 1)))
        .and_then(TermFrequency(presence))
    )


def build_pipeline(train: LabeledData, conf: NewsgroupsConfig,
                   device: Optional[Union[str, torch.device]] = None) -> Pipeline:
    """The unfitted predictor, Naive Bayes fit on ``train`` on ``device``
    (``None`` means ``cuda``)."""
    dev = resolve_device(device)
    labels = on_device(train.labels, dev)
    num_classes = len(NEWSGROUPS_CLASSES)
    if conf.hashing:
        hashed = FusedTextHashTF(
            range(1, conf.n_grams + 1), conf.common_features, binarize=True
        ).to_pipeline()
        return hashed.and_then(
            NaiveBayesEstimator(num_classes), train.data, labels
        ).and_then(MaxClassifier())
    return featurizer(conf).and_then(
        CommonSparseFeatures(conf.common_features), train.data
    ).and_then(
        NaiveBayesEstimator(num_classes), train.data, labels
    ).and_then(MaxClassifier())


def run(train: LabeledData, test: LabeledData, conf: NewsgroupsConfig,
        device: Optional[Union[str, torch.device]] = None):
    """Fit on ``train`` and classify ``test`` on ``device`` (``None`` means
    ``cuda``); returns the unfitted predictor and the test metrics."""
    predictor = build_pipeline(train, conf, device=device)
    evaluator = MulticlassClassifierEvaluator(len(NEWSGROUPS_CLASSES))
    metrics = evaluator.evaluate(predictor(test.data), test.labels)
    return predictor, metrics


def main(argv: Optional[List[str]] = None,
         device: Optional[Union[str, torch.device]] = None) -> int:
    """The JAX package's flags and defaults, on ``device`` (``None`` means
    ``cuda``); prints the metrics."""
    p = argparse.ArgumentParser(description="NewsgroupsPipeline")
    p.add_argument("--trainLocation", required=True)
    p.add_argument("--testLocation", required=True)
    p.add_argument("--nGrams", type=int, default=2)
    p.add_argument("--commonFeatures", type=int, default=100_000)
    p.add_argument("--hashing", action="store_true",
                   help="fused native hashed n-gram features")
    a = p.parse_args(argv)
    dev = resolve_device(device)  # before the data is read
    conf = NewsgroupsConfig(
        a.trainLocation, a.testLocation, a.nGrams, a.commonFeatures, a.hashing,
    )
    train = NewsgroupsDataLoader(conf.train_location)
    test = NewsgroupsDataLoader(conf.test_location)
    _, metrics = run(train, test, conf, device=dev)
    print(metrics.summary(NEWSGROUPS_CLASSES))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
