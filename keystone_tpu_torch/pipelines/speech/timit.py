"""TimitPipeline — random cosine features and block least squares for
phone classification (counterpart of
``keystone_tpu/pipelines/speech/timit.py``).

Reference: pipelines/speech/TimitPipeline.scala:37-100 —
gather(numCosines × CosineRandomFeatures(440 → 4096, gaussian or cauchy))
→ VectorCombiner → BlockLeastSquaresEstimator(4096, numEpochs, lambda) →
MaxClassifier. The branches draw their frequencies as the JAX package's
do (``np.random.default_rng(seed + i)``); every node fits and runs on
``device`` (``None`` means ``cuda``).

    python -m keystone_tpu_torch.pipelines.speech.timit \
        --trainDataLocation train.csv --trainLabelsLocation train.labels \
        --testDataLocation test.csv --testLabelsLocation test.labels
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Union

import torch

from keystone_tpu_torch._device import resolve_device
from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
from keystone_tpu_torch.loaders.csv_loader import LabeledData
from keystone_tpu_torch.loaders.text_loaders import (
    TIMIT_DIMENSION,
    TIMIT_NUM_CLASSES,
    TimitFeaturesDataLoader,
)
from keystone_tpu_torch.ops.learning.block_ls import BlockLeastSquaresEstimator
from keystone_tpu_torch.ops.stats.nodes import CosineRandomFeatures
from keystone_tpu_torch.ops.util.nodes import (
    ClassLabelIndicators,
    MaxClassifier,
    VectorCombiner,
)
from keystone_tpu_torch.parallel.dataset import on_device
from keystone_tpu_torch.workflow.api import Pipeline

NUM_COSINE_FEATURES = 4096


@dataclasses.dataclass
class TimitConfig:
    train_data_location: str = ""
    train_labels_location: str = ""
    test_data_location: str = ""
    test_labels_location: str = ""
    num_cosines: int = 40
    gamma: float = 0.05555
    num_epochs: int = 5
    lam: float = 0.0
    rf_type: str = "gaussian"  # or "cauchy"
    seed: int = 123
    num_cosine_features: int = NUM_COSINE_FEATURES
    dim: int = TIMIT_DIMENSION
    num_classes: int = TIMIT_NUM_CLASSES


def build_pipeline(train: LabeledData, conf: TimitConfig,
                   device: Optional[Union[str, torch.device]] = None) -> Pipeline:
    """The unfitted predictor, its solver fit on ``train`` moved to
    ``device`` (``None`` means ``cuda``)."""
    dev = resolve_device(device)
    labels = ClassLabelIndicators(conf.num_classes)(on_device(train.labels, dev))
    branches = [
        CosineRandomFeatures.create(
            conf.dim, conf.num_cosine_features, conf.gamma,
            seed=conf.seed + i, distribution=conf.rf_type, device=dev,
        )
        for i in range(conf.num_cosines)
    ]
    featurizer = Pipeline.gather(branches).and_then(VectorCombiner())
    return featurizer.and_then(
        BlockLeastSquaresEstimator(
            conf.num_cosine_features, num_iter=conf.num_epochs, lam=conf.lam
        ),
        on_device(train.data, dev),
        labels,
    ).and_then(MaxClassifier())


def run(train: LabeledData, test: LabeledData, conf: TimitConfig,
        device: Optional[Union[str, torch.device]] = None):
    """Fit on ``train`` and classify ``test`` on ``device`` (``None`` means
    ``cuda``); returns the unfitted predictor and the test metrics."""
    dev = resolve_device(device)
    predictor = build_pipeline(train, conf, device=dev)
    evaluator = MulticlassClassifierEvaluator(conf.num_classes)
    metrics = evaluator.evaluate(predictor(on_device(test.data, dev)), test.labels)
    return predictor, metrics


def main(argv: Optional[List[str]] = None,
         device: Optional[Union[str, torch.device]] = None) -> int:
    """The JAX package's flags and defaults, on ``device`` (``None`` means
    ``cuda``): TIMIT feature CSVs and their "row label" files. Prints the
    metrics and the time."""
    p = argparse.ArgumentParser(description="TimitPipeline")
    p.add_argument("--trainDataLocation", required=True)
    p.add_argument("--trainLabelsLocation", required=True)
    p.add_argument("--testDataLocation", required=True)
    p.add_argument("--testLabelsLocation", required=True)
    p.add_argument("--numCosines", type=int, default=40)
    p.add_argument("--gamma", type=float, default=0.05555)
    p.add_argument("--numEpochs", type=int, default=5)
    p.add_argument("--lambda", dest="lam", type=float, default=0.0)
    p.add_argument("--rfType", default="gaussian")
    a = p.parse_args(argv)
    dev = resolve_device(device)  # before the data is read
    conf = TimitConfig(
        a.trainDataLocation, a.trainLabelsLocation, a.testDataLocation,
        a.testLabelsLocation, a.numCosines, a.gamma, a.numEpochs, a.lam,
        a.rfType,
    )
    data = TimitFeaturesDataLoader(
        conf.train_data_location, conf.train_labels_location,
        conf.test_data_location, conf.test_labels_location, device=dev,
    )
    t0 = time.time()
    _, metrics = run(data.train, data.test, conf, device=dev)
    print(metrics.summary())
    print(f"Total time: {time.time() - t0:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
