"""MnistRandomFFT — the minimum end-to-end application (counterpart of
``keystone_tpu/pipelines/images/mnist_random_fft.py``).

Reference: pipelines/images/mnist/MnistRandomFFT.scala:21,40-49 —
gather(numFFTs × [RandomSignNode → PaddedFFT → LinearRectifier]) →
VectorCombiner → BlockLeastSquaresEstimator(blockSize=BlockSize, 1 pass) →
MaxClassifier, evaluated with MulticlassClassifierEvaluator.

``fused=True`` (the default) runs all branches as one ``RandomFFTFeatures``
node; ``fused=False`` is the reference's literal per-branch gather. Both
draw the same signs. Every node fits and runs on ``device`` (``None``
means ``cuda``).

    python -m keystone_tpu_torch.pipelines.images.mnist_random_fft \
        --trainLocation mnist_train.csv --testLocation mnist_test.csv
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Union

import numpy as np
import torch

from keystone_tpu_torch._device import resolve_device
from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
from keystone_tpu_torch.loaders.csv_loader import LabeledData
from keystone_tpu_torch.ops.learning.block_ls import BlockLeastSquaresEstimator
from keystone_tpu_torch.ops.stats.nodes import (
    LinearRectifier,
    PaddedFFT,
    RandomFFTFeatures,
    RandomSignNode,
)
from keystone_tpu_torch.ops.util.nodes import (
    ClassLabelIndicators,
    MaxClassifier,
    VectorCombiner,
)
from keystone_tpu_torch.parallel.dataset import on_device
from keystone_tpu_torch.workflow.api import Pipeline

NUM_CLASSES = 10
MNIST_DIM = 784


@dataclasses.dataclass
class MnistRandomFFTConfig:
    train_location: str = ""
    test_location: str = ""
    num_ffts: int = 4
    block_size: int = 2048
    lam: float = 0.0
    seed: int = 0
    fused: bool = True  # one batched node for all branches
    # (RandomFFTFeatures) vs the reference's literal per-branch gather


def build_pipeline(train: LabeledData, conf: MnistRandomFFTConfig, d: int = MNIST_DIM,
                   device: Optional[Union[str, torch.device]] = None) -> Pipeline:
    """The unfitted predictor, its solver fit on ``train`` moved to
    ``device`` (``None`` means ``cuda``)."""
    dev = resolve_device(device)
    if conf.fused:
        featurizer = RandomFFTFeatures.create(
            d, conf.num_ffts, seed=conf.seed, device=dev
        ).to_pipeline()
    else:
        branches = [
            RandomSignNode.create(d, seed=conf.seed + i, device=dev)
            .and_then(PaddedFFT())
            .and_then(LinearRectifier(0.0))
            for i in range(conf.num_ffts)
        ]
        featurizer = Pipeline.gather(branches).and_then(VectorCombiner())
    labels = ClassLabelIndicators(NUM_CLASSES)(on_device(train.labels, dev))
    return featurizer.and_then(
        BlockLeastSquaresEstimator(conf.block_size, num_iter=1, lam=conf.lam),
        on_device(train.data, dev),
        labels,
    ).and_then(MaxClassifier())


def run(train: LabeledData, test: LabeledData, conf: MnistRandomFFTConfig,
        device: Optional[Union[str, torch.device]] = None):
    """Fit on ``train`` and classify ``test`` on ``device`` (``None`` means
    ``cuda``); returns the unfitted predictor and the test metrics."""
    dev = resolve_device(device)
    pipeline = build_pipeline(train, conf, device=dev)
    evaluator = MulticlassClassifierEvaluator(NUM_CLASSES)
    metrics = evaluator.evaluate(pipeline(on_device(test.data, dev)), test.labels)
    return pipeline, metrics


def synthetic_mnist(n_train: int = 512, n_test: int = 128, seed: int = 0) -> tuple:
    """Deterministic synthetic stand-in when no CSV paths are given: one
    Gaussian blob per class in pixel space (the JAX package's draws)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((NUM_CLASSES, MNIST_DIM)) * 2.0

    def make(n):
        y = rng.integers(0, NUM_CLASSES, n)
        x = centers[y] + rng.standard_normal((n, MNIST_DIM))
        return LabeledData.of(torch.from_numpy(y.astype(np.int32)),
                              torch.from_numpy(x.astype(np.float32)))

    return make(n_train), make(n_test)


def main(argv: Optional[List[str]] = None,
         device: Optional[Union[str, torch.device]] = None) -> int:
    """The JAX package's flags and defaults, on ``device`` (``None`` means
    ``cuda``): MNIST CSVs (label first, 1-based) at ``--trainLocation`` and
    ``--testLocation``, or seeded synthetic data without them. Prints the
    metrics and the time."""
    p = argparse.ArgumentParser(description="MnistRandomFFT")
    p.add_argument("--trainLocation", default="")
    p.add_argument("--testLocation", default="")
    p.add_argument("--numFFTs", type=int, default=4)
    p.add_argument("--blockSize", type=int, default=2048)
    p.add_argument("--lambda", dest="lam", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    dev = resolve_device(device)  # before the data is read
    conf = MnistRandomFFTConfig(
        a.trainLocation, a.testLocation, a.numFFTs, a.blockSize, a.lam, a.seed
    )
    if conf.train_location:
        train = LabeledData.from_csv(conf.train_location, label_offset=1)
        test = LabeledData.from_csv(conf.test_location, label_offset=1)
    else:
        train, test = synthetic_mnist(seed=conf.seed)
    t0 = time.time()
    _, metrics = run(train, test, conf, device=dev)
    print(metrics.summary())
    print(f"Total time: {time.time() - t0:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
