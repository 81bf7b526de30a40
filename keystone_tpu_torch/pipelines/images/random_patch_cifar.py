"""RandomPatchCifar — random-patch convolutional features + ZCA + pooling
+ block least squares (counterpart of
``keystone_tpu/pipelines/images/random_patch_cifar.py``).

Reference: pipelines/images/cifar/RandomPatchCifar.scala:21 — sample random
patches via Windower, normalize + ZCA-whiten them into a filter bank
(computed eagerly at pipeline-construction time, :45-57), then
Convolver -> SymmetricRectifier -> sum Pooler -> vectorize ->
StandardScaler -> BlockLeastSquaresEstimator(4096, 1, λ) -> argmax.

Every node fits and runs on ``device`` (``None`` means ``cuda``): ``run``
and ``build_pipeline`` put the data there. The windows, the patch sample
and the filters are drawn with numpy generators seeded as in the JAX
package, so both packages build the same filter bank (up to the float32
rounding of the ZCA's SVD).

    python -m keystone_tpu_torch.pipelines.images.random_patch_cifar \
        --trainLocation data_batch_all.bin --testLocation test_batch.bin
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
from keystone_tpu_torch.loaders.cifar import CifarLoader, LabeledImages
from keystone_tpu_torch.ops.images.core import (
    Convolver,
    ImageVectorizer,
    Pooler,
    SymmetricRectifier,
    Windower,
)
from keystone_tpu_torch.ops.learning.block_ls import BlockLeastSquaresEstimator
from keystone_tpu_torch.ops.learning.zca import ZCAWhitenerEstimator
from keystone_tpu_torch.ops.stats.nodes import Sampler, StandardScaler
from keystone_tpu_torch.ops.util.nodes import ClassLabelIndicators, MaxClassifier
from keystone_tpu_torch.parallel.dataset import Dataset, on_device
from keystone_tpu_torch.workflow.api import Pipeline

NUM_CLASSES = 10
IMAGE_SIZE = 32
NUM_CHANNELS = 3
WHITENER_SAMPLE = 100_000


@dataclasses.dataclass
class RandomCifarConfig:
    train_location: str = ""
    test_location: str = ""
    num_filters: int = 100
    whitening_epsilon: float = 0.1
    patch_size: int = 6
    patch_steps: int = 1
    pool_size: int = 14
    pool_stride: int = 13
    alpha: float = 0.25
    lam: float = 0.0
    seed: int = 0


def _normalize_rows(mat: np.ndarray, alpha: float) -> np.ndarray:
    """Stats.normalizeRows (reference: utils/Stats.scala:112-123)."""
    means = np.nan_to_num(mat.mean(axis=1))
    var = ((mat - means[:, None]) ** 2).sum(axis=1) / (mat.shape[1] - 1)
    sds = np.sqrt(var + alpha)
    sds = np.where(np.isnan(sds), np.sqrt(alpha), sds)
    return (mat - means[:, None]) / sds[:, None]


def build_filters(train_images: Dataset, conf: RandomCifarConfig):
    """Sample patches, normalize, fit ZCA, emit the whitened filter bank
    (reference: RandomPatchCifar.scala:45-57). The windows and their
    sample stay on the images' device; the sample's row normalization and
    the filters' arithmetic run in float64 on the host, the ZCA on the
    device, as in the JAX package. Returns ((num_filters, k·k·C) float32
    filters, the ZCAWhitener), both on the images' device."""
    dev = train_images.device
    patches = Windower(conf.patch_steps, conf.patch_size).apply(train_images)
    vecs = ImageVectorizer().apply_batch(patches)
    del patches
    sample = Sampler(WHITENER_SAMPLE, seed=conf.seed).apply(vecs)
    del vecs
    base = _normalize_rows(sample.array().cpu().numpy().astype(np.float64), 10.0)
    whitener = ZCAWhitenerEstimator(eps=conf.whitening_epsilon).fit_single(
        torch.as_tensor(base, dtype=torch.float32, device=dev)
    )
    rng = np.random.default_rng(conf.seed)
    idx = rng.choice(base.shape[0], size=min(conf.num_filters, base.shape[0]),
                     replace=False)
    unnorm = whitener.apply(
        torch.as_tensor(base[idx], dtype=torch.float32, device=dev)).cpu().numpy()
    norms = np.sqrt((unnorm**2).sum(axis=1))
    filters = (unnorm / (norms[:, None] + 1e-10)) @ whitener.whitener.cpu().numpy().T
    return torch.as_tensor(filters, dtype=torch.float32, device=dev), whitener


def featurizer(filters, whitener, alpha: float, pool_stride: int, pool_size: int,
               size: int = IMAGE_SIZE) -> Pipeline:
    """Convolver -> SymmetricRectifier -> sum Pooler -> ImageVectorizer on
    (size, size, 3) images: the conv features of every CIFAR app
    (``whitener=None`` for RandomCifar's unwhitened filters)."""
    return (
        Convolver(filters, size, size, NUM_CHANNELS, whitener=whitener,
                  normalize_patches=True)
        .and_then(SymmetricRectifier(alpha=alpha))
        .and_then(Pooler(pool_stride, pool_size))
        .and_then(ImageVectorizer())
    )


def build_pipeline(train: LabeledImages, conf: RandomCifarConfig,
                   device: Optional[Union[str, torch.device]] = None) -> Pipeline:
    """The unfitted predictor: filters built from ``train``'s images, and
    its estimators fit on them, on ``device`` (``None`` means ``cuda``)."""
    dev = resolve_device(device)
    images = on_device(train.images, dev)
    filters, whitener = build_filters(images, conf)
    labels = ClassLabelIndicators(NUM_CLASSES)(on_device(train.labels, dev))
    return (
        featurizer(filters, whitener, conf.alpha, conf.pool_stride, conf.pool_size)
        .and_then(StandardScaler(), images)
        .and_then(BlockLeastSquaresEstimator(4096, num_iter=1, lam=conf.lam),
                  images, labels)
        .and_then(MaxClassifier())
    )


def run(train: LabeledImages, test: LabeledImages, conf: RandomCifarConfig,
        device: Optional[Union[str, torch.device]] = None):
    """Fit on ``train`` and classify ``test`` on ``device`` (``None`` means
    ``cuda``); returns the unfitted predictor and the test metrics, as the
    JAX package does (``pipeline.fit()`` then reuses the fits)."""
    dev = resolve_device(device)
    pipeline = build_pipeline(train, conf, device=dev)
    evaluator = MulticlassClassifierEvaluator(NUM_CLASSES)
    metrics = evaluator.evaluate(pipeline(on_device(test.images, dev)), test.labels)
    return pipeline, metrics


def synthetic_cifar(n_train=256, n_test=64, seed=0):
    """Class-dependent color blobs standing in for CIFAR (host tensors,
    the JAX package's draws)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(30, 220, size=(NUM_CLASSES, NUM_CHANNELS))

    def make(n):
        y = rng.integers(0, NUM_CLASSES, n)
        imgs = (
            means[y][:, None, None, :]
            + rng.normal(0, 20, (n, IMAGE_SIZE, IMAGE_SIZE, NUM_CHANNELS))
        ).clip(0, 255)
        return LabeledImages(
            labels=Dataset.from_array(torch.from_numpy(y.astype(np.int32))),
            images=Dataset.from_array(torch.from_numpy(imgs.astype(np.float32))),
        )

    return make(n_train), make(n_test)


def main(argv: Optional[List[str]] = None,
         device: Optional[Union[str, torch.device]] = None) -> int:
    """The JAX package's flags and defaults, on ``device`` (``None`` means
    ``cuda``): CIFAR binary files at ``--trainLocation`` and
    ``--testLocation``, or seeded synthetic images without them. Prints
    the metrics and the time."""
    p = argparse.ArgumentParser(description="RandomPatchCifar")
    p.add_argument("--trainLocation", default="")
    p.add_argument("--testLocation", default="")
    p.add_argument("--numFilters", type=int, default=100)
    p.add_argument("--whiteningEpsilon", type=float, default=0.1)
    p.add_argument("--patchSize", type=int, default=6)
    p.add_argument("--patchSteps", type=int, default=1)
    p.add_argument("--poolSize", type=int, default=14)
    p.add_argument("--poolStride", type=int, default=13)
    p.add_argument("--alpha", type=float, default=0.25)
    p.add_argument("--lambda", dest="lam", type=float, default=0.0)
    a = p.parse_args(argv)
    dev = resolve_device(device)  # before the data is read
    conf = RandomCifarConfig(
        a.trainLocation, a.testLocation, a.numFilters, a.whiteningEpsilon,
        a.patchSize, a.patchSteps, a.poolSize, a.poolStride, a.alpha, a.lam,
    )
    if conf.train_location:
        train = CifarLoader(conf.train_location)
        test = CifarLoader(conf.test_location)
    else:
        train, test = synthetic_cifar()
    t0 = time.time()
    _, metrics = run(train, test, conf, device=dev)
    print(metrics.summary())
    print(f"Total time: {time.time() - t0:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
