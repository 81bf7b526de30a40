"""The remaining CIFAR applications: LinearPixels, RandomCifar,
RandomPatchCifarKernel, and the augmented RandomPatchCifar variants
(counterpart of ``keystone_tpu/pipelines/images/cifar_apps.py``).

Reference: pipelines/images/cifar/{LinearPixels.scala:20,
RandomCifar.scala:21, RandomPatchCifarKernel.scala:20,
RandomPatchCifarAugmented.scala:33}. Every app fits and scores on
``device`` (``None`` means ``cuda``); filters, crops and flips are drawn
with numpy generators seeded as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from keystone_tpu_torch._device import resolve_device
from keystone_tpu_torch.evaluation import (
    AugmentedExamplesEvaluator,
    MulticlassClassifierEvaluator,
)
from keystone_tpu_torch.loaders.cifar import LabeledImages
from keystone_tpu_torch.ops.images.core import (
    CenterCornerPatcher,
    GrayScaler,
    ImageVectorizer,
    RandomImageTransformer,
    RandomPatcher,
)
from keystone_tpu_torch.ops.learning.block_ls import BlockLeastSquaresEstimator
from keystone_tpu_torch.ops.learning.kernel import (
    GaussianKernelGenerator,
    KernelRidgeRegression,
)
from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator
from keystone_tpu_torch.ops.stats.nodes import StandardScaler
from keystone_tpu_torch.ops.util.cacher import Cacher
from keystone_tpu_torch.ops.util.nodes import ClassLabelIndicators, MaxClassifier
from keystone_tpu_torch.parallel.dataset import Dataset, on_device
from keystone_tpu_torch.pipelines.images.random_patch_cifar import (
    RandomCifarConfig,
    build_filters,
    featurizer,
)

NUM_CLASSES = 10
IMAGE_SIZE = 32
NUM_CHANNELS = 3

Device = Optional[Union[str, torch.device]]


def _on(train: LabeledImages, test: LabeledImages, device: Device):
    """(device, train images, train ±1 indicators, test images) there."""
    dev = resolve_device(device)
    labels = ClassLabelIndicators(NUM_CLASSES)(on_device(train.labels, dev))
    return dev, on_device(train.images, dev), labels, on_device(test.images, dev)


def _evaluate(pipeline, test_images: Dataset, test: LabeledImages):
    return MulticlassClassifierEvaluator(NUM_CLASSES).evaluate(
        pipeline(test_images), test.labels
    )


def linear_pixels(train: LabeledImages, test: LabeledImages, device: Device = None):
    """GrayScaler -> vectorize -> exact least squares -> argmax
    (reference: LinearPixels.scala:20)."""
    _, images, labels, test_images = _on(train, test, device)
    pipeline = (
        GrayScaler()
        .and_then(ImageVectorizer())
        .and_then(LinearMapEstimator(), images, labels)
        .and_then(MaxClassifier())
    )
    return pipeline, _evaluate(pipeline, test_images, test)


def random_cifar(
    train: LabeledImages,
    test: LabeledImages,
    num_filters: int = 100,
    patch_size: int = 6,
    pool_size: int = 14,
    pool_stride: int = 13,
    alpha: float = 0.25,
    lam: float = 10.0,
    seed: int = 0,
    device: Device = None,
):
    """Random GAUSSIAN filters (no whitening) conv features
    (reference: RandomCifar.scala:21)."""
    dev, images, labels, test_images = _on(train, test, device)
    rng = np.random.default_rng(seed)
    filters = torch.as_tensor(
        rng.standard_normal(
            (num_filters, patch_size * patch_size * NUM_CHANNELS)
        ).astype(np.float32),
        device=dev,
    )
    pipeline = (
        featurizer(filters, None, alpha, pool_stride, pool_size)
        .and_then(Cacher())
        .and_then(StandardScaler(), images)
        .and_then(Cacher())
        .and_then(LinearMapEstimator(lam=lam), images, labels)
        .and_then(MaxClassifier())
    )
    return pipeline, _evaluate(pipeline, test_images, test)


@dataclasses.dataclass
class RandomCifarKernelConfig(RandomCifarConfig):
    gamma: float = 2e-5
    block_size: int = 512
    num_epochs: int = 1


def _krr(conf) -> KernelRidgeRegression:
    return KernelRidgeRegression(
        GaussianKernelGenerator(conf.gamma), conf.lam, conf.block_size,
        conf.num_epochs, block_permuter=conf.seed,
    )


def _conv_features(filters, whitener, size: int, conf: RandomCifarConfig):
    return featurizer(filters, whitener, conf.alpha, conf.pool_stride, conf.pool_size,
                      size).and_then(Cacher())


def random_patch_cifar_kernel(train: LabeledImages, test: LabeledImages,
                              conf: RandomCifarKernelConfig, device: Device = None):
    """Same featurization as RandomPatchCifar, solved by kernel ridge
    regression (reference: RandomPatchCifarKernel.scala:20,55-90)."""
    _, images, labels, test_images = _on(train, test, device)
    filters, whitener = build_filters(images, conf)
    pipeline = (
        _conv_features(filters, whitener, IMAGE_SIZE, conf)
        .and_then(StandardScaler(), images)
        .and_then(_krr(conf), images, labels)
        .and_then(MaxClassifier())
    )
    return pipeline, _evaluate(pipeline, test_images, test)


@dataclasses.dataclass
class RandomCifarAugmentedConfig(RandomCifarConfig):
    augment_patch_size: int = 24
    augment_copies: int = 10


def _augmented(train: LabeledImages, conf, dev, flip_chance: Optional[float] = None):
    """Train crops (and, with ``flip_chance``, random flips of them) and
    their ±1 indicators: each source label repeated per crop."""
    aug_size = conf.augment_patch_size
    patcher = RandomPatcher(conf.augment_copies, aug_size, aug_size, seed=conf.seed)
    aug_images = patcher.apply_batch(on_device(train.images, dev))
    if flip_chance is not None:
        flipper = RandomImageTransformer(flip_chance=flip_chance, seed=conf.seed + 1)
        aug_images = flipper.apply_batch(aug_images)
    aug_labels_int = on_device(train.labels, dev).array().repeat_interleave(
        conf.augment_copies)
    aug_labels = ClassLabelIndicators(NUM_CLASSES)(Dataset.from_array(aug_labels_int))
    return aug_images, aug_labels


def _score_augmented(pipeline, test: LabeledImages, conf, dev):
    """Center and corner crops of each test image with their flips, scored
    and merged per image by the augmented evaluator."""
    aug_size = conf.augment_patch_size
    test_patcher = CenterCornerPatcher(aug_size, aug_size, horizontal_flips=True)
    test_aug = test_patcher.apply_batch(on_device(test.images, dev))
    per_image = test_patcher.patches_per_image  # 10: 5 crops x flips
    names = np.repeat(np.arange(test.images.n), per_image)
    test_labels_aug = np.repeat(test.labels.array().cpu().numpy(), per_image)
    scores = pipeline(test_aug).get()
    return AugmentedExamplesEvaluator(list(names), NUM_CLASSES).evaluate(
        scores, test_labels_aug
    )


def random_patch_cifar_augmented(train: LabeledImages, test: LabeledImages,
                                 conf: RandomCifarAugmentedConfig, device: Device = None):
    """RandomPatchCifar with random-crop train augmentation and
    center/corner test augmentation merged by the augmented evaluator
    (reference: RandomPatchCifarAugmented.scala:33)."""
    dev = resolve_device(device)
    aug_images, aug_labels = _augmented(train, conf, dev)
    filters, whitener = build_filters(aug_images, conf)
    pipeline = (
        _conv_features(filters, whitener, conf.augment_patch_size, conf)
        .and_then(StandardScaler(), aug_images)
        .and_then(BlockLeastSquaresEstimator(4096, num_iter=1, lam=conf.lam),
                  aug_images, aug_labels)
    )
    return pipeline, _score_augmented(pipeline, test, conf, dev)


@dataclasses.dataclass
class RandomCifarAugmentedKernelConfig(RandomCifarAugmentedConfig):
    gamma: float = 2e-4
    block_size: int = 512
    num_epochs: int = 1
    flip_chance: float = 0.5


def random_patch_cifar_augmented_kernel(train: LabeledImages, test: LabeledImages,
                                        conf: RandomCifarAugmentedKernelConfig,
                                        device: Device = None):
    """Augmented CIFAR featurization solved by Gauss-Seidel kernel ridge
    regression; train crops get an extra random horizontal flip, test
    copies are merged by the augmented evaluator (reference:
    RandomPatchCifarAugmentedKernel.scala:33-120)."""
    dev = resolve_device(device)
    aug_images, aug_labels = _augmented(train, conf, dev, flip_chance=conf.flip_chance)
    filters, whitener = build_filters(aug_images, conf)
    pipeline = (
        _conv_features(filters, whitener, conf.augment_patch_size, conf)
        .and_then(StandardScaler(), aug_images)
        .and_then(_krr(conf), aug_images, aug_labels)
    )
    return pipeline, _score_augmented(pipeline, test, conf, dev)
