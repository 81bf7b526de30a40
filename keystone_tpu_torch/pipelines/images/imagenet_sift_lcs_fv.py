"""ImageNetSiftLcsFV — the flagship pipeline, trained: SIFT and LCS
branches, each PCA -> GMM Fisher vector -> normalization, gathered and fed
to the mixture-weighted block least-squares solver, top-5 out
(counterpart of ``keystone_tpu/pipelines/images/imagenet_sift_lcs_fv.py``).

Every node fits and runs on ``device`` (``None`` means ``cuda``): ``run``,
``build_pipeline`` and ``compute_pca_and_fisher_branch`` put the training
data there. Images of several sizes, as ``ImageNetLoader`` decodes them,
stay an items-mode dataset: each node runs one batch per size, and after
the Fisher vectors every image has the same feature length.

    python -m keystone_tpu_torch.pipelines.images.imagenet_sift_lcs_fv \
        --trainLocation TRAIN_TARS --testLocation TEST_TARS --labelPath WNID_MAP
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Union

import numpy as np
import torch

from keystone_tpu_torch._device import resolve_device
from keystone_tpu_torch.loaders.image_loaders import (
    NUM_IMAGENET_CLASSES,
    ImageExtractor,
    ImageNetLoader,
    LabelExtractor,
)
from keystone_tpu_torch.ops.images.core import GrayScaler, PixelScaler
from keystone_tpu_torch.ops.images.fisher_vector import (
    FisherVector,
    GMMFisherVectorEstimator,
)
from keystone_tpu_torch.ops.images.lcs import LCSExtractor
from keystone_tpu_torch.ops.images.sift import SIFTExtractor
from keystone_tpu_torch.ops.learning.gmm import GaussianMixtureModel
from keystone_tpu_torch.ops.learning.pca import (
    BatchPCATransformer,
    ColumnPCAEstimator,
)
from keystone_tpu_torch.ops.learning.weighted_ls import (
    BlockWeightedLeastSquaresEstimator,
)
from keystone_tpu_torch.ops.stats.nodes import (
    ColumnSampler,
    NormalizeRows,
    SignedHellingerMapper,
)
from keystone_tpu_torch.ops.util.cacher import Cacher
from keystone_tpu_torch.ops.util.nodes import (
    ClassLabelIndicators,
    FloatToDouble,
    MatrixVectorizer,
    TopKClassifier,
    VectorCombiner,
)
from keystone_tpu_torch.parallel.dataset import Dataset, on_device
from keystone_tpu_torch.workflow.api import Pipeline
from keystone_tpu_torch.workflow.executor import GraphExecutor


@dataclasses.dataclass
class ImageNetSiftLcsFVConfig:
    train_location: str = ""
    test_location: str = ""
    label_path: str = ""
    lam: float = 6e-5
    mixture_weight: float = 0.25
    desc_dim: int = 64
    vocab_size: int = 16
    sift_scale_step: int = 1
    lcs_stride: int = 4
    lcs_border: int = 16
    lcs_patch: int = 6
    num_pca_samples_per_image: int = 10
    num_gmm_samples_per_image: int = 10
    num_classes: int = NUM_IMAGENET_CLASSES
    seed: int = 0
    # optional warm-start files: a (desc_dim, in_dim) PCA csv and the GMM's
    # (means, variances, weights) csvs
    sift_pca_file: Optional[str] = None
    sift_gmm_files: Optional[tuple] = None
    lcs_pca_file: Optional[str] = None
    lcs_gmm_files: Optional[tuple] = None


def compute_pca_and_fisher_branch(
    prefix: Pipeline,
    training_data: Dataset,
    conf: ImageNetSiftLcsFVConfig,
    pca_file: Optional[str],
    gmm_files: Optional[tuple],
    device: Optional[Union[str, torch.device]] = None,
) -> Pipeline:
    """One branch: ``prefix`` → PCA (fitted on ``num_pca_samples_per_image``
    sampled descriptors per image, or loaded) → Fisher vector (GMM fitted on
    the projected samples, or loaded) → normalization. The training data
    and loaded parameters go to ``device`` (``None`` means ``cuda``)."""
    dev = resolve_device(device)
    training_data = on_device(training_data, dev)
    if pca_file is not None:
        pca_mat = np.loadtxt(pca_file, delimiter=",").astype(np.float32)
        pca_pipeline = BatchPCATransformer(
            torch.as_tensor(pca_mat.T.copy(), device=dev)
        ).to_pipeline()
    else:
        sampled = ColumnSampler(
            conf.num_pca_samples_per_image, seed=conf.seed
        )(prefix(training_data))
        pca_pipeline = ColumnPCAEstimator(conf.desc_dim).with_data(sampled)

    if gmm_files is not None:
        gmm = GaussianMixtureModel.load(*gmm_files, device=dev)
        fv_pipeline = FisherVector(gmm).to_pipeline()
    else:
        sampled = ColumnSampler(
            conf.num_gmm_samples_per_image, seed=conf.seed + 1
        )(prefix(training_data))
        fv_pipeline = GMMFisherVectorEstimator(
            conf.vocab_size, seed=conf.seed
        ).with_data(pca_pipeline.apply(sampled))

    return (
        prefix.and_then(pca_pipeline)
        .and_then(fv_pipeline)
        .and_then(FloatToDouble())
        .and_then(MatrixVectorizer())
        .and_then(NormalizeRows())
        .and_then(SignedHellingerMapper())
        .and_then(NormalizeRows())
    )


def build_featurizer(train_images: Dataset, conf: ImageNetSiftLcsFVConfig,
                     device: Optional[Union[str, torch.device]] = None) -> Pipeline:
    """The unfitted featurizer, raw images to feature rows: the SIFT and
    LCS branches (their PCAs and GMMs fit on ``train_images``, moved to
    ``device``, ``None`` meaning ``cuda``), gathered and concatenated."""
    dev = resolve_device(device)
    train_images = on_device(train_images, dev)
    sift_prefix = (
        PixelScaler()
        .and_then(GrayScaler())
        .and_then(SIFTExtractor(scale_step=conf.sift_scale_step))
        .and_then(SignedHellingerMapper())
    )
    sift_branch = compute_pca_and_fisher_branch(
        sift_prefix, train_images, conf, conf.sift_pca_file, conf.sift_gmm_files,
        device=dev,
    )
    lcs_prefix = LCSExtractor(
        conf.lcs_stride, conf.lcs_border, conf.lcs_patch
    ).to_pipeline()
    lcs_branch = compute_pca_and_fisher_branch(
        lcs_prefix, train_images, conf, conf.lcs_pca_file, conf.lcs_gmm_files,
        device=dev,
    )
    return Pipeline.gather([sift_branch, lcs_branch]).and_then(VectorCombiner())


def build_pipeline(
    train_images: Dataset, train_labels: Dataset, conf: ImageNetSiftLcsFVConfig,
    device: Optional[Union[str, torch.device]] = None,
) -> Pipeline:
    """The unfitted predictor: its estimators fit on ``train_images`` and
    ``train_labels`` (int class ids), moved to ``device`` (``None`` means
    ``cuda``), when it is applied or ``fit()``."""
    dev = resolve_device(device)
    train_images = on_device(train_images, dev)
    train_labels = on_device(train_labels, dev)
    indicator_labels = ClassLabelIndicators(conf.num_classes)(train_labels)
    num_features = 2 * 2 * conf.desc_dim * conf.vocab_size
    return (
        build_featurizer(train_images, conf, device=dev)
        .and_then(Cacher())
        .and_then(
            BlockWeightedLeastSquaresEstimator(
                4096, 1, conf.lam, conf.mixture_weight,
                num_features=num_features,
            ),
            train_images,
            indicator_labels,
        )
        .and_then(TopKClassifier(5))
    )


def run(train_data: Dataset, test_data: Dataset, conf: ImageNetSiftLcsFVConfig,
        device: Optional[Union[str, torch.device]] = None):
    """Fit on ``train_data`` and classify ``test_data`` (datasets of
    ``LabeledImage``, of one image size or several) on ``device`` (``None``
    means ``cuda``). Returns the unfitted predictor and the top-5 error, as
    the JAX package does.
    Applying the predictor again loads the solver's fit from the pipeline
    environment, but fits the column PCAs and GMMs anew on fresh samples
    (the node optimizer swaps those estimators and keeps no state for the
    swapped nodes, and the samplers' counters have moved on), as in the
    JAX package; ``fit_and_score`` also returns the fitted pipeline that
    was scored."""
    predictor, _, err = fit_and_score(train_data, test_data, conf, device)
    return predictor, err


def fit_and_score(train_data: Dataset, test_data: Dataset, conf: ImageNetSiftLcsFVConfig,
                  device: Optional[Union[str, torch.device]] = None):
    """``run``'s work: (the unfitted predictor, the fitted pipeline that
    classified ``test_data``, its top-5 error)."""
    dev = resolve_device(device)
    train_images = on_device(ImageExtractor.apply(train_data), dev)
    train_labels = on_device(LabelExtractor.apply(train_data), dev)
    test_images = on_device(ImageExtractor.apply(test_data), dev)
    actual = LabelExtractor.apply(test_data).array().numpy()

    predictor = build_pipeline(train_images, train_labels, conf, device=dev)
    # fit through a throwaway executor, so the training set's
    # intermediates that it memoizes are freed before the test set runs
    fitted = Pipeline(
        GraphExecutor(predictor._graph), predictor.source, predictor.sink
    ).fit()
    top5 = fitted(test_images).array().cpu().numpy()
    err = 1.0 - np.mean([a in p for a, p in zip(actual, top5)])
    return predictor, fitted, float(err)


def main(argv: Optional[List[str]] = None, device: Optional[Union[str, torch.device]] = None) -> int:
    """Train on the tars at ``--trainLocation`` and score top-5 on those at
    ``--testLocation`` (a tar file or a directory of them; WNIDs mapped to
    classes by ``--labelPath``), on ``device`` (``None`` means ``cuda``).
    The JAX package's flags and defaults; prints the error and the time."""
    p = argparse.ArgumentParser(description="ImageNetSiftLcsFV")
    p.add_argument("--trainLocation", required=True)
    p.add_argument("--testLocation", required=True)
    p.add_argument("--labelPath", required=True)
    p.add_argument("--lambda", dest="lam", type=float, default=6e-5)
    p.add_argument("--mixtureWeight", type=float, default=0.25)
    p.add_argument("--descDim", type=int, default=64)
    p.add_argument("--vocabSize", type=int, default=16)
    p.add_argument("--siftScaleStep", type=int, default=1)
    a = p.parse_args(argv)
    conf = ImageNetSiftLcsFVConfig(
        train_location=a.trainLocation, test_location=a.testLocation,
        label_path=a.labelPath, lam=a.lam, mixture_weight=a.mixtureWeight,
        desc_dim=a.descDim, vocab_size=a.vocabSize, sift_scale_step=a.siftScaleStep,
    )
    train = ImageNetLoader(conf.train_location, conf.label_path)
    test = ImageNetLoader(conf.test_location, conf.label_path)
    t0 = time.time()
    _, err = run(train, test, conf, device=device)
    print(f"TEST Top-5 error is {100 * err:.2f}%")
    print(f"Total time: {time.time() - t0:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
