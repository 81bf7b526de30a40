"""VOCSIFTFisher — SIFT -> PCA -> Fisher vectors -> block least squares,
scored by VOC mean average precision (counterpart of
``keystone_tpu/pipelines/images/voc_sift_fisher.py``; reference:
pipelines/images/voc/VOCSIFTFisher.scala:23-110).

Every node fits and runs on ``device`` (``None`` means ``cuda``): ``run``
and ``build_pipeline`` put the training data there. Images of several
sizes, as ``VOCLoader`` decodes them, stay an items-mode dataset and each
node runs one batch per size; after the Fisher vectors every image has
2 · desc_dim · vocab_size features, and the solver stacks them.

    python -m keystone_tpu_torch.pipelines.images.voc_sift_fisher \
        --trainLocation TRAIN_TARS --testLocation TEST_TARS --labelPath VOC_CSV
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Union

import numpy as np
import torch

from keystone_tpu_torch._device import resolve_device
from keystone_tpu_torch.evaluation import MeanAveragePrecisionEvaluator
from keystone_tpu_torch.loaders.image_loaders import (
    ImageExtractor,
    MultiLabelExtractor,
    VOCLoader,
)
from keystone_tpu_torch.ops.images.core import GrayScaler, PixelScaler
from keystone_tpu_torch.ops.images.fisher_vector import (
    FisherVector,
    GMMFisherVectorEstimator,
    fisher_vector_of,
)
from keystone_tpu_torch.ops.images.sift import SIFTExtractor
from keystone_tpu_torch.ops.learning.block_ls import (
    BlockLeastSquaresEstimator,
    BlockLinearMapper,
)
from keystone_tpu_torch.ops.learning.gmm import GaussianMixtureModel
from keystone_tpu_torch.ops.learning.pca import (
    BatchPCATransformer,
    ColumnPCAEstimator,
)
from keystone_tpu_torch.ops.stats.nodes import (
    ColumnSampler,
    NormalizeRows,
    SignedHellingerMapper,
)
from keystone_tpu_torch.ops.util.cacher import Cacher
from keystone_tpu_torch.ops.util.nodes import (
    ClassLabelIndicatorsFromIntArrayLabels,
    FloatToDouble,
    MatrixVectorizer,
)
from keystone_tpu_torch.parallel.dataset import Dataset, on_device
from keystone_tpu_torch.workflow.api import FittedPipeline, Pipeline
from keystone_tpu_torch.workflow.executor import GraphExecutor

NUM_VOC_CLASSES = 20
BLOCK_SIZE = 4096


@dataclasses.dataclass
class SIFTFisherConfig:
    train_location: str = ""
    test_location: str = ""
    label_path: str = ""
    lam: float = 0.5
    desc_dim: int = 80
    vocab_size: int = 256
    scale_step: int = 0
    num_pca_samples_per_image: int = 10
    num_gmm_samples_per_image: int = 10
    num_classes: int = NUM_VOC_CLASSES
    seed: int = 0
    # optional warm start: a (desc_dim, 128) PCA csv and the GMM's (means,
    # variances, weights) csvs
    pca_file: Optional[str] = None
    gmm_files: Optional[tuple] = None


def _sift(scale_step: int) -> Pipeline:
    """Raw images -> dense SIFT descriptors."""
    return (
        PixelScaler()
        .and_then(GrayScaler())
        .and_then(Cacher())
        .and_then(SIFTExtractor(scale_step=scale_step))
    )


def _encode(pca_featurizer: Pipeline, fisher) -> Pipeline:
    """PCA'd descriptors -> the Fisher vector ``fisher`` (a node, or an
    estimator with its data) -> the normalized feature row."""
    return (
        pca_featurizer.and_then(fisher)
        .and_then(FloatToDouble())
        .and_then(MatrixVectorizer())
        .and_then(NormalizeRows())
        .and_then(SignedHellingerMapper())
        .and_then(NormalizeRows())
        .and_then(Cacher())
    )


def featurizer(pca_mat: torch.Tensor, gmm: GaussianMixtureModel,
               scale_step: int = 0) -> Pipeline:
    """``build_pipeline``'s featurize chain with given parameters: the
    (128, desc_dim) ``pca_mat`` and ``gmm``, whose Fisher-vector node is
    the one ``GMMFisherVectorEstimator`` fits around it. ``.fit()`` maps
    raw images to feature rows."""
    pca_featurizer = _sift(scale_step).and_then(BatchPCATransformer(pca_mat)).and_then(Cacher())
    return _encode(pca_featurizer, fisher_vector_of(gmm))


def features_of(fitted: FittedPipeline) -> FittedPipeline:
    """The featurize part of a fitted VOC pipeline: every node before its
    linear model, as one pipeline from raw images to feature rows."""
    g = fitted.graph
    model = g.sink_dependencies[fitted.sink]
    if not isinstance(g.operators.get(model), BlockLinearMapper):
        raise ValueError("the pipeline does not end in a BlockLinearMapper")
    (feats,) = g.dependencies[model]
    return FittedPipeline(
        g.set_sink_dependency(fitted.sink, feats).remove_node(model),
        fitted.source, fitted.sink,
    )


def build_pipeline(
    training_data: Dataset, training_labels: Dataset, conf: SIFTFisherConfig,
    device: Optional[Union[str, torch.device]] = None,
) -> Pipeline:
    """The unfitted predictor: its estimators fit on ``training_data`` and
    ``training_labels`` (±1 indicator rows), moved to ``device`` (``None``
    means ``cuda``), when it is applied or ``fit()``."""
    dev = resolve_device(device)
    training_data = on_device(training_data, dev)
    training_labels = on_device(training_labels, dev)
    sift_extractor = _sift(conf.scale_step)

    if conf.pca_file is not None:
        pca_mat = np.loadtxt(conf.pca_file, delimiter=",").astype(np.float32)
        pca = BatchPCATransformer(torch.as_tensor(pca_mat.T.copy(), device=dev))
    else:
        sampled = ColumnSampler(
            conf.num_pca_samples_per_image, seed=conf.seed
        )(sift_extractor(training_data))
        pca = ColumnPCAEstimator(conf.desc_dim).with_data(sampled)
    pca_featurizer = sift_extractor.and_then(pca).and_then(Cacher())

    if conf.gmm_files is not None:
        fisher = FisherVector(GaussianMixtureModel.load(*conf.gmm_files, device=dev))
    else:
        sampled = ColumnSampler(
            conf.num_gmm_samples_per_image, seed=conf.seed + 1
        )(pca_featurizer(training_data))
        fisher = GMMFisherVectorEstimator(
            conf.vocab_size, seed=conf.seed
        ).with_data(sampled)

    return _encode(pca_featurizer, fisher).and_then(
        BlockLeastSquaresEstimator(
            BLOCK_SIZE, 1, conf.lam,
            num_features=2 * conf.desc_dim * conf.vocab_size,
        ),
        training_data,
        training_labels,
    )


def run(train_data: Dataset, test_data: Dataset, conf: SIFTFisherConfig,
        device: Optional[Union[str, torch.device]] = None):
    """Fit on ``train_data`` and score ``test_data`` (datasets of
    ``LabeledImage`` with ``labels``, of one image size or several) on
    ``device`` (``None`` means ``cuda``). Returns the unfitted predictor and
    the test set's mean average precision, as the JAX package does;
    ``fit_and_score`` also returns the fitted pipeline and its scores."""
    predictor, _, _, mean_ap = fit_and_score(train_data, test_data, conf, device)
    return predictor, mean_ap


def fit_and_score(train_data: Dataset, test_data: Dataset, conf: SIFTFisherConfig,
                  device: Optional[Union[str, torch.device]] = None):
    """``run``'s work: (the unfitted predictor, the fitted pipeline, its
    (n_test, num_classes) scores on the test images, their MAP)."""
    dev = resolve_device(device)
    training_images = on_device(ImageExtractor.apply(train_data), dev)
    label_grabber = ClassLabelIndicatorsFromIntArrayLabels(conf.num_classes)
    training_labels = on_device(
        label_grabber.apply_batch(MultiLabelExtractor.apply(train_data)), dev
    )
    predictor = build_pipeline(training_images, training_labels, conf, device=dev)
    # fit through a throwaway executor, so the training set's
    # intermediates that it memoizes are freed before the test set runs
    fitted = Pipeline(
        GraphExecutor(predictor._graph), predictor.source, predictor.sink
    ).fit()
    scores = score(fitted, test_data, dev)
    test_actuals = MultiLabelExtractor.apply(test_data).items()
    aps = MeanAveragePrecisionEvaluator(conf.num_classes).evaluate(test_actuals, scores)
    return predictor, fitted, scores, float(np.mean(aps))


def score(fitted, test_data: Dataset, device=None) -> torch.Tensor:
    """(n, num_classes) scores of a fitted VOC pipeline on the images of
    ``test_data`` (a dataset of ``LabeledImage``), on ``device`` (``None``
    means ``cuda``)."""
    images = on_device(ImageExtractor.apply(test_data), resolve_device(device))
    return fitted(images).array()


def main(argv: Optional[List[str]] = None,
         device: Optional[Union[str, torch.device]] = None) -> int:
    """Train on the tars at ``--trainLocation`` and score MAP on those at
    ``--testLocation`` (a tar file or a directory of them; classes from the
    VOC labels CSV at ``--labelPath``), on ``device`` (``None`` means
    ``cuda``). The JAX package's flags and defaults; prints the MAP and the
    time."""
    p = argparse.ArgumentParser(description="VOCSIFTFisher")
    p.add_argument("--trainLocation", required=True)
    p.add_argument("--testLocation", required=True)
    p.add_argument("--labelPath", required=True)
    p.add_argument("--lambda", dest="lam", type=float, default=0.5)
    p.add_argument("--descDim", type=int, default=80)
    p.add_argument("--vocabSize", type=int, default=256)
    p.add_argument("--scaleStep", type=int, default=0)
    a = p.parse_args(argv)
    dev = resolve_device(device)  # before the data is read
    conf = SIFTFisherConfig(
        a.trainLocation, a.testLocation, a.labelPath, a.lam, a.descDim,
        a.vocabSize, a.scaleStep,
    )
    train = VOCLoader(conf.train_location, conf.label_path)
    test = VOCLoader(conf.test_location, conf.label_path)
    t0 = time.time()
    _, mean_ap = run(train, test, conf, device=dev)
    print(f"TEST MAP is: {mean_ap:.4f}")
    print(f"Total time: {time.time() - t0:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
