"""The port's evaluators against the JAX package's on the same seeded
inputs: multiclass (confusion matrix and every derived metric), binary,
VOC mean average precision (with tied scores) and augmented examples
(average and Borda), each fed tensors, arrays and Datasets."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu import evaluation as jev
from keystone_tpu.evaluation.augmented import AggregationPolicy as JPolicy
from keystone_tpu.parallel.dataset import Dataset as JDataset
from keystone_tpu_torch import evaluation as tev
from keystone_tpu_torch.evaluation.augmented import AggregationPolicy
from keystone_tpu_torch.parallel.dataset import Dataset

METRICS = ("total_accuracy", "total_error", "micro_precision", "micro_recall",
           "micro_f1", "macro_precision", "macro_recall", "macro_f1")


@pytest.mark.parametrize("wrap", ["tensor", "numpy", "dataset"])
def test_multiclass_matches_jax(wrap):
    rng = np.random.default_rng(0)
    c = 5
    pred = rng.integers(0, c, 200)
    lab = np.where(rng.random(200) < 0.6, pred, rng.integers(0, c, 200))
    # a class id past the end and a negative one, as JAX's scatter treats them
    pred[:2], lab[2] = (c + 1, -1), -2
    want = jev.MulticlassClassifierEvaluator(c).evaluate(pred, lab)
    arg = {"tensor": torch.as_tensor, "numpy": np.asarray,
           "dataset": lambda a: Dataset.from_array(torch.as_tensor(a))}[wrap]
    got = tev.MulticlassClassifierEvaluator(c)(arg(pred), arg(lab))
    np.testing.assert_array_equal(got.confusion_matrix, want.confusion_matrix)
    for m in METRICS:
        assert getattr(got, m) == getattr(want, m), m
    for k in range(c):
        assert dataclasses.astuple(got.class_metrics(k)) == dataclasses.astuple(want.class_metrics(k))
    assert got.summary(list("abcde")) == want.summary(list("abcde"))
    with pytest.raises(ValueError, match="length mismatch"):
        tev.MulticlassClassifierEvaluator(c).evaluate(pred[:3], lab[:4])


def test_binary_matches_jax():
    rng = np.random.default_rng(1)
    pred, lab = rng.random(300) < 0.4, rng.random(300) < 0.5
    want = jev.BinaryClassifierEvaluator().evaluate(pred, lab)
    for arg in (torch.as_tensor(pred), pred.astype(np.float32), Dataset.from_array(torch.as_tensor(pred))):
        got = tev.BinaryClassifierEvaluator()(arg, torch.as_tensor(lab))
        assert (got.tp, got.fp, got.tn, got.fn) == (want.tp, want.fp, want.tn, want.fn)
        for m in ("precision", "recall", "f1", "accuracy", "specificity"):
            assert getattr(got, m) == getattr(want, m), m
        assert got.summary() == want.summary()
    with pytest.raises(ValueError):
        tev.BinaryClassifierEvaluator().evaluate(pred[:3], lab)


@pytest.mark.parametrize("ties", [False, True])
def test_mean_average_precision_matches_jax(ties):
    rng = np.random.default_rng(2 + ties)
    n, c = 60, 6
    scores = rng.standard_normal((n, c)).astype(np.float32)
    if ties:
        # scores on a coarse grid tie within and across classes; the
        # stable descending order decides which tied example comes first
        scores = np.round(scores * 2) / 2
        scores[10:20] = 0.0
    actuals = [rng.choice(c, size=rng.integers(1, 4), replace=False) for _ in range(n)]
    actuals[5] = np.array([], np.int64)
    want = jev.MeanAveragePrecisionEvaluator(c).evaluate(
        JDataset.from_items(actuals), JDataset.from_array(jnp.asarray(scores)))
    for s in (torch.as_tensor(scores), Dataset.from_array(torch.as_tensor(scores)), scores):
        got = tev.MeanAveragePrecisionEvaluator(c)(Dataset.from_items(actuals), s)
        np.testing.assert_array_equal(got, want)
    # a class nobody has scores 0, as there
    got = tev.MeanAveragePrecisionEvaluator(c + 1).evaluate(
        actuals, np.concatenate([scores, scores[:, :1]], 1))
    assert got[c] == 0.0


@pytest.mark.parametrize("policy", ["average", "borda"])
def test_augmented_examples_match_jax(policy):
    rng = np.random.default_rng(4)
    names = [f"img{i // 3}" for i in range(30)]
    labels = np.repeat(rng.integers(0, 4, 10), 3)
    scores = rng.standard_normal((30, 4)).astype(np.float32)
    want = jev.AugmentedExamplesEvaluator(names, 4, JPolicy(policy)).evaluate(scores, labels)
    got = tev.AugmentedExamplesEvaluator(names, 4, AggregationPolicy(policy))(
        torch.as_tensor(scores), Dataset.from_array(torch.as_tensor(labels)))
    np.testing.assert_array_equal(got.confusion_matrix, want.confusion_matrix)
    assert got.total_accuracy == want.total_accuracy


def test_exports_match_jax():
    assert tev.__all__ == jev.__all__
