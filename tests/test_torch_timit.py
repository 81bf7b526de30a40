"""TIMIT on the CPU against the JAX package: ``loaders/text_loaders.py``
on written files, ``CosineRandomFeatures`` (the same draws, features within
1e-5) and ``pipelines/speech/timit.py`` on the tiny configuration of
tests/pipelines/test_text_pipelines.py:82-99 (predictions equal, accuracy
above that test's 0.9), and ``main`` on TIMIT-layout files."""

import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.loaders import text_loaders as jtext
from keystone_tpu.loaders.csv_loader import LabeledData as JLabeledData
from keystone_tpu.ops.stats import CosineRandomFeatures as JCosineRandomFeatures
from keystone_tpu.parallel.dataset import Dataset as JDataset
from keystone_tpu.pipelines.speech import timit as jtimit
from keystone_tpu_torch.loaders import text_loaders as ttext
from keystone_tpu_torch.loaders.csv_loader import LabeledData
from keystone_tpu_torch.ops.stats.nodes import CosineRandomFeatures
from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.pipelines.speech import timit as ttimit

FEATURE_TOL = dict(rtol=1e-5, atol=1e-5)


def np_(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _frames(n, d, k, seed):
    """The JAX test's frames: class centres × 3 plus unit noise."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * 3
    y = rng.integers(0, k, n)
    return (centers[y] + rng.standard_normal((n, d))).astype(np.float32), y


def _write_timit(path, X, y, name, order=None):
    """A TIMIT-layout feature CSV and its "row label" file, both 1-based,
    its lines in ``order``."""
    feats = path / f"{name}.csv"
    labels = path / f"{name}.labels"
    np.savetxt(feats, X, delimiter=",", fmt="%.6g")
    rows = range(len(y)) if order is None else order
    labels.write_text("".join(f"{i + 1} {y[i] + 1}\n" for i in rows))
    return str(feats), str(labels)


# -- the loaders -------------------------------------------------------------


def test_timit_loader_matches_jax_and_loadtxt(tmp_path):
    X, y = _frames(30, 12, 5, seed=1)
    Xt, yt = _frames(9, 12, 5, seed=2)
    train = _write_timit(tmp_path, X, y, "train", order=np.random.default_rng(0).permutation(30))
    test = _write_timit(tmp_path, Xt, yt, "test")
    got = ttext.TimitFeaturesDataLoader(*train, *test, device="cpu")
    want = jtext.TimitFeaturesDataLoader(*train, *test)
    for split, path in (("train", train[0]), ("test", test[0])):
        g, w = getattr(got, split), getattr(want, split)
        assert g.data.array().device.type == "cpu" and g.labels.array().device.type == "cpu"
        assert g.data.array().dtype == torch.float32 and g.labels.array().dtype == torch.int32
        assert np.array_equal(np_(g.data.array()), np.asarray(w.data.array()))
        assert np.array_equal(np_(g.data.array()), np.loadtxt(path, delimiter=",", dtype=np.float32, ndmin=2))
        assert np.array_equal(np_(g.labels.array()), np.asarray(w.labels.array()))
    assert np.array_equal(np_(got.train.labels.array()), y)
    assert ttext._parse_sparse_labels(train[1]) == jtext._parse_sparse_labels(train[1])
    assert (ttext.TIMIT_DIMENSION, ttext.TIMIT_NUM_CLASSES) == (jtext.TIMIT_DIMENSION, jtext.TIMIT_NUM_CLASSES) == (440, 147)


def test_timit_loader_needs_cuda_unless_given_the_cpu(tmp_path, monkeypatch):
    X, y = _frames(4, 3, 2, seed=0)
    files = _write_timit(tmp_path, X, y, "a")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttext.TimitFeaturesDataLoader(*files, *files)


def test_text_loaders_match_jax(tmp_path):
    news = tmp_path / "news"
    for c, docs in ((0, ["gpu kernels", "a compiler"]), (7, ["the inning"]), (19, ["faith"])):
        d = news / ttext.NEWSGROUPS_CLASSES[c]
        d.mkdir(parents=True)
        for i, text in enumerate(docs):
            (d / f"{i}.txt").write_text(text)
    (news / "not.a.class").mkdir()
    got, want = ttext.NewsgroupsDataLoader(str(news)), jtext.NewsgroupsDataLoader(str(news))
    assert ttext.NEWSGROUPS_CLASSES == jtext.NEWSGROUPS_CLASSES
    assert got.data.items() == want.data.items() == ["gpu kernels", "a compiler", "the inning", "faith"]
    assert np.array_equal(np_(got.labels.array()), np.asarray(want.labels.array()))

    reviews = tmp_path / "reviews.json"
    rows = [{"overall": 5.0, "reviewText": "great"}, {"overall": 3.0, "reviewText": "meh"},
            {"overall": 3.5, "reviewText": "ok"}]
    reviews.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    for threshold in (3.5, 3.0):
        got = ttext.AmazonReviewsDataLoader(str(reviews), threshold)
        want = jtext.AmazonReviewsDataLoader(str(reviews), threshold)
        assert got.data.items() == want.data.items()
        assert np.array_equal(np_(got.labels.array()), np.asarray(want.labels.array()))


# -- CosineRandomFeatures ----------------------------------------------------


@pytest.mark.parametrize("distribution", ["gaussian", "cauchy"])
def test_cosine_random_features_match_jax(distribution):
    X, _ = _frames(24, 20, 3, seed=4)
    Xp = np.concatenate([X, np.zeros((8, 20), np.float32)])
    got = CosineRandomFeatures.create(20, 64, 0.1, seed=9, distribution=distribution)
    want = JCosineRandomFeatures.create(20, 64, 0.1, seed=9, distribution=distribution)
    assert np.array_equal(np_(got.W), np.asarray(want.W))
    assert np.array_equal(np_(got.b), np.asarray(want.b))
    out = got.apply_batch(Dataset.from_array(torch.as_tensor(Xp), n=24)).padded()
    ref = want.apply_batch(JDataset.from_array(jnp.asarray(Xp), n=24)).padded()
    np.testing.assert_allclose(np_(out), np.asarray(ref), **FEATURE_TOL)
    assert not np_(out)[24:].any()  # pad rows stay zero
    np.testing.assert_allclose(np_(got.apply(torch.as_tensor(X[0]))), np.asarray(want.apply(jnp.asarray(X[0]))),
                               **FEATURE_TOL)


# -- the pipeline ------------------------------------------------------------

TINY = dict(num_cosines=2, gamma=0.1, num_epochs=2, lam=1e-3, num_cosine_features=64)


def test_timit_run_matches_jax_on_the_tiny_config():
    X, y = _frames(200, 20, 5, seed=3)
    conf = dict(TINY, dim=20, num_classes=5)
    predictor, metrics = ttimit.run(LabeledData.of(torch.as_tensor(y.astype(np.int32)), torch.as_tensor(X)),
                                    LabeledData.of(torch.as_tensor(y.astype(np.int32)), torch.as_tensor(X)),
                                    ttimit.TimitConfig(**conf), device="cpu")
    jtrain = JLabeledData(labels=JDataset.from_array(jnp.asarray(y, jnp.int32)),
                          data=JDataset.from_array(jnp.asarray(X)))
    jpredictor, jmetrics = jtimit.run(jtrain, jtrain, jtimit.TimitConfig(**conf))
    got = np_(predictor(Dataset.from_array(torch.as_tensor(X))).get().array())
    want = np.asarray(jpredictor(JDataset.from_array(jnp.asarray(X))).get().array())
    assert np.array_equal(got, want)
    assert metrics.total_accuracy > 0.9
    assert metrics.total_accuracy == jmetrics.total_accuracy


def test_timit_main_matches_jax_on_timit_files(tmp_path):
    """``main`` with the JAX flags on 440-dimensional TIMIT-layout files
    (one branch of 4,096 cosines, one epoch, lambda 1): the printed
    metrics equal JAX's."""
    X, y = _frames(128, 440, 6, seed=5)  # one draw of centres for both splits
    X, y, Xt, yt = X[:96], y[:96], X[96:], y[96:]
    train = _write_timit(tmp_path, X, y, "train")
    test = _write_timit(tmp_path, Xt, yt, "test")
    argv = ["--trainDataLocation", train[0], "--trainLabelsLocation", train[1],
            "--testDataLocation", test[0], "--testLabelsLocation", test[1],
            "--numCosines", "1", "--numEpochs", "1", "--lambda", "1"]
    printed = {}
    for name, main in (("torch", lambda: ttimit.main(argv, device="cpu")), ("jax", lambda: jtimit.main(argv))):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main() == 0
        lines = out.getvalue().splitlines()
        assert lines[-1].startswith("Total time: ")
        printed[name] = lines[:-1]
    assert printed["torch"] == printed["jax"]
    assert float(printed["torch"][0].split()[-1]) > 0.9  # "Accuracy: ..."
