"""The text slice on the CPU against the JAX package: the string nodes
(the tokenizer's Scala split quirks), n-grams and their counts, term
frequencies, stable hashes, hashed term frequencies (native and Python
paths), the sparse feature space's order, Sparsify/Densify, Shuffler, the
sparse row mode of ``Dataset``, both text apps' ``run`` in both feature
modes (predictions and metrics equal) and ``main``, a saved and reloaded
string-keyed Newsgroups pipeline (bit for bit) and the ``convert``
carriers of fitted text models."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu import native as jnative
from keystone_tpu.loaders.csv_loader import LabeledData as JLabeledData
from keystone_tpu.ops import nlp as jnlp
from keystone_tpu.ops.stats import TermFrequency as JTermFrequency
from keystone_tpu.ops.util import nodes as jnodes
from keystone_tpu.parallel.dataset import Dataset as JDataset
from keystone_tpu.pipelines.text import amazon_reviews as jamazon
from keystone_tpu.pipelines.text import newsgroups as jnews
from keystone_tpu_torch import convert
from keystone_tpu_torch import native as tnative
from keystone_tpu_torch.loaders.csv_loader import LabeledData
from keystone_tpu_torch.loaders.text_loaders import NEWSGROUPS_CLASSES
from keystone_tpu_torch.ops import nlp as tnlp
from keystone_tpu_torch.ops.stats.nodes import TermFrequency, presence
from keystone_tpu_torch.ops.util import nodes as tnodes
from keystone_tpu_torch.parallel.dataset import (
    Dataset,
    csr_from_coo,
    csr_head,
    csr_pad_rows,
    csr_transpose,
    is_sparse,
    on_device,
)
from keystone_tpu_torch.pipelines.text import amazon_reviews as tamazon
from keystone_tpu_torch.pipelines.text import newsgroups as tnews
from keystone_tpu_torch.workflow.api import FittedPipeline

DOCS = [
    "  The quick BROWN fo.X ",
    " ! !.,)JumpeD. ovER the LAZy DOG.. ! ",
    "",
    ",,,",
    "a,b,,",
    "Hello, World! hello world hello",
    "x",
    "tabs\tand\nnewlines  here",
    "under_score and digits 123 456 123",
]


def dense(x):
    """A sparse vector or matrix of either package as a dense numpy array."""
    if isinstance(x, torch.Tensor):
        return (x.to_dense() if x.layout != torch.strided else x).numpy()
    return np.asarray(x.todense() if hasattr(x, "todense") else x)


# -- string nodes, n-grams, term frequencies -----------------------------------


@pytest.mark.parametrize("doc", DOCS + ["café au lait", " leading", "trailing "])
def test_string_nodes_match_jax(doc):
    assert tnlp.Trim().apply(doc) == jnlp.Trim().apply(doc)
    assert tnlp.LowerCase().apply(doc) == jnlp.LowerCase().apply(doc)
    assert tnlp.Tokenizer().apply(doc) == jnlp.Tokenizer().apply(doc)
    assert tnlp.Tokenizer(r"\s+").apply(doc) == jnlp.Tokenizer(r"\s+").apply(doc)


def test_tokenizer_scala_split_quirks():
    tok = tnlp.Tokenizer()
    assert tok.apply("") == [""]
    assert tok.apply(",a b") == ["", "a", "b"]
    assert tok.apply("a b,,") == ["a", "b"]
    assert tok.apply(",,,") == []


@pytest.mark.parametrize("orders", [(1,), (1, 2), (2, 3), (1, 2, 3)])
def test_ngrams_match_jax(orders):
    toks = "a b c d a b".split()
    assert tnlp.NGramsFeaturizer(orders).apply(toks) == jnlp.NGramsFeaturizer(orders).apply(toks)
    with pytest.raises(ValueError):
        tnlp.NGramsFeaturizer([1, 3])
    with pytest.raises(ValueError):
        tnlp.NGramsFeaturizer([0, 1])


@pytest.mark.parametrize("mode", ["default", "noAdd"])
def test_ngram_counts_match_jax(mode):
    lines = [jnlp.NGramsFeaturizer([1, 2]).apply(d.split()) for d in
             ["a b a", "b a c", "c c c a"]]
    got = tnlp.NGramsCounts(mode).apply(Dataset.from_items(lines)).items()
    want = jnlp.NGramsCounts(mode).apply(JDataset.from_items(lines)).items()
    assert [(tuple(k), v) for k, v in got] == [(tuple(k), v) for k, v in want]
    assert repr(got[0][0]) == repr(want[0][0]) and isinstance(got[0][0], tnlp.NGram)


def test_term_frequency_matches_jax():
    terms = [["a", "b"], "c", ["a", "b"], "c", "c", ("x",)]
    assert TermFrequency().apply(terms) == JTermFrequency().apply(terms)
    assert TermFrequency(presence).apply(terms) == JTermFrequency(lambda x: 1).apply(terms)


def test_stable_hash_matches_jax():
    for term in ["", "a", "hello", ("a", "b"), 12, "café"]:
        assert tnlp.stable_hash(term) == jnlp.hashing_tf.stable_hash(term)


# -- hashed term frequencies ----------------------------------------------------


def _tokens(docs):
    return [jnlp.Tokenizer().apply(d.lower().strip()) for d in docs]


def test_hashing_tf_matches_jax():
    toks = _tokens(DOCS)
    t, j = tnlp.HashingTF(64), jnlp.HashingTF(64)
    np.testing.assert_array_equal(dense(t.apply_batch(Dataset.from_items(toks)).padded()),
                                  dense(j.apply_batch(JDataset.from_items(toks)).padded()))
    for doc in toks[:3]:
        np.testing.assert_array_equal(dense(t.apply(doc)), dense(j.apply(doc)))


@pytest.mark.parametrize("orders", [(1,), (1, 2), (2, 3)])
def test_ngrams_hashing_tf_matches_jax(orders):
    toks = _tokens(DOCS)
    t, j = tnlp.NGramsHashingTF(orders, 97), jnlp.NGramsHashingTF(orders, 97)
    got = t.apply_batch(Dataset.from_items(toks)).padded()
    assert is_sparse(got)
    np.testing.assert_array_equal(dense(got), dense(j.apply_batch(JDataset.from_items(toks)).padded()))
    np.testing.assert_array_equal(dense(t.apply(toks[5])), dense(j.apply(toks[5])))


def test_native_text_hash_matches_jax_native():
    assert tnative.text_native_available()
    got = tnative.text_ngram_hash_tf(DOCS, 1, 2, 1024, True)
    want = jnative.text_ngram_hash_tf(DOCS, 1, 2, 1024, True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert tnative.text_ngram_hash_tf(["café"], 1, 2, 64) is None
    with pytest.raises(ValueError):
        tnative.text_ngram_hash_tf(DOCS, 1, 2, 0)


@pytest.mark.parametrize("binarize", [False, True])
def test_fused_hash_tf_matches_jax_native_and_python_paths(binarize, monkeypatch):
    docs = DOCS + ["naïve café, café!", "plain ascii again"]
    j = jnlp.FusedTextHashTF([1, 2], 256, binarize=binarize)
    # JAX sends the whole batch through Python (one document is not ASCII)
    want = dense(j.apply_batch(JDataset.from_items(docs)).padded())
    t = tnlp.FusedTextHashTF([1, 2], 256, binarize=binarize)
    got = t.apply_batch(Dataset.from_items(docs)).padded()
    np.testing.assert_array_equal(dense(got), want)
    assert t.routes == {"native": len(docs) - 1, "python": 1}
    # ASCII documents alone: both native
    ascii_docs = [d for d in docs if d.isascii()]
    np.testing.assert_array_equal(
        dense(t.apply_batch(Dataset.from_items(ascii_docs)).padded()),
        dense(j.apply_batch(JDataset.from_items(ascii_docs)).padded()))
    np.testing.assert_array_equal(dense(t.apply(docs[1])), dense(j.apply(docs[1])))
    # without the library every document takes the Python nodes
    monkeypatch.setattr(tnative._TEXT, "load", lambda: None)
    t2 = tnlp.FusedTextHashTF([1, 2], 256, binarize=binarize)
    np.testing.assert_array_equal(dense(t2.apply_batch(Dataset.from_items(docs)).padded()), want)
    assert t2.routes == {"native": 0, "python": len(docs)}


# -- sparse feature space, Sparsify, Densify, Shuffler ----------------------------


def _tf_dicts(docs, tf=TermFrequency(presence)):
    grams = tnlp.NGramsFeaturizer([1, 2])
    return [tf.apply(grams.apply(tnlp.Tokenizer().apply(d.lower()))) for d in docs]


CORPUS = ["b a c a", "c d b", "e a b c", "d d f", "a b", "g h i b"]


@pytest.mark.parametrize("k", [3, 5, 100])
def test_common_sparse_features_order_matches_jax(k):
    items = _tf_dicts(CORPUS)
    t = tnodes.CommonSparseFeatures(k).fit(Dataset.from_items(items))
    j = jnodes.CommonSparseFeatures(k).fit(JDataset.from_items(items))
    assert list(t.feature_index.items()) == list(j.feature_index.items())
    assert t.dim == j.dim == k
    np.testing.assert_array_equal(dense(t.apply_batch(Dataset.from_items(items)).padded()),
                                  dense(j.apply_batch(JDataset.from_items(items)).padded()))
    np.testing.assert_array_equal(dense(t.apply(items[2])), dense(j.apply(items[2])))


def test_all_sparse_features_order_matches_jax():
    items = _tf_dicts(CORPUS)
    t = tnodes.AllSparseFeatures().fit(Dataset.from_items(items))
    j = jnodes.AllSparseFeatures().fit(JDataset.from_items(items))
    assert list(t.feature_index.items()) == list(j.feature_index.items())
    np.testing.assert_array_equal(dense(t.apply_batch(Dataset.from_items(items)).padded()),
                                  dense(j.apply_batch(JDataset.from_items(items)).padded()))


def test_sparsify_and_densify_match_jax():
    rng = np.random.default_rng(0)
    x = (rng.integers(1, 5, (7, 9)) * (rng.random((7, 9)) < 0.3)).astype(np.float32)
    tsp = tnodes.Sparsify().apply_batch(Dataset.of(x)).padded()
    jsp = jnodes.Sparsify().apply_batch(JDataset.of(x)).padded()
    assert is_sparse(tsp) and tsp._nnz() == int(jsp.nse)
    crow = tsp.crow_indices().numpy()
    rows = np.repeat(np.arange(7), np.diff(crow))
    np.testing.assert_array_equal(np.stack([rows, tsp.col_indices().numpy()], 1),
                                  np.asarray(jsp.indices))
    np.testing.assert_array_equal(tsp.values().numpy(), np.asarray(jsp.data))
    back = tnodes.Densify().apply_batch(Dataset.from_array(tsp)).padded()
    np.testing.assert_array_equal(back.numpy(), dense(jnodes.Densify().apply_batch(
        JDataset.from_array(jsp)).padded()))
    np.testing.assert_array_equal(dense(tnodes.Sparsify().apply(x[2])), x[2])
    np.testing.assert_array_equal(tnodes.Densify().apply(tnodes.Sparsify().apply(x[2])).numpy(),
                                  x[2])
    ds = Dataset.of(x)
    assert tnodes.Densify().apply_batch(ds) is ds


@pytest.mark.parametrize("device", [False, True])
def test_shuffler_matches_jax(device, mesh8):
    x = np.arange(40, dtype=np.float32).reshape(10, 4)
    padded = Dataset.from_array(torch.cat([torch.as_tensor(x), torch.zeros(6, 4)]), n=10)
    got = tnodes.Shuffler(seed=3, device=device).apply_batch(padded)
    want = jnodes.Shuffler(seed=3).apply_batch(JDataset.of(x))
    np.testing.assert_array_equal(got.array().numpy(), np.asarray(want.array()))
    if device:
        assert got.padded_n == 16 and (got.padded()[10:] == 0).all()
    items = tnodes.Shuffler(seed=3).apply_batch(Dataset.from_items(list("abcdefghij")))
    assert items.items() == jnodes.Shuffler(seed=3).apply_batch(
        JDataset.from_items(list("abcdefghij"))).items()


# -- the sparse row mode of Dataset ---------------------------------------------


def test_sparse_dataset_mode_sums_duplicates_like_bcoo():
    rows, cols, vals = [0, 0, 1, 2, 2, 2], [1, 1, 0, 3, 3, 2], [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    coo = torch.sparse_coo_tensor(torch.tensor([rows, cols]), torch.tensor(vals), (4, 5))
    ds = Dataset.from_array(coo)  # coalesced into CSR, duplicates summed
    assert is_sparse(ds.padded())
    from jax.experimental import sparse as jsparse
    bcoo = jsparse.BCOO((jnp.asarray(vals), jnp.asarray(np.stack([rows, cols], 1))), shape=(4, 5))
    np.testing.assert_array_equal(dense(ds.padded()), np.asarray(bcoo.todense()))
    np.testing.assert_array_equal(dense(csr_from_coo(rows, cols, vals, (4, 5))),
                                  np.asarray(bcoo.todense()))
    W = np.arange(10, dtype=np.float32).reshape(5, 2)
    np.testing.assert_array_equal((ds.padded() @ torch.as_tensor(W)).numpy(),
                                  np.asarray(bcoo @ jnp.asarray(W)))


def test_sparse_dataset_views_padding_and_placement():
    a = csr_from_coo([0, 1, 2], [4, 0, 2], [1.0, 2.0, 3.0], (3, 5))
    ds = Dataset.from_array(csr_pad_rows(a, 8), n=3)
    assert ds.padded_n == 8 and ds.n == 3
    np.testing.assert_array_equal(dense(ds.padded())[3:], 0)
    np.testing.assert_array_equal(dense(ds.array()), dense(a))
    np.testing.assert_array_equal(ds.mask().numpy(), [1, 1, 1, 0, 0, 0, 0, 0])
    assert ds._pad_to(10).padded_n == 10 and ds.cache() is ds
    items = ds.items()
    assert len(items) == 3 and items[0].layout == torch.sparse_coo
    np.testing.assert_array_equal(dense(items[2]), dense(a)[2])
    np.testing.assert_array_equal(dense(ds.first()), dense(a)[0])
    back = Dataset.from_items(items).to_array_mode()
    np.testing.assert_array_equal(dense(back.padded()), dense(a))
    moved = on_device(Dataset.from_items(items), torch.device("cpu"))
    assert moved.is_array and is_sparse(moved.padded())
    assert on_device(Dataset.from_array(a), torch.device("cpu")).padded() is a
    np.testing.assert_array_equal(dense(csr_head(a, 2)), dense(a)[:2])
    np.testing.assert_array_equal(dense(csr_transpose(a)), dense(a).T)
    zipped = Dataset.from_array(a).zip(Dataset.of(np.zeros((3, 2), np.float32)))
    assert is_sparse(zipped.padded()[0])


# -- the apps ---------------------------------------------------------------------

POS_WORDS = ["great", "love", "excellent", "awesome", "perfect"]
NEG_WORDS = ["bad", "hate", "terrible", "awful", "poor"]


def _sentiment(n, seed):
    """tests/pipelines/test_text_pipelines.py's reviews."""
    rng = np.random.default_rng(seed)
    texts, labels = [], []
    for _ in range(n):
        pos = rng.random() < 0.5
        texts.append(" ".join(rng.choice(POS_WORDS if pos else NEG_WORDS, 5)) + " product")
        labels.append(1 if pos else 0)
    return texts, np.asarray(labels, np.int32)


def _groups(seed):
    """tests/pipelines/test_text_pipelines.py's two newsgroups."""
    rng = np.random.default_rng(seed)
    vocabs = [["compiler", "kernel", "gpu"], ["baseball", "pitcher", "inning"]]
    texts, labels = [], []
    for _ in range(60):
        c = int(rng.random() < 0.5)
        texts.append(" ".join(rng.choice(vocabs[c], 6)))
        labels.append(c)
    return texts, np.asarray(labels, np.int32)


def _pair(texts, labels):
    return (JLabeledData(labels=JDataset.from_array(jnp.asarray(labels)),
                         data=JDataset.from_items(texts)),
            LabeledData(labels=Dataset.from_array(torch.as_tensor(labels)),
                        data=Dataset.from_items(texts)))


@pytest.mark.parametrize("hashing", [False, True])
def test_newsgroups_run_matches_jax(hashing, mesh8):
    jd, td = _pair(*_groups(2 if not hashing else 5))
    jconf = jnews.NewsgroupsConfig(n_grams=2, common_features=1024 if hashing else 128,
                                   hashing=hashing)
    tconf = tnews.NewsgroupsConfig(n_grams=2, common_features=1024 if hashing else 128,
                                   hashing=hashing)
    jp, jm = jnews.run(jd, jd, jconf)
    tp, tm = tnews.run(td, td, tconf, device="cpu")
    np.testing.assert_array_equal(tm.confusion_matrix, jm.confusion_matrix)
    assert tm.total_accuracy == jm.total_accuracy > 0.9
    np.testing.assert_array_equal(np.asarray(tp(td.data).get().array()),
                                  np.asarray(jp(jd.data).get().array()))


@pytest.mark.parametrize("hashing", [False, True])
def test_amazon_run_matches_jax(hashing, mesh8):
    jtrain, ttrain = _pair(*_sentiment(80, 0))
    jtest, ttest = _pair(*_sentiment(20, 1))
    kw = dict(common_features=1024 if hashing else 256, num_iters=30, hashing=hashing)
    jp, jm = jamazon.run(jtrain, jtest, jamazon.AmazonReviewsConfig(**kw))
    tp, tm = tamazon.run(ttrain, ttest, tamazon.AmazonReviewsConfig(**kw), device="cpu")
    assert (tm.tp, tm.fp, tm.tn, tm.fn) == (jm.tp, jm.fp, jm.tn, jm.fn)
    assert tm.accuracy > 0.9
    np.testing.assert_array_equal(np.asarray(tp(ttest.data).get().array()),
                                  np.asarray(jp(jtest.data).get().array()))


def _write_newsgroups(root, texts, labels):
    for i, (t, c) in enumerate(zip(texts, labels)):
        d = root / NEWSGROUPS_CLASSES[c]
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{i:05d}").write_text(t)
    return str(root)


def _write_reviews(path, texts, labels):
    import json

    path.write_text("".join(json.dumps({"overall": 5.0 if y else 1.0, "reviewText": t}) + "\n"
                            for t, y in zip(texts, labels)))
    return str(path)


def _printed(fn, argv, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert fn(argv, **kw) == 0
    return out.getvalue()


@pytest.mark.parametrize("hashing", [False, True])
def test_mains_on_written_files_print_what_jax_prints(hashing, tmp_path, mesh8):
    news = _write_newsgroups(tmp_path / "news", *_groups(2))
    argv = ["--trainLocation", news, "--testLocation", news, "--commonFeatures", "128"]
    argv += ["--hashing"] if hashing else []
    assert _printed(tnews.main, argv, device="cpu") == _printed(jnews.main, argv)
    train = _write_reviews(tmp_path / "train.json", *_sentiment(80, 0))
    test = _write_reviews(tmp_path / "test.json", *_sentiment(20, 1))
    argv = ["--trainLocation", train, "--testLocation", test, "--commonFeatures", "256",
            "--numIters", "30"] + (["--hashing"] if hashing else [])
    assert _printed(tamazon.main, argv, device="cpu") == _printed(jamazon.main, argv)


def test_fitted_newsgroups_pipeline_saves_and_loads_bit_for_bit(tmp_path):
    _, td = _pair(*_groups(2))
    fitted = tnews.build_pipeline(td, tnews.NewsgroupsConfig(common_features=128),
                                  device="cpu").fit()
    vec = [o for o in fitted.graph.operators.values()
           if isinstance(o, tnodes.SparseFeatureVectorizer)][0]
    assert any(isinstance(k, tuple) and len(k) == 2 for k in vec.feature_index)
    path = str(tmp_path / "news.pt")
    fitted.save(path)
    loaded = FittedPipeline.load(path, device="cpu")
    want = fitted(td.data).array()
    got = loaded(td.data).array()
    assert torch.equal(got, want)
    assert loaded.apply("compiler kernel gpu") == fitted.apply("compiler kernel gpu")


# -- convert carriers ---------------------------------------------------------------


@pytest.mark.parametrize("app", ["newsgroups", "amazon"])
@pytest.mark.parametrize("hashing", [False, True])
def test_jax_text_pipeline_converts_and_scores_the_same(app, hashing, mesh8):
    if app == "newsgroups":
        jd, td = _pair(*_groups(2))
        conf = dict(common_features=128 if not hashing else 512, hashing=hashing)
        jfit = jnews.build_pipeline(jd, jnews.NewsgroupsConfig(**conf)).fit()
    else:
        jd, td = _pair(*_sentiment(80, 0))
        conf = dict(common_features=256 if not hashing else 512, num_iters=30, hashing=hashing)
        jfit = jamazon.build_pipeline(jd, jamazon.AmazonReviewsConfig(**conf)).fit()
    params = convert.text_params(jfit)
    assert ("num_features" in params) == hashing
    port = convert.text_from_numpy(params, device="cpu")
    want = np.asarray(jfit(jd.data).array())
    got = port(td.data).array().numpy()
    np.testing.assert_array_equal(got, want)
    again = convert.text_params(port)
    assert again["orders"] == params["orders"]


def test_naive_bayes_and_logistic_carriers():
    rng = np.random.default_rng(0)
    nb = {"pi": rng.standard_normal(3), "theta": rng.standard_normal((3, 6))}
    x = rng.random((4, 6)).astype(np.float32)
    m = convert.naive_bayes_from_numpy(nb, device="cpu")
    from keystone_tpu.ops.learning.classifiers import LogisticRegressionModel, NaiveBayesModel

    want = np.asarray(NaiveBayesModel(jnp.asarray(nb["pi"], jnp.float32),
                                      jnp.asarray(nb["theta"], jnp.float32))
                      .apply_batch(JDataset.of(x)).array())
    np.testing.assert_allclose(m.apply_batch(Dataset.of(x)).array().numpy(), want, rtol=1e-5,
                               atol=1e-6)
    W = rng.standard_normal((6, 2))
    lr = convert.logistic_regression_from_numpy({"W": W}, device="cpu")
    want = np.asarray(LogisticRegressionModel(jnp.asarray(W, jnp.float32))
                      .apply_batch(JDataset.of(x)).array())
    np.testing.assert_array_equal(lr.apply_batch(Dataset.of(x)).array().numpy(), want)


@pytest.mark.parametrize("ell", [False, True])
def test_linear_mapper_carriers(ell):
    from keystone_tpu.ops.learning.linear import LinearMapper as JLinearMapper
    from keystone_tpu.ops.learning.sparse_ell import EllLinearMapper as JEllLinearMapper
    from keystone_tpu.ops.learning.sparse_ell import ell_dataset as jell_dataset
    from keystone_tpu_torch.ops.learning.sparse_ell import EllLinearMapper, ell_dataset

    rng = np.random.default_rng(1)
    params = {"W": rng.standard_normal((12, 3)), "intercept": rng.standard_normal(3)}
    m = convert.linear_mapper_from_numpy(params, ell=ell, device="cpu")
    assert isinstance(m, EllLinearMapper) == ell
    jcls = JEllLinearMapper if ell else JLinearMapper
    jm = jcls(jnp.asarray(params["W"], jnp.float32),
              intercept=jnp.asarray(params["intercept"], jnp.float32))
    if ell:
        idx = rng.integers(0, 12, (5, 3)).astype(np.int32)
        vals = rng.standard_normal((5, 3)).astype(np.float32)
        got = m.apply_batch(ell_dataset(idx, vals)).array().numpy()
        want = np.asarray(jm.apply_batch(jell_dataset(idx, vals)).array())
    else:
        x = rng.standard_normal((5, 12)).astype(np.float32)
        got = m.apply_batch(Dataset.of(x)).array().numpy()
        want = np.asarray(jm.apply_batch(JDataset.of(x)).array())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_the_jax_feature_index_carries_into_the_port_vectorizer():
    items = _tf_dicts(CORPUS)
    j = jnodes.CommonSparseFeatures(6).fit(JDataset.from_items(items))
    t = tnodes.SparseFeatureVectorizer(j.feature_index, j.dim)
    np.testing.assert_array_equal(dense(t.apply_batch(Dataset.from_items(items)).padded()),
                                  dense(j.apply_batch(JDataset.from_items(items)).padded()))
