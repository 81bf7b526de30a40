"""The language-model and tagger slice on the CPU against the JAX package:
word-frequency ranks (ties too), both n-gram indexers, stupid backoff's
scores, ``run`` and ``main`` of StupidBackoffPipeline and the port's
``python -m keystone_tpu_torch`` entry, the perceptron and rule taggers
and the external-NLP nodes (all equal), and the linear-chain CRF: exact
inference against JAX's and against brute force, padding invariance,
batched decode, parameters after a fixed number of epochs, full fits by
their decoded tags, BIO validity and a pickled tagger."""

import contextlib
import io
import itertools
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.ops import nlp as jnlp
from keystone_tpu.ops.nlp import crf as jcrf
from keystone_tpu.ops.nlp import external as jext
from keystone_tpu.ops.nlp import stupid_backoff as jsb
from keystone_tpu.ops.nlp import tagging as jtag
from keystone_tpu.parallel.dataset import Dataset as JDataset
from keystone_tpu.pipelines.nlp import stupid_backoff_pipeline as jpipe
from keystone_tpu_torch import __main__ as cli
from keystone_tpu_torch.ops import nlp as tnlp
from keystone_tpu_torch.ops.nlp import crf as tcrf
from keystone_tpu_torch.ops.nlp import external as text
from keystone_tpu_torch.ops.nlp import stupid_backoff as tsb
from keystone_tpu_torch.ops.nlp import tagging as ttag
from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.pipelines.nlp import stupid_backoff_pipeline as tpipe

CORPUS = [
    "the cat sat on the mat", "the cat ran", "a dog sat on a log",
    "the dog ran to the cat", "a cat and a dog sat", "zebra", "",
    "Mat sat, the CAT ran!",
]


def _zipf_lines(seed, n_lines, vocab=60, words=9):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1) ** 1.1
    ids = rng.choice(vocab, size=(n_lines, words), p=p / p.sum())
    return [" ".join(f"w{i}" for i in row[: rng.integers(1, words + 1)]) for row in ids]


# -- word frequency, indexers, stupid backoff ---------------------------------


@pytest.mark.parametrize("lines", [CORPUS, _zipf_lines(0, 40)], ids=["small", "zipf"])
def test_word_frequency_ranks_equal_jax_ties_included(lines):
    toks = [ln.split() for ln in lines]
    got = tnlp.WordFrequencyEncoder().fit(Dataset.from_items(toks))
    want = jnlp.WordFrequencyEncoder().fit(JDataset.from_items(toks))
    # insertion order of the index is the rank order: ties in first-seen order
    assert list(got.word_index.items()) == list(want.word_index.items())
    assert got.unigram_counts == want.unigram_counts
    probe = toks[0] + ["never-seen"]
    assert got.apply(probe) == want.apply(probe)
    assert got.apply(["never-seen"]) == [tnlp.word_frequency.OOV_INDEX] == [-1]
    assert got.apply_batch(Dataset.from_items(toks)).items() == \
        want.apply_batch(JDataset.from_items(toks)).items()


def test_bitpack_indexer_round_trips_equal_jax():
    rng = np.random.default_rng(1)
    t, j = tsb.NaiveBitPackIndexer(), jsb.NaiveBitPackIndexer()
    for _ in range(200):
        order = int(rng.integers(1, 4))
        gram = [int(w) for w in rng.integers(0, 1 << 20, order)]
        packed = t.pack(gram)
        assert packed == j.pack(gram) and packed < 1 << 62
        assert t.ngram_order(packed) == order
        assert [t.unpack(packed, i) for i in range(order)] == gram
        if order > 1:
            for fn in ("remove_farthest_word", "remove_current_word"):
                assert getattr(t, fn)(packed) == getattr(j, fn)(packed)
            assert [t.unpack(t.remove_farthest_word(packed), i)
                    for i in range(order - 1)] == gram[1:]
            assert [t.unpack(t.remove_current_word(packed), i)
                    for i in range(order - 1)] == gram[:-1]
    with pytest.raises(ValueError):
        t.pack([1 << 20])
    with pytest.raises(ValueError):
        t.pack([1, 2, 3, 4])


def test_tuple_indexer_and_partition_equal_jax():
    t, j = tsb.NGramIndexer(), jsb.NGramIndexer()
    for gram in [(1,), (3, 4), ("a", "b", "c"), (5, 6, 7, 8, 9)]:
        g = t.pack(gram)
        assert t.ngram_order(g) == j.ngram_order(j.pack(gram))
        assert t.remove_farthest_word(g) == j.remove_farthest_word(j.pack(gram))
        assert t.remove_current_word(g) == j.remove_current_word(j.pack(gram))
        for parts in (1, 7, 64):
            assert tsb.initial_bigram_partition(g, parts) == \
                jsb.initial_bigram_partition(j.pack(gram), parts)


def test_stupid_backoff_scores_every_ngram_equal_jax():
    lines = _zipf_lines(2, 60)
    tmodel, tenc = tpipe.run(Dataset.from_items(lines), tpipe.StupidBackoffConfig(n=3))
    jmodel, jenc = jpipe.run(JDataset.from_items(lines), jpipe.StupidBackoffConfig(n=3))
    assert tmodel.num_tokens == jmodel.num_tokens
    assert tmodel.ngram_counts == jmodel.ngram_counts
    grams = list(tmodel.ngram_counts)
    # every seen n-gram, and unseen ones that back off once and twice
    vocab = sorted(tenc.unigram_counts)
    rng = np.random.default_rng(3)
    grams += [tuple(int(w) for w in rng.choice(vocab, k)) for k in (2, 3) for _ in range(50)]
    grams += [(10_000, vocab[0]), (vocab[0], vocab[1], 10_000)]
    for g in grams:
        assert tmodel.score(g) == jmodel.score(g), g
    assert tmodel.apply_batch(Dataset.from_items(grams[:20])).items() == \
        [jmodel.score(g) for g in grams[:20]]


def test_stupid_backoff_estimator_on_strings_equal_jax():
    tokens = [["a", "b", "c"], ["a", "b", "d"]]
    unigrams = {"a": 2, "b": 2, "c": 1, "d": 1}
    tg = tnlp.NGramsFeaturizer([2, 3]).apply_batch(Dataset.from_items(tokens))
    jg = jnlp.NGramsFeaturizer([2, 3]).apply_batch(JDataset.from_items(tokens))
    tm = tnlp.StupidBackoffEstimator(unigrams).fit(tnlp.NGramsCounts().apply(tg))
    jm = jnlp.StupidBackoffEstimator(unigrams).fit(jnlp.NGramsCounts().apply(jg))
    for g in [("a", "b"), ("a", "b", "c"), ("a", "b", "z"), ("z", "b"), ("q", "z")]:
        assert tm.score(g) == jm.score(g)
    assert tm.score(("z", "b")) == pytest.approx(0.4 * 2 / 6)


def test_stupid_backoff_pipeline_run_as_the_jax_test():
    text = ["the cat sat", "the cat ran", "the dog sat"]
    model, encoder = tpipe.run(Dataset.from_items(text), tpipe.StupidBackoffConfig(n=3))
    the, cat = encoder.word_index["the"], encoder.word_index["cat"]
    assert model.score((the, cat)) == pytest.approx(2 / 3)


def _run_main(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    return rc, out.getvalue()


def test_stupid_backoff_main_and_cli_print_what_jax_prints(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_text("\n".join(_zipf_lines(4, 30) + ["", "  "]) + "\n")
    argv = ["--trainLocation", str(path)]
    want = _run_main(jpipe.main, argv)
    assert want[0] == 0
    assert _run_main(tpipe.main, argv) == want
    assert _run_main(cli.main, ["StupidBackoffPipeline"] + argv) == want
    assert _run_main(tpipe.main, argv + ["--n", "2"]) == _run_main(jpipe.main, argv + ["--n", "2"])


def partial_cpu(main):
    """``main`` with ``device="cpu"``."""
    return lambda argv: main(argv, device="cpu")


def test_cli_lists_the_eight_apps_and_refuses_the_plane():
    """The eight apps, serve-gateway (with --zoo, --register, --refit,
    --shard-model and --aot-cache), serve-router, serve-loadgen,
    serve-lifecycle, serve-aot-build, serve-autoscale,
    serve-capacity-plan, keystone-lint and bench-diff run, and --otlp-*
    is peeled, and serve-bench answers its own argument checks: the
    whole request plane runs and nothing says "not ported yet"."""
    from keystone_tpu import __main__ as jcli

    assert sorted(cli.APPS) == sorted(jcli.APPS)
    rc, out = _run_main(cli.main, ["-h"])
    assert rc == 0 and all(f"  {app}\n" in out for app in jcli.APPS)
    assert "  serve-gateway" in out and "--admin-port N" in out
    assert "  serve-router" in out and "--otlp-endpoint URL" in out
    assert "  serve-loadgen" in out and "  serve-lifecycle" in out
    assert _run_main(cli.main, [])[0] == 2
    assert "  keystone-lint" in out and "  bench-diff" in out
    assert not hasattr(cli, "PLANE_APPS") and "  serve-bench" in out
    assert "not ported yet" not in out
    # the tools run: their own argument checks answer (bench-diff's
    # argparse exits 2 without its two files, keystone-lint on a bad flag)
    for argv, want in ((["keystone-lint", "--list-rules"], 0), (["keystone-lint", "--frobnicate"], 2),
                       (["bench-diff", "-h"], 0), (["bench-diff"], 2)):
        try:
            rc, out = _run_main(cli.main, argv)
        except SystemExit as e:
            rc, out = e.code, ""
        assert rc == want and "not ported yet" not in out, argv
    # serve-autoscale, --shard-model and --aot-cache run (they exited 2
    # before): their own argument checks answer — serve-autoscale wants
    # its SLO, --mesh-model past the host's devices exits 1, and
    # --aot-cache wants a directory
    for argv, want in ((["serve-autoscale"], 2),
                       (["--gateway-port", "0", "--shard-model", "--mesh-model", "2"], 1),
                       (["serve-gateway", "--aot-cache"], 2)):
        try:
            rc, out = _run_main(partial_cpu(cli.main), argv)
        except SystemExit as e:
            rc, out = e.code, ""
        assert rc == want and "not ported yet" not in out, argv
    from keystone_tpu_torch.serving import sharding

    sharding.set_mesh(None)
    # --refit runs over the plain demo model only, and says so as the
    # JAX entry does
    rc, out = _run_main(cli.main, ["serve-gateway", "--refit", "--zoo", "spec.json"])
    assert rc == 2 and "--refit wants the plain demo model" in out
    # the fleet, zoo, load generator and lifecycle run: their own
    # argument checks answer (argparse exits 2 on a bad value, -h 0)
    for argv, want in ((["serve-router", "-h"], 0), (["serve-router", "--router-port", "x"], 2),
                       (["serve-gateway", "--zoo"], 2), (["serve-gateway", "--register"], 2),
                       (["serve-loadgen", "-h"], 0), (["serve-loadgen", "--rate", "x"], 2),
                       (["serve-lifecycle", "-h"], 0), (["serve-lifecycle", "status"], 2),
                       (["serve-aot-build", "-h"], 0), (["serve-aot-build", "--d", "x"], 2),
                       (["serve-autoscale", "-h"], 0),
                       (["serve-capacity-plan", "-h"], 0), (["serve-capacity-plan"], 2),
                       (["serve-bench", "-h"], 0), (["serve-bench", "--d", "x"], 2),
                       (["--otlp-endpoint"], 2), (["--otlp-endpoint", "-x"], 2)):
        try:
            rc, out = _run_main(cli.main, argv)
        except SystemExit as e:
            rc, out = e.code, ""
        assert rc == want and "not ported yet" not in out, argv
    rc, out = _run_main(cli.main, ["--otlp-endpoint", "http://127.0.0.1:9", "--otlp-service", "s",
                                   "--otlp-replica", "r", "-h"])
    assert rc == 0 and "otlp export: http://127.0.0.1:9/v1/traces (service.name=s replica=r)" in out
    from keystone_tpu_torch.observability import disable_tracing, get_tracer

    get_tracer()._sinks.clear()  # the exporter installed above
    disable_tracing()
    for argv in (["--gateway-port", "x"], ["--gateway-port", "0", "NewsgroupsPipeline"],
                 ["--admin-port", "x"]):
        assert _run_main(cli.main, argv)[0] == 2, argv
    rc, out = _run_main(cli.main, ["NoSuchApp"])
    assert rc == 2 and "unknown app" in out


# -- perceptron and rule taggers, external nodes --------------------------------


def _pos_corpus(n=120, seed=0):
    dts, jjs = ["the", "a"], ["big", "small", "red", "old"]
    nns = ["dog", "cat", "house", "tree", "car", "bird"]
    vbs, rbs = ["runs", "sits", "falls", "jumps"], ["quickly", "slowly"]
    rng = np.random.default_rng(seed)
    sents = []
    for _ in range(n):
        toks, tags = [str(rng.choice(dts))], ["DT"]
        if rng.random() < 0.5:
            toks.append(str(rng.choice(jjs)))
            tags.append("JJ")
        toks.append(str(rng.choice(nns)))
        tags.append("NN")
        toks.append(str(rng.choice(vbs)))
        tags.append("VB")
        if rng.random() < 0.5:
            toks.append(str(rng.choice(rbs)))
            tags.append("RB")
        sents.append((toks, tags))
    return sents


def _ner_corpus(n=200, seed=7):
    rng = np.random.default_rng(seed)
    pers = [["karen", "smith"], ["Bob", "Jones"], ["maria", "garcia"], ["Wei", "Chen"]]
    orgs = [["acme", "group"], ["Initech", "Corp"], ["globex"], ["Hooli"]]
    locs = [["springfield"], ["New", "Avalon"], ["east", "haven"]]
    sents = []
    for _ in range(n):
        kind = rng.integers(0, 3)
        if kind == 0:
            p = pers[rng.integers(0, len(pers))]
            sents.append((["yesterday"] + p + ["visited", "us"],
                          ["O", "B-PER"] + ["I-PER"] * (len(p) - 1) + ["O", "O"]))
        elif kind == 1:
            o = orgs[rng.integers(0, len(orgs))]
            sents.append((["engineers", "at"] + o + ["shipped", "it"],
                          ["O", "O", "B-ORG"] + ["I-ORG"] * (len(o) - 1) + ["O", "O"]))
        else:
            loc = locs[rng.integers(0, len(locs))]
            sents.append((["they", "moved", "to"] + loc + ["in", "May", "1999"],
                          ["O", "O", "O", "B-LOC"] + ["I-LOC"] * (len(loc) - 1)
                          + ["O", "O", "O"]))
    return sents


@pytest.mark.parametrize("kind", ["pos", "ner"])
def test_perceptron_taggers_equal_jax(kind):
    sents = _pos_corpus() if kind == "pos" else _ner_corpus()
    est = "PerceptronTaggerEstimator" if kind == "pos" else "NEREstimator"
    got = getattr(ttag, est)(n_iter=4, seed=2).fit(Dataset.from_items(sents[:100]))
    want = getattr(jtag, est)(n_iter=4, seed=2).fit(JDataset.from_items(sents[:100]))
    assert got.model.weights == want.model.weights
    assert got.model.classes == want.model.classes
    for toks, _ in sents[100:] + [(["Unseen", "words", "here"], None)]:
        assert got(toks) == want(toks)
        assert got.apply(toks) == want.apply(toks)
    assert got.apply_batch(Dataset.from_items([s for s, _ in sents[100:110]])).items() == \
        [want.apply(s) for s, _ in sents[100:110]]


SENTENCES = [
    "Dr . Smith joined Acme Corp in March 2021 with 500 staff".split(),
    "The quick dogs ran slowly to Paris in 1995".split(),
    "Mr. Bob Jones of Initech Inc visited Prof Lee on 3.5 days".split(),
    "it was interesting , amazingly careful and readable".split(),
    ["I"], [],
]


@pytest.mark.parametrize("toks", SENTENCES, ids=[str(i) for i in range(len(SENTENCES))])
def test_rule_taggers_and_nodes_equal_jax(toks):
    assert ttag.rule_pos_tag(toks) == jtag.rule_pos_tag(toks)
    assert ttag.rule_ner_tag(toks) == jtag.rule_ner_tag(toks)
    assert text.POSTagger().apply(toks) == jext.POSTagger().apply(toks)
    assert text.NER().apply(toks) == jext.NER().apply(toks)
    for i in range(len(toks)):
        assert ttag._features(toks, i, "NN", "DT") == jtag._features(toks, i, "NN", "DT")
        assert ttag._ner_features(toks, i, "O", "B-PER") == \
            jtag._ner_features(toks, i, "O", "B-PER")


@pytest.mark.parametrize("ner", [None, False, "upper"])
def test_corenlp_feature_extractor_equals_jax(ner):
    fn = {None: None, False: False, "upper": lambda ts: [t.upper() for t in ts]}[ner]
    for doc in ["he visited Acme Corp today", "Dr. Smith walked in March 2021 ",
                "running jumped boxes", ""]:
        got = text.CoreNLPFeatureExtractor(orders=(1, 2), ner=fn).apply(doc)
        want = jext.CoreNLPFeatureExtractor(orders=(1, 2), ner=fn).apply(doc)
        assert got == want, doc
    lem = text.CoreNLPFeatureExtractor(lemmatizer=str.upper).apply("a b c")
    assert lem == jext.CoreNLPFeatureExtractor(lemmatizer=str.upper).apply("a b c")


# -- CRF inference ----------------------------------------------------------------


def _brute(e, trans, start):
    L, T = e.shape
    scores = {}
    for path in itertools.product(range(T), repeat=L):
        s = start[path[0]] + sum(e[t, path[t]] for t in range(L))
        s += sum(trans[path[t], path[t + 1]] for t in range(L - 1))
        scores[path] = s
    vals = np.array(list(scores.values()))
    m = vals.max()
    best = max(scores, key=scores.get)
    return m + np.log(np.exp(vals - m).sum()), list(best)


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("trial", range(3))
def test_crf_inference_matches_jax_and_brute_force(trial):
    rng = np.random.default_rng(trial)
    L, T = 5, 3
    e = rng.normal(size=(L, T)).astype(np.float32)
    trans = rng.normal(size=(T, T)).astype(np.float32)
    start = rng.normal(size=(T,)).astype(np.float32)
    mask = np.ones(L, np.float32)
    logz_ref, path_ref = _brute(e.astype(np.float64), trans, start)
    logz = float(tcrf.log_partition(*_t(e, trans, start, mask)))
    # bars: 1e-4 of brute force (the JAX test's), 1e-5 of JAX's own
    assert abs(logz - logz_ref) < 1e-4
    assert abs(logz - float(jcrf.log_partition(e, trans, start, mask))) < 1e-5
    path = tcrf.viterbi(*_t(e, trans, start), L).numpy()
    assert list(path) == path_ref == list(np.asarray(jcrf.viterbi(e, trans, start, np.int32(L))))
    s = float(tcrf.path_score(*_t(e, trans, start, path, mask)))
    assert abs(s - float(jcrf.path_score(e, trans, start, path, mask))) < 1e-5


def test_crf_inference_is_padding_invariant_and_batches():
    rng = np.random.default_rng(1)
    T, pad = 4, 12
    lengths = [4, 1, 9, 12]
    e = rng.normal(size=(len(lengths), pad, T)).astype(np.float32)
    trans = rng.normal(size=(T, T)).astype(np.float32)
    start = rng.normal(size=(T,)).astype(np.float32)
    mask = (np.arange(pad)[None] < np.array(lengths)[:, None]).astype(np.float32)
    logz_b = tcrf.log_partition(*_t(e, trans, start, mask)).numpy()
    paths = tcrf.viterbi(*_t(e, trans, start), torch.tensor(lengths)).numpy()
    for b, n in enumerate(lengths):
        one = float(tcrf.log_partition(*_t(e[b, :n], trans, start, np.ones(n, np.float32))))
        assert abs(logz_b[b] - one) < 1e-5
        jz = float(jcrf.log_partition(e[b], trans, start, mask[b]))
        assert abs(logz_b[b] - jz) < 1e-5
        alone = tcrf.viterbi(*_t(e[b, :n], trans, start), n).numpy()
        assert list(paths[b, :n]) == list(alone)
        assert list(alone) == list(np.asarray(jcrf.viterbi(e[b], trans, start, np.int32(n)))[:n])
    tags = rng.integers(0, T, (len(lengths), pad))
    got = tcrf.path_score(*_t(e, trans, start, tags, mask)).numpy()
    for b in range(len(lengths)):
        assert abs(got[b] - float(jcrf.path_score(e[b], trans, start, tags[b], mask[b]))) < 1e-5


def test_crf_viterbi_breaks_ties_at_the_first_index_as_jax():
    # integer scores: many equal candidates at every step
    rng = np.random.default_rng(5)
    for _ in range(20):
        e = rng.integers(0, 2, (6, 4)).astype(np.float32)
        trans = rng.integers(0, 2, (4, 4)).astype(np.float32)
        start = np.zeros(4, np.float32)
        want = np.asarray(jcrf.viterbi(e, trans, start, np.int32(6)))
        assert list(tcrf.viterbi(*_t(e, trans, start), 6).numpy()) == list(want)


def test_crf_encoding_and_buckets_equal_jax():
    sents = SENTENCES[:4] + [["café", "急", "x1"]]
    for fn in ("_emit_features", "_emit_ner_features"):
        got = tcrf._encode_many(sents, getattr(ttag, fn), 1 << 17)
        for toks, enc in zip(sents, got):
            np.testing.assert_array_equal(enc, jcrf._encode(toks, getattr(jtag, fn), 1 << 17))
    # the vectorized hash against the per-term loop
    terms = ["", "b", "w=café", "pt2=<s>|NN", "急", (1, 2), "x" * 50]
    assert [int(h) for h in tnlp.hashing_tf.stable_hashes(terms)] == \
        [tnlp.stable_hash(t) for t in terms]
    assert [tcrf._bucket(n) for n in (1, 8, 9, 113)] == [jcrf._bucket(n) for n in (1, 8, 9, 113)]
    names = ["B-ORG", "B-PER", "I-ORG", "I-PER", "O"]
    for a, b in zip(tcrf.bio_transition_mask(names), jcrf.bio_transition_mask(names)):
        np.testing.assert_array_equal(a, b)


# -- CRF training -----------------------------------------------------------------

# parameters after 5 epochs (below the first convergence check at epoch
# 9) against JAX's: float32 sums in another order and optax's against
# torch's rounding of Adam's formula; read 2e-5 absolute at most
ATOL_CRF_PARAMS, RTOL_CRF_PARAMS_NORM = 2e-4, 1e-4


@pytest.mark.parametrize("kind", ["ner", "pos"])
def test_crf_parameters_after_five_epochs_match_jax(kind):
    sents = _ner_corpus() if kind == "ner" else _pos_corpus()
    est = "CRFNEREstimator" if kind == "ner" else "CRFTaggerEstimator"
    kw = dict(n_epochs=5, hash_dim=1 << 12, batch_size=48, seed=3)
    got = getattr(tcrf, est)(device="cpu", **kw).fit(Dataset.from_items(sents))
    want = getattr(jcrf, est)(**kw).fit(JDataset.from_items(sents))
    assert got.tag_names == want.tag_names and got.kind == want.kind
    assert got.fit_stats["epochs"] == 5 and got.fit_stats["steps"] == 5 * -(-len(sents) // 48)
    for name in ("emit", "trans", "start"):
        a, b = getattr(got, name), getattr(want, name)
        allowed = np.abs(b) < 1e8  # the folded -1e9 BIO masks
        np.testing.assert_array_equal(a[~allowed], b[~allowed])
        np.testing.assert_allclose(a[allowed], b[allowed], rtol=0, atol=ATOL_CRF_PARAMS)
        assert np.linalg.norm(a[allowed] - b[allowed]) <= \
            RTOL_CRF_PARAMS_NORM * np.linalg.norm(b[allowed])


def _accuracy(tagger, sents):
    pred = tagger.decode([t for t, _ in sents]) if hasattr(tagger, "decode") else \
        [tagger(t) for t, _ in sents]
    ok = sum(p == g for ps, (_, gs) in zip(pred, sents) for p, g in zip(ps, gs))
    return ok / sum(len(g) for _, g in sents), pred


def _bio_valid(tags):
    prev = "O"
    for t in tags:
        if t.startswith("I-") and prev not in {"B-" + t[2:], "I-" + t[2:]}:
            return False
        prev = t
    return True


@pytest.mark.parametrize("kind", ["pos", "ner"])
def test_crf_full_fits_decode_like_jax(kind):
    """A full fit (to the convergence checks) on both sides: the decoded
    tags of the held-out sentences may differ on at most 1 % of tokens
    (the epoch of the discrete early stop and Adam's rounding may
    differ); both above the JAX tests' accuracy bars."""
    sents = _pos_corpus(200) if kind == "pos" else _ner_corpus(260)
    train, test = sents[:160], sents[160:]
    est = "CRFTaggerEstimator" if kind == "pos" else "CRFNEREstimator"
    got = getattr(tcrf, est)(n_epochs=60, hash_dim=1 << 12, device="cpu").fit(
        Dataset.from_items(train))
    want = getattr(jcrf, est)(n_epochs=60, hash_dim=1 << 12).fit(JDataset.from_items(train))
    acc, pred = _accuracy(got, test)
    jacc, jpred = _accuracy(want, test)
    assert acc > 0.97 and jacc > 0.97, (acc, jacc)
    differ = sum(p != q for ps, qs in zip(pred, jpred) for p, q in zip(ps, qs))
    assert differ <= 0.01 * sum(len(g) for _, g in test), differ
    if kind == "ner":
        assert all(_bio_valid(p) for p in pred)
    # the batched decode of apply_batch is the one-sentence decode
    one = [got(t) for t, _ in test[:15]]
    assert got.apply_batch(Dataset.from_items([t for t, _ in test[:15]])).items() == \
        [list(zip(t, p)) for (t, _), p in zip(test[:15], one)]
    node = (text.POSTagger if kind == "pos" else text.NER)(annotator=got)
    toks = test[0][0]
    out = node.apply(toks)
    assert [t for _, t in out] == got(toks) if kind == "pos" else out == got(toks)


def test_crf_ner_constrained_decode_is_always_bio_valid():
    train = [
        (["bob", "smith", "called"], ["B-PER", "I-PER", "O"]),
        (["acme", "corp", "grew"], ["B-ORG", "I-ORG", "O"]),
        (["she", "left"], ["O", "O"]),
    ]
    tagger = tcrf.CRFNEREstimator(n_epochs=20, hash_dim=1 << 10, device="cpu").fit(
        Dataset.from_items(train))
    rng = np.random.default_rng(5)
    vocab = ["bob", "corp", "zzq", "急", "x1", "—", "smith", "acme"]
    sents = [list(rng.choice(vocab, size=rng.integers(1, 9))) for _ in range(40)]
    for toks, tags in zip(sents, tagger.decode(sents)):
        assert _bio_valid(tags), (toks, tags)


def test_crf_tagger_pickles_and_rejects_bad_input():
    train = [(["the", "dog"], ["DT", "NN"]), (["a", "cat"], ["DT", "NN"])]
    tagger = tcrf.CRFTaggerEstimator(n_epochs=30, hash_dim=1 << 10, device="cpu").fit(
        Dataset.from_items(train))
    assert tagger(["the", "cat"]) == ["DT", "NN"]  # fills the table cache
    blob = pickle.dumps(tagger)
    clone = pickle.loads(blob)
    assert "_tables_cache" not in clone.__dict__ and "fit_stats" not in clone.__dict__
    assert clone(["the", "cat"]) == tagger(["the", "cat"]) == ["DT", "NN"]
    assert tagger([]) == [] and clone.apply([]) == []
    with pytest.raises(ValueError):
        tcrf.CRFTaggerEstimator(n_epochs=1, device="cpu").fit(Dataset.from_items([([], [])]))
    bad = [(["acme", "grew"], ["I-ORG", "O"])]
    with pytest.raises(ValueError, match="BIO"):
        tcrf.CRFNEREstimator(n_epochs=1, device="cpu").fit(Dataset.from_items(bad))
    loose = tcrf.CRFNEREstimator(n_epochs=5, hash_dim=1 << 10, constrain_bio=False,
                                 device="cpu").fit(Dataset.from_items(bad))
    assert len(loose(["acme", "grew"])) == 2
