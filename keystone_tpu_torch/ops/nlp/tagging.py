"""Built-in sequence taggers: a trainable averaged-perceptron POS tagger
and rule-based POS/NER fallbacks (counterpart of
``keystone_tpu/ops/nlp/tagging.py``, a faithful copy: host work over
strings and dicts, as in the JAX package, so it takes no device).

Reference: nodes/nlp/POSTagger.scala:24 and NER.scala:20 wrap pre-trained
Epic CRF/SemiCRF models (JVM-only, no in-environment equivalent). The
TPU-native framework ships its own trainable tagger instead: a greedy
averaged perceptron (Collins 2002-style structured perceptron with
averaged weights) fit by ``PerceptronTaggerEstimator`` from labeled
sentences — tagging is host-side string work here, like the rest of the
NLP layer; the heavy featurization downstream (hashing TF, n-grams) is
what rides the device.
"""

from __future__ import annotations

import dataclasses
import re
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.workflow.api import Estimator, Transformer


def _emit_features(tokens: Sequence[str], i: int) -> List[str]:
    """Tag-history-free feature strings for token ``i`` — local context +
    shape + affixes. This is the emission feature set shared with the CRF
    taggers (crf.py), which model tag history through their transition
    table instead of through features. Fixed length (8)."""
    w = tokens[i]
    lo = w.lower()
    before = tokens[i - 1].lower() if i > 0 else "<s>"
    after = tokens[i + 1].lower() if i + 1 < len(tokens) else "</s>"
    return [
        "b",  # bias
        "w=" + lo,
        "sfx3=" + lo[-3:],
        "sfx2=" + lo[-2:],
        "pfx1=" + lo[:1],
        "shape=" + (
            "d" if w.isdigit()
            else "C" if w[:1].isupper() and i > 0
            else "c" if w[:1].isupper()
            else "x"
        ),
        "pw=" + before,
        "nw=" + after,
    ]


def _features(
    tokens: Sequence[str], i: int, prev: str, prev2: str
) -> List[str]:
    """Feature strings for token ``i`` given the two previous predicted
    tags — the emission set plus tag-history conjunctions."""
    lo = tokens[i].lower()
    return _emit_features(tokens, i) + [
        "pt=" + prev,
        "pt2=" + prev2 + "|" + prev,
        "pt+w=" + prev + "|" + lo,
    ]


def _word_shape(w: str) -> str:
    """Collapsed character-class signature: "McDonald's" -> "CcCc'c"."""
    out = []
    for ch in w[:8]:
        c = (
            "C" if ch.isupper() else "c" if ch.islower()
            else "d" if ch.isdigit() else ch
        )
        if not out or out[-1] != c:
            out.append(c)
    return "".join(out)


def _emit_ner_features(tokens: Sequence[str], i: int) -> List[str]:
    """Tag-history-free window features for NER: identity + affixes +
    shape of a ±2 token window, and the same title/org-suffix/month cues
    the rule tagger keys on — learned weights decide how much to trust
    them. Shared with the CRF NER tagger (crf.py). Fixed length (19)."""
    w = tokens[i]
    lo = w.lower()
    before = tokens[i - 1] if i > 0 else "<s>"
    before2 = tokens[i - 2] if i > 1 else "<s>"
    after = tokens[i + 1] if i + 1 < len(tokens) else "</s>"
    after2 = tokens[i + 2] if i + 2 < len(tokens) else "</s>"
    return [
        "b",  # bias
        "w=" + lo,
        "sfx3=" + lo[-3:],
        "pfx2=" + lo[:2],
        "shape=" + _word_shape(w),
        "first" if i == 0 else "mid",
        "pw=" + before.lower(),
        "pshape=" + _word_shape(before),
        "p2w=" + before2.lower(),
        "nw=" + after.lower(),
        "nshape=" + _word_shape(after),
        "n2w=" + after2.lower(),
        "title" if lo.rstrip(".") in _TITLES else "notitle",
        "ptitle" if before.lower().rstrip(".") in _TITLES else "x",
        "orgsfx" if lo.rstrip(".") in _ORG_SUFFIX else "x",
        "norgsfx" if after.lower().rstrip(".") in _ORG_SUFFIX else "x",
        "month" if lo in _MONTHS else "x",
        "year" if re.fullmatch(r"(1[5-9]|20)\d\d", w) else "x",
        "num" if re.fullmatch(r"\d+([.,]\d+)*", w) else "x",
    ]


def _ner_features(
    tokens: Sequence[str], i: int, prev: str, prev2: str
) -> List[str]:
    """NER features for token ``i`` given the two previous predicted
    labels — the emission set plus label-history conjunctions."""
    lo = tokens[i].lower()
    return _emit_ner_features(tokens, i) + [
        "pt=" + prev,
        "pt2=" + prev2 + "|" + prev,
        "pt+w=" + prev + "|" + lo,
    ]


class AveragedPerceptron:
    """Multiclass perceptron with weight averaging (lazy accumulation:
    totals are updated with the timestamp delta at each weight change,
    so averaging costs O(#updates), not O(#steps * #weights))."""

    def __init__(self) -> None:
        self.weights: Dict[str, Dict[str, float]] = defaultdict(dict)
        self.classes: List[str] = []
        self._totals: Dict[Tuple[str, str], float] = defaultdict(float)
        self._stamps: Dict[Tuple[str, str], int] = defaultdict(int)
        self._step = 0

    def predict(self, feats: Sequence[str]) -> str:
        scores: Dict[str, float] = defaultdict(float)
        for f in feats:
            for tag, w in self.weights.get(f, {}).items():
                scores[tag] += w
        if not scores:
            return self.classes[0] if self.classes else "NN"
        # deterministic argmax: break score ties on tag name
        return max(self.classes, key=lambda t: (scores[t], t))

    def update(self, truth: str, guess: str, feats: Sequence[str]) -> None:
        self._step += 1
        if truth == guess:
            return
        for f in feats:
            for tag, delta in ((truth, 1.0), (guess, -1.0)):
                key = (f, tag)
                cur = self.weights[f].get(tag, 0.0)
                self._totals[key] += (self._step - self._stamps[key]) * cur
                self._stamps[key] = self._step
                self.weights[f][tag] = cur + delta

    def average(self) -> None:
        for f, tags in self.weights.items():
            for tag, w in tags.items():
                key = (f, tag)
                total = self._totals[key] + (self._step - self._stamps[key]) * w
                tags[tag] = total / max(self._step, 1)
        self._totals.clear()
        self._stamps.clear()

    def tag(self, tokens: Sequence[str], feature_fn=None) -> List[str]:
        ffn = feature_fn or _features
        prev, prev2 = "<s>", "<s>"
        out = []
        for i in range(len(tokens)):
            t = self.predict(ffn(tokens, i, prev, prev2))
            out.append(t)
            prev2, prev = prev, t
        return out


def _train_greedy(
    sentences: List[Tuple[List[str], List[str]]],
    n_iter: int,
    seed: int,
    feature_fn,
) -> AveragedPerceptron:
    """Greedy left-to-right averaged-perceptron training on predicted
    (not gold) previous tags, so train matches inference (shared by the
    POS and NER estimators — they differ only in the feature function)."""
    model = AveragedPerceptron()
    model.classes = sorted({t for _, tags in sentences for t in tags})
    rng = np.random.default_rng(seed)
    order = np.arange(len(sentences))
    for _ in range(n_iter):
        rng.shuffle(order)
        for si in order:
            tokens, gold = sentences[si]
            prev, prev2 = "<s>", "<s>"
            for i in range(len(tokens)):
                feats = feature_fn(tokens, i, prev, prev2)
                guess = model.predict(feats)
                model.update(gold[i], guess, feats)
                prev2, prev = prev, guess
    model.average()
    return model


@dataclasses.dataclass(eq=False)
class PerceptronTaggerEstimator(Estimator):
    """fit(Dataset of (tokens, tags) sentences) -> POSTagger with a
    trained averaged-perceptron annotator."""

    n_iter: int = 5
    seed: int = 0

    def fit(self, data: Dataset) -> "_TrainedTagger":
        sentences = [
            (list(toks), list(tags)) for toks, tags in data.items()
        ]
        return _TrainedTagger(
            _train_greedy(sentences, self.n_iter, self.seed, _features)
        )


@dataclasses.dataclass(eq=False)
class NEREstimator(Estimator):
    """fit(Dataset of (tokens, bio_tags) sentences) -> trained NER
    tagger — the trainable replacement for the reference's pre-trained
    Epic SemiCRF (nodes/nlp/NER.scala:20). Same averaged-perceptron
    machinery as the POS estimator with an entity feature set
    (``_ner_features``); ``rule_ner_tag`` stays the zero-data default
    annotator for ``NER()``. Tag scheme is whatever the training data
    uses (BIO recommended so entity boundaries survive round-trips)."""

    n_iter: int = 8
    seed: int = 0

    def fit(self, data: Dataset) -> "_TrainedTagger":
        sentences = [
            (list(toks), list(tags)) for toks, tags in data.items()
        ]
        return _TrainedTagger(
            _train_greedy(sentences, self.n_iter, self.seed, _ner_features),
            feature_fn=_ner_features,
        )


@dataclasses.dataclass(eq=False)
class _TrainedTagger(Transformer):
    """tokens -> (token, tag) pairs from a trained perceptron."""

    model: AveragedPerceptron
    feature_fn: Optional[object] = None  # default: POS `_features`

    def apply(self, tokens: Sequence[str]):
        return list(zip(tokens, self.model.tag(tokens, self.feature_fn)))

    def __call__(self, tokens: Sequence[str]) -> List[str]:
        """Usable directly as a ``POSTagger``/``NER`` ``annotator=``."""
        return self.model.tag(tokens, self.feature_fn)


_RULE_TAGS = [
    (re.compile(r"^\d+([.,]\d+)*$"), "CD"),
    (re.compile(r"^(the|a|an)$", re.I), "DT"),
    (re.compile(r"^(and|or|but|nor)$", re.I), "CC"),
    (re.compile(r"^(of|in|on|at|by|for|with|from|to|into|over|under)$",
                re.I), "IN"),
    (re.compile(r"^(i|you|he|she|it|we|they|me|him|her|us|them)$", re.I),
     "PRP"),
    (re.compile(r"^(is|are|was|were|be|been|am)$", re.I), "VBZ"),
    (re.compile(r".*ing$", re.I), "VBG"),
    (re.compile(r".*ed$", re.I), "VBD"),
    (re.compile(r".*ly$", re.I), "RB"),
    (re.compile(r".*(ous|ful|ive|able|ible|al|ic)$", re.I), "JJ"),
    (re.compile(r".*s$"), "NNS"),
]


def rule_pos_tag(tokens: Sequence[str]) -> List[str]:
    """Suffix/lexicon heuristic Penn-style tags — the zero-dependency
    default annotator (capitalized mid-sentence tokens -> NNP)."""
    out = []
    for i, w in enumerate(tokens):
        tag = None
        if i > 0 and w[:1].isupper():
            tag = "NNP"
        else:
            for pat, t in _RULE_TAGS:
                if pat.match(w):
                    tag = t
                    break
        out.append(tag or "NN")
    return out


_TITLES = {"mr", "mrs", "ms", "dr", "prof", "president", "sen", "gov"}
_ORG_SUFFIX = {"inc", "corp", "ltd", "llc", "co", "university", "institute"}
_MONTHS = {
    "january", "february", "march", "april", "may", "june", "july",
    "august", "september", "october", "november", "december",
}


def rule_ner_tag(tokens: Sequence[str]) -> List[str]:
    """Heuristic entity labels (PERSON/ORG/DATE/NUMBER/ENTITY/O): runs of
    capitalized tokens form entities; titles mark PERSON, corporate
    suffixes ORG, months/years DATE — the zero-dependency default."""
    n = len(tokens)
    labels = ["O"] * n
    i = 0
    while i < n:
        w = tokens[i]
        lo = w.lower().rstrip(".")
        if re.fullmatch(r"(1[5-9]|20)\d\d", w) or lo in _MONTHS:
            labels[i] = "DATE"
            i += 1
            continue
        if re.fullmatch(r"\d+([.,]\d+)*", w):
            labels[i] = "NUMBER"
            i += 1
            continue
        if w[:1].isupper() and (i > 0 or lo in _TITLES):
            j = i
            while j < n and tokens[j][:1].isupper():
                j += 1
            span_los = [t.lower().rstrip(".") for t in tokens[i:j]]
            kind = "ENTITY"
            if span_los[0] in _TITLES:
                kind = "PERSON"
                # a title binds across an optional "." to the name run:
                # "Dr . Smith" / "Dr. Smith Jones"
                jj = j
                if jj < n and tokens[jj] == ".":
                    jj += 1
                while jj < n and tokens[jj][:1].isupper():
                    labels[jj] = "PERSON"
                    jj += 1
                    j = jj
            elif span_los[-1] in _ORG_SUFFIX:
                kind = "ORG"
            for k in range(i, min(j, n)):
                if labels[k] == "O":
                    labels[k] = kind
            i = j
            continue
        i += 1
    return labels
