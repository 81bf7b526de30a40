"""POS tagging, NER, and lemmatizing feature extraction (counterpart of
``keystone_tpu/ops/nlp/external.py``; host work over strings, as in the
JAX package).

Reference: nodes/nlp/POSTagger.scala:24, NER.scala:20 (pre-trained Epic
CRF/SemiCRF models broadcast to executors), CoreNLPFeatureExtractor
.scala:18 (sista processors tokenize/lemmatize/NER-replace + n-grams).
The Epic/CoreNLP JVM model libraries have no in-environment equivalent,
so these nodes default to the framework's own annotators (ops/nlp/
tagging.py: a trainable averaged-perceptron tagger via
``PerceptronTaggerEstimator``, plus rule-based POS/NER fallbacks) and
accept any callable annotator (a spaCy pipeline, a transformers
token-classification pipeline, or a trained ``_TrainedTagger``) in the
reference's pass-a-model style.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Optional, Sequence

from keystone_tpu_torch.ops.nlp.ngrams import NGramsFeaturizer
from keystone_tpu_torch.ops.nlp.tagging import rule_ner_tag, rule_pos_tag
from keystone_tpu_torch.workflow.api import Transformer


@dataclasses.dataclass(eq=False)
class POSTagger(Transformer):
    """tokens -> (token, tag) pairs. ``annotator`` maps a token list to
    per-token tags; defaults to the rule-based tagger (train a better one
    with ``PerceptronTaggerEstimator``)."""

    annotator: Optional[Callable[[Sequence[str]], Sequence[str]]] = None

    def apply(self, tokens: Sequence[str]):
        tags = (self.annotator or rule_pos_tag)(tokens)
        return list(zip(tokens, tags))


@dataclasses.dataclass(eq=False)
class NER(Transformer):
    """tokens -> per-token entity labels. Defaults to the heuristic
    capitalization/gazetteer annotator (tagging.rule_ner_tag)."""

    annotator: Optional[Callable[[Sequence[str]], Sequence[str]]] = None

    def apply(self, tokens: Sequence[str]):
        return list((self.annotator or rule_ner_tag)(tokens))


@dataclasses.dataclass(eq=False)
class CoreNLPFeatureExtractor(Transformer):
    """text -> n-grams over normalized tokens (reference:
    CoreNLPFeatureExtractor.scala — tokenize, lemmatize, replace NER
    entities with their types, then n-grams). Defaults: rule-based NER
    replacement (tagging.rule_ner_tag) + a light rule-based stemmer;
    pass ``lemmatizer``/``ner`` to swap in external annotators, or
    ``ner=False`` to disable entity replacement."""

    orders: Sequence[int] = (1, 2, 3)
    lemmatizer: Optional[Callable[[str], str]] = None
    ner: Any = None  # None=default rule_ner_tag | False=off | callable

    def _normalize(self, token: str) -> str:
        t = token.lower()
        if self.lemmatizer is not None:
            return self.lemmatizer(t)
        # light rule-based stemming fallback
        for suffix in ("ing", "ed", "es", "s"):
            if t.endswith(suffix) and len(t) > len(suffix) + 2:
                return t[: -len(suffix)]
        return t

    def apply(self, text: str):
        tokens = [t for t in re.split(r"[^\w]+", text) if t]
        ner = rule_ner_tag if self.ner is None else self.ner
        if ner:
            labels = ner(tokens)
            tokens = [
                lab if lab and lab != "O" else tok
                for tok, lab in zip(tokens, labels)
            ]
        tokens = [self._normalize(t) for t in tokens]
        return NGramsFeaturizer(self.orders).apply(tokens)
