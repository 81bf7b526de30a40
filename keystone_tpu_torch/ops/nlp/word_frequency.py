"""Frequency-rank word encoding (counterpart of
``keystone_tpu/ops/nlp/word_frequency.py``). Host work, as in the JAX
package.

Reference: nodes/nlp/WordFrequencyEncoder.scala:7,43 — unigram counts
sorted descending give each word its rank index; out-of-vocabulary maps
to -1. Equal counts keep the order in which the ``Counter`` first saw
their words (``sorted`` is stable), so the ranks of ties are part of the
result.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, Sequence

from keystone_tpu_torch.ops.nlp.string_utils import HostTextTransformer
from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.workflow.api import Estimator

OOV_INDEX = -1


@dataclasses.dataclass(eq=False)
class WordFrequencyTransformer(HostTextTransformer):
    word_index: Dict[str, int]
    unigram_counts: Dict[int, int]  # rank index -> count

    def apply(self, words: Sequence[str]):
        return [self.word_index.get(w, OOV_INDEX) for w in words]

    def eq_key(self):
        return ("word_frequency_transformer", id(self.word_index))


class WordFrequencyEncoder(Estimator):
    def fit(self, data: Dataset) -> WordFrequencyTransformer:
        counts: Counter = Counter()
        for tokens in data.items():
            counts.update(tokens)
        ordered = sorted(counts.items(), key=lambda kv: -kv[1])
        word_index = {w: i for i, (w, _) in enumerate(ordered)}
        unigrams = {i: c for i, (_, c) in enumerate(ordered)}
        return WordFrequencyTransformer(word_index, unigrams)

    def eq_key(self):
        return ("word_frequency_encoder", id(self))
