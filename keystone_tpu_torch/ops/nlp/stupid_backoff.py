"""Stupid Backoff n-gram language model (Brants et al. 2007), counterpart
of ``keystone_tpu/ops/nlp/stupid_backoff.py``. Host work, as in the JAX
package: counts live in dicts of Python ints.

Reference: nodes/nlp/StupidBackoff.scala:25,96,147 and indexers.scala:58,
135. Score (unnormalized):
    S(w_i | context) = freq(ngram)/freq(context)  if freq(ngram) > 0
                       alpha * S(w_i | shorter context)  otherwise
with the unigram base case freq(w)/numTokens.

The reference partitions ngrams by their first two words
(InitialBigramPartitioner) so backoff lookups stay partition-local;
``initial_bigram_partition`` reproduces that assignment, while the
in-memory model uses one host hash map. ``NaiveBitPackIndexer`` packs up
to 62 bits into a Python int (no fixed-width integer type is involved).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

from keystone_tpu_torch.ops.nlp.hashing_tf import stable_hash
from keystone_tpu_torch.ops.nlp.ngrams import NGram
from keystone_tpu_torch.ops.nlp.string_utils import HostTextTransformer
from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.workflow.api import Estimator


class NGramIndexer:
    """Tuple-backed backoff indexer (reference: NGramIndexerImpl,
    indexers.scala:135)."""

    min_ngram_order = 1
    max_ngram_order = 5

    def pack(self, words: Sequence) -> NGram:
        return NGram(words)

    def unpack(self, ngram: NGram, pos: int):
        return ngram[pos]

    def remove_farthest_word(self, ngram: NGram) -> NGram:
        return NGram(ngram[1:])

    def remove_current_word(self, ngram: NGram) -> NGram:
        return NGram(ngram[:-1])

    def ngram_order(self, ngram: NGram) -> int:
        return len(ngram)


class NaiveBitPackIndexer:
    """Packs up to trigrams of word ids < 2^20 into one int (reference:
    indexers.scala:58 — same layout: [4 control bits][farthest]...[curr],
    left-aligned)."""

    min_ngram_order = 1
    max_ngram_order = 3

    def pack(self, ngram: Sequence[int]) -> int:
        for w in ngram:
            if w >= 1 << 20:
                raise ValueError("word id must be < 2^20")
        n = len(ngram)
        if n == 1:
            return ngram[0] << 40
        if n == 2:
            return (ngram[1] << 20) | (ngram[0] << 40) | (1 << 60)
        if n == 3:
            return (
                ngram[2] | (ngram[1] << 20) | (ngram[0] << 40) | (1 << 61)
            )
        raise ValueError("ngram order must be in {1, 2, 3}")

    def unpack(self, ngram: int, pos: int) -> int:
        if pos == 0:
            return (ngram >> 40) & ((1 << 20) - 1)
        if pos == 1:
            return (ngram >> 20) & ((1 << 20) - 1)
        if pos == 2:
            return ngram & ((1 << 20) - 1)
        raise ValueError("pos must be in {0, 1, 2}")

    def ngram_order(self, ngram: int) -> int:
        order = (ngram & (0xF << 60)) >> 60
        if not (self.min_ngram_order <= order + 1 <= self.max_ngram_order):
            raise ValueError(f"invalid control bits {order}")
        return order + 1

    def remove_farthest_word(self, ngram: int) -> int:
        order = self.ngram_order(ngram)
        cleared = ngram & (0xF << 60)
        stripped = ngram & ((1 << 40) - 1)
        shifted = ((stripped << 20) | cleared) & ~(0xF << 60)
        if order == 2:
            return shifted
        if order == 3:
            return shifted | (1 << 60)
        raise ValueError(f"unsupported order {order}")

    def remove_current_word(self, ngram: int) -> int:
        order = self.ngram_order(ngram)
        if order == 2:
            return (ngram & ~((1 << 40) - 1)) & ~(0xF << 60)
        if order == 3:
            return ((ngram & ~((1 << 20) - 1)) & ~(0xF << 60)) | (1 << 60)
        raise ValueError(f"unsupported order {order}")


def initial_bigram_partition(
    ngram: NGram, num_partitions: int, indexer: NGramIndexer = None
) -> int:
    """Partition by a hash of the first two (context) words (reference:
    InitialBigramPartitioner, StupidBackoff.scala:25-58)."""
    indexer = indexer or NGramIndexer()
    if indexer.ngram_order(ngram) > 1:
        h = stable_hash(
            (indexer.unpack(ngram, 0), indexer.unpack(ngram, 1))
        )
        return h % num_partitions
    return 0


@dataclasses.dataclass(eq=False)
class StupidBackoffModel(HostTextTransformer):
    ngram_counts: Dict[NGram, int]
    unigram_counts: Dict[object, int]
    num_tokens: int
    alpha: float = 0.4

    def __post_init__(self):
        self._indexer = NGramIndexer()

    def score(self, ngram) -> float:
        ngram = NGram(ngram)
        return self._score(1.0, ngram, self.ngram_counts.get(ngram, 0))

    def _score(self, accum: float, ngram: NGram, freq: int) -> float:
        idx = self._indexer
        order = idx.ngram_order(ngram)
        if order == 1:
            return accum * freq / self.num_tokens
        if freq != 0:
            context = idx.remove_current_word(ngram)
            if order != 2:
                context_freq = self.ngram_counts.get(context, 0)
            else:
                context_freq = self.unigram_counts.get(
                    idx.unpack(context, 0), 0
                )
            return accum * freq / context_freq
        backoffed = idx.remove_farthest_word(ngram)
        if idx.ngram_order(backoffed) != 1:
            freq2 = self.ngram_counts.get(backoffed, 0)
        else:
            freq2 = self.unigram_counts.get(idx.unpack(backoffed, 0), 0)
        return self._score(self.alpha * accum, backoffed, freq2)

    def apply(self, ngram):
        return self.score(ngram)

    def eq_key(self):
        return ("stupid_backoff_model", id(self.ngram_counts), self.alpha)


@dataclasses.dataclass(eq=False)
class StupidBackoffEstimator(Estimator):
    """fit(Dataset of (NGram, count) pairs) -> StupidBackoffModel
    (reference: StupidBackoffEstimator — unigram counts come in
    separately)."""

    unigram_counts: Dict[object, int]
    alpha: float = 0.4

    def fit(self, data: Dataset) -> StupidBackoffModel:
        ngram_counts = {NGram(k): v for k, v in data.items()}
        num_tokens = sum(self.unigram_counts.values())
        return StupidBackoffModel(
            ngram_counts, self.unigram_counts, num_tokens, self.alpha
        )

    def eq_key(self):
        return ("stupid_backoff", id(self.unigram_counts), self.alpha)
