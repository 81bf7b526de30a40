"""N-gram extraction and counting (counterpart of
``keystone_tpu/ops/nlp/ngrams.py``).

Reference: nodes/nlp/ngrams.scala — NGramsFeaturizer (consecutive orders,
:20), NGram (hashable token-sequence key, :100), NGramsCounts
(partition-local counting + reduceByKey + descending sort, :152). A host
``Counter`` is the shuffle-free equivalent.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import List, Sequence, Tuple

from keystone_tpu_torch.ops.nlp.string_utils import HostTextTransformer
from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.workflow.api import FunctionNode


class NGram(tuple):
    """Hashable n-gram key (reference: ngrams.scala:100, a thin wrapper with
    sane equals/hashCode; a tuple already has both). It pickles as a
    tuple subclass, so a feature index keyed by n-grams survives
    ``FittedPipeline.save``."""

    @property
    def words(self) -> Tuple:
        return tuple(self)

    def __repr__(self) -> str:
        return f"[{','.join(str(w) for w in self)}]"


@dataclasses.dataclass(eq=False)
class NGramsFeaturizer(HostTextTransformer):
    """token sequence -> every n-gram of the given consecutive orders, in
    the reference's order: for each start position, the lowest order
    first, then its extensions (ngrams.scala:20-95)."""

    orders: Sequence[int]

    def __post_init__(self):
        orders = list(self.orders)
        if min(orders) < 1:
            raise ValueError(f"minimum order is not >= 1: {min(orders)}")
        for a, b in zip(orders, orders[1:]):
            if b != a + 1:
                raise ValueError(f"orders are not consecutive: {orders}")

    def apply(self, tokens: Sequence) -> List[List]:
        lo = min(self.orders)
        hi = max(self.orders)
        toks = list(tokens)  # one copy; list slices below are fresh lists
        out: List[List] = []
        append = out.append
        n = len(toks)
        for i in range(n - lo + 1):
            top = i + min(hi, n - i)
            for j in range(i + lo, top + 1):
                append(toks[i:j])
        return out

    def eq_key(self):
        return ("ngrams_featurizer", tuple(self.orders))


class NGramsCounts(FunctionNode):
    """Dataset of per-line n-gram lists -> (NGram, count) pairs, sorted by
    descending count in mode ``default`` (ties in first-seen order), in
    first-seen order in mode ``noAdd`` (reference: ngrams.scala:152)."""

    def __init__(self, mode: str = "default"):
        if mode not in ("default", "noAdd"):
            raise ValueError("`mode` must be `default` or `noAdd`")
        self.mode = mode

    def apply(self, data) -> Dataset:
        ds = Dataset.of(data)
        counts: Counter = Counter()
        for line in ds.items():
            for gram in line:
                counts[NGram(gram)] += 1
        if self.mode == "default":
            items = sorted(counts.items(), key=lambda kv: -kv[1])
        else:
            items = list(counts.items())
        return Dataset.from_items(items)
