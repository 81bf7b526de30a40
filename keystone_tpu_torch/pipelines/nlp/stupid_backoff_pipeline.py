"""StupidBackoffPipeline — n-gram language model estimation (counterpart
of ``keystone_tpu/pipelines/nlp/stupid_backoff_pipeline.py``). Host work
from end to end, as in the JAX package: strings, n-gram tuples and dicts
of counts, so it takes no device.

Reference: pipelines/nlp/StupidBackoffPipeline.scala:13-40 — tokens ->
WordFrequencyEncoder -> NGramsFeaturizer -> NGramsCounts ->
StupidBackoffEstimator.

    python -m keystone_tpu_torch StupidBackoffPipeline --trainLocation corpus.txt
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

from keystone_tpu_torch.ops.nlp import (
    NGramsCounts,
    NGramsFeaturizer,
    StupidBackoffEstimator,
    Tokenizer,
    WordFrequencyEncoder,
)
from keystone_tpu_torch.parallel.dataset import Dataset


@dataclasses.dataclass
class StupidBackoffConfig:
    train_location: str = ""
    n: int = 3


def run(text: Dataset, conf: StupidBackoffConfig):
    """Returns the fitted StupidBackoffModel over frequency-encoded
    tokens, and the encoder."""
    tokens = Tokenizer().apply_batch(text)
    encoder = WordFrequencyEncoder().fit(tokens)
    encoded = encoder.apply_batch(tokens)
    ngrams = NGramsFeaturizer(range(2, conf.n + 1)).apply_batch(encoded)
    counts = NGramsCounts("noAdd").apply(ngrams)
    model = StupidBackoffEstimator(encoder.unigram_counts).fit(counts)
    return model, encoder


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="StupidBackoffPipeline")
    p.add_argument("--trainLocation", required=True)
    p.add_argument("--n", type=int, default=3)
    a = p.parse_args(argv)
    with open(a.trainLocation) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    model, _ = run(
        Dataset.from_items(lines), StupidBackoffConfig(a.trainLocation, a.n)
    )
    print(f"model over {model.num_tokens} tokens, alpha={model.alpha}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
