"""Text nodes (counterpart of ``keystone_tpu/ops/nlp``): string
preprocessing, n-grams and hashed term frequencies. The taggers, the CRF,
the external NLP nodes and stupid backoff are not ported yet."""

from keystone_tpu_torch.ops.nlp.hashing_tf import (
    FusedTextHashTF,
    HashingTF,
    NGramsHashingTF,
    stable_hash,
)
from keystone_tpu_torch.ops.nlp.ngrams import NGram, NGramsCounts, NGramsFeaturizer
from keystone_tpu_torch.ops.nlp.string_utils import LowerCase, Tokenizer, Trim

__all__ = [
    "FusedTextHashTF",
    "HashingTF",
    "LowerCase",
    "NGram",
    "NGramsCounts",
    "NGramsFeaturizer",
    "NGramsHashingTF",
    "Tokenizer",
    "Trim",
    "stable_hash",
]
