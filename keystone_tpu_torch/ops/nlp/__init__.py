"""Text nodes (counterpart of ``keystone_tpu/ops/nlp``): string
preprocessing, n-grams, hashed term frequencies, word-frequency encoding,
stupid backoff, the perceptron and rule taggers, the external-NLP nodes
and the linear-chain CRF taggers."""

from keystone_tpu_torch.ops.nlp.string_utils import LowerCase, Tokenizer, Trim
from keystone_tpu_torch.ops.nlp.ngrams import NGram, NGramsCounts, NGramsFeaturizer
from keystone_tpu_torch.ops.nlp.hashing_tf import (
    FusedTextHashTF,
    HashingTF,
    NGramsHashingTF,
    stable_hash,
)
from keystone_tpu_torch.ops.nlp.external import (
    NER,
    CoreNLPFeatureExtractor,
    POSTagger,
)
from keystone_tpu_torch.ops.nlp.tagging import (
    NEREstimator,
    PerceptronTaggerEstimator,
    rule_ner_tag,
    rule_pos_tag,
)
from keystone_tpu_torch.ops.nlp.crf import (
    CRFNEREstimator,
    CRFTaggerEstimator,
)
from keystone_tpu_torch.ops.nlp.word_frequency import (
    WordFrequencyEncoder,
    WordFrequencyTransformer,
)
from keystone_tpu_torch.ops.nlp.stupid_backoff import (
    NaiveBitPackIndexer,
    NGramIndexer,
    StupidBackoffEstimator,
    StupidBackoffModel,
    initial_bigram_partition,
)

__all__ = [
    "CRFNEREstimator",
    "CRFTaggerEstimator",
    "FusedTextHashTF",
    "HashingTF",
    "LowerCase",
    "NGram",
    "NGramIndexer",
    "NGramsCounts",
    "NGramsFeaturizer",
    "NER",
    "NGramsHashingTF",
    "POSTagger",
    "NEREstimator",
    "PerceptronTaggerEstimator",
    "CoreNLPFeatureExtractor",
    "NaiveBitPackIndexer",
    "StupidBackoffEstimator",
    "StupidBackoffModel",
    "Tokenizer",
    "Trim",
    "WordFrequencyEncoder",
    "WordFrequencyTransformer",
    "initial_bigram_partition",
    "rule_ner_tag",
    "rule_pos_tag",
    "stable_hash",
]
