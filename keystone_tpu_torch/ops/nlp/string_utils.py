"""String preprocessing transformers (counterpart of
``keystone_tpu/ops/nlp/string_utils.py``).

Reference: nodes/nlp/StringUtils.scala:13,20,28 — regex tokenizer, trim,
lowercase. Host-side ops over items-mode datasets, mapped with the cyclic
garbage collector paused (``utils/gcpause.py``).
"""

from __future__ import annotations

import dataclasses
import re

from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.utils.gcpause import gc_paused
from keystone_tpu_torch.workflow.api import Transformer


class HostTextTransformer(Transformer):
    """A per-document host function, mapped over a dataset's items with the
    cyclic garbage collector paused."""

    def apply_batch(self, ds: Dataset) -> Dataset:
        with gc_paused():
            return ds.map(self.apply)


@dataclasses.dataclass(eq=False)
class Tokenizer(HostTextTransformer):
    """Split on a delimiting regex (default: non-word characters, the
    reference's ``[\\p{Punct}\\s]+``), with Scala ``String.split``'s
    semantics (StringUtilsSuite "tokenizer"): a string that starts with a
    separator yields a leading empty token, which the TF and vocabulary
    nodes then count as a term; all trailing empty tokens are removed, so
    a separator-only string yields ``[]``; and when no separator matches
    the string comes back whole, so ``""`` tokenizes to ``[""]``."""

    sep: str = r"[^\w]+"

    def apply(self, s: str):
        parts = re.split(self.sep, s)
        if len(parts) == 1:
            return parts  # no separator matched: the whole string, as is
        while parts and parts[-1] == "":
            parts.pop()
        return parts

    def eq_key(self):
        return ("tokenizer", self.sep)


class Trim(HostTextTransformer):
    def apply(self, s: str) -> str:
        return s.strip()

    def eq_key(self):
        return ("trim",)


class LowerCase(HostTextTransformer):
    def apply(self, s: str) -> str:
        return s.lower()

    def eq_key(self):
        return ("lower_case",)
