"""Cacher — identity transformer that materializes its input (counterpart
of ``keystone_tpu/ops/util/cacher.py``). It also marks a prefix worth
keeping in the pipeline environment's saved state
(``workflow/rules.py`` ``ExtractSaveablePrefixes``)."""

from __future__ import annotations

import dataclasses
from typing import Any

from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.workflow.api import Transformer


@dataclasses.dataclass(eq=False)
class Cacher(Transformer):
    name: str = ""

    def apply(self, x: Any) -> Any:
        return x

    def apply_batch(self, ds: Dataset) -> Dataset:
        return ds.cache()

    def eq_key(self):
        return ("cacher", self.name, id(self) if not self.name else None)
