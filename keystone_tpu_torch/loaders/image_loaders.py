"""Labeled images and their extractors (counterpart of
``keystone_tpu/loaders/image_loaders.py``: ``LabeledImage``,
``ImageExtractor``, ``LabelExtractor`` and ``NUM_IMAGENET_CLASSES``; the
tar-archive loaders wait for the port of ``loaders/*``).

Images are ``(x=row, y=col, c)`` arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from keystone_tpu_torch.parallel.dataset import Dataset

NUM_IMAGENET_CLASSES = 1000


@dataclasses.dataclass
class LabeledImage:
    image: np.ndarray
    label: int
    filename: str = ""


class ImageExtractor:
    """LabeledImage dataset -> image dataset (items mode, on the host)."""

    @staticmethod
    def apply(ds: Dataset) -> Dataset:
        return ds.map(lambda li: li.image)

    def __call__(self, ds: Dataset) -> Dataset:
        return self.apply(ds)


class LabelExtractor:
    """LabeledImage dataset -> (n,) int32 label array (on the host)."""

    @staticmethod
    def apply(ds: Dataset) -> Dataset:
        return Dataset.from_array(
            torch.as_tensor(np.asarray([li.label for li in ds.items()], np.int32))
        )

    def __call__(self, ds: Dataset) -> Dataset:
        return self.apply(ds)
