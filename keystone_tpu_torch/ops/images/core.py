"""Image preprocessing nodes on the flagship path (counterpart of
``keystone_tpu/ops/images/core.py``: ``PixelScaler`` and ``GrayScaler``).
Images are ``(X, Y, C)``; batches ``(B, X, Y, C)``."""

from __future__ import annotations

import torch

from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.workflow.api import Transformer

GRAYSCALE_WEIGHTS = (0.2989, 0.5870, 0.1140)


class PixelScaler(Transformer):
    """x / 255."""

    def apply(self, img):
        return img.to(torch.float32) / 255.0

    def apply_batch(self, ds: Dataset) -> Dataset:
        return Dataset.from_array(self.apply(ds.padded()), n=ds.n)

    def eq_key(self):
        return ("pixel_scaler",)


class GrayScaler(Transformer):
    """RGB -> single-channel grayscale with MATLAB rgb2gray weights."""

    def apply(self, img):
        w = torch.tensor(GRAYSCALE_WEIGHTS, dtype=torch.float32, device=img.device)
        return (img.to(torch.float32) @ w)[..., None]

    def apply_batch(self, ds: Dataset) -> Dataset:
        return Dataset.from_array(self.apply(ds.padded()), n=ds.n)

    def eq_key(self):
        return ("gray_scaler",)
