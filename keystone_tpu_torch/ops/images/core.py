"""Image preprocessing nodes on the flagship path (counterpart of
``keystone_tpu/ops/images/core.py``: ``PixelScaler`` and ``GrayScaler``).
Images are ``(X, Y, C)``; batches ``(B, X, Y, C)``; an items-mode dataset
of images of several sizes runs one batch per size."""

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
        if not ds.is_array:
            return self._bucketed_batch(ds)
        return Dataset.from_array(self.apply(ds.padded()), n=ds.n)

    def eq_key(self):
        return ("pixel_scaler",)


class GrayScaler(Transformer):
    """RGB -> single-channel grayscale with MATLAB rgb2gray weights."""

    def weights(self, device) -> torch.Tensor:
        """The (3,) weights on ``device``, made once per device: a
        dispatch copies nothing from the host (a CUDA graph capture
        refuses a host-to-device copy)."""
        cache = self.__dict__.setdefault("_weight_cache", {})
        w = cache.get(str(device))
        if w is None:
            w = cache[str(device)] = torch.tensor(
                GRAYSCALE_WEIGHTS, dtype=torch.float32, device=device
            )
        return w

    def apply(self, img):
        return (img.to(torch.float32) @ self.weights(img.device))[..., None]

    def apply_batch(self, ds: Dataset) -> Dataset:
        if not ds.is_array:
            return self._bucketed_batch(ds)
        return Dataset.from_array(self.apply(ds.padded()), n=ds.n)

    def eq_key(self):
        return ("gray_scaler",)
