"""DAISY dense descriptors (Tola et al.), counterpart of
``keystone_tpu/ops/images/daisy.py``, batched over images of one size.

Reference: nodes/images/DaisyExtractor.scala:28 — oriented half-rectified
gradient layers, cascaded Gaussian blurs per ring (sigma differences
derived from daisyR/daisyQ), histogram sampling at ring points around
each grid keypoint, per-histogram L2 normalization with a zero threshold.
Output: (daisyFeatureSize, numKeypoints) matrix, matching the SIFT
orientation convention.

The separable convolutions are ``F.conv1d`` over rows with the
reference's asymmetric zero padding (``F.pad`` first); every orientation
plane of every image goes through one call per axis. Images of several
sizes run one batch per size. Tensor work runs on ``device`` (``None``
means ``cuda``, raising without it; resolving it turns cuDNN's TF32 off).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from keystone_tpu_torch._device import resolve_device
from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.workflow.api import Transformer


def _conv2d_same(img2d: torch.Tensor, kx: Sequence[float], ky: Sequence[float]) -> torch.Tensor:
    """Separable same-size cross-correlation of (..., X, Y) planes with the
    reference's asymmetric zero padding (ImageUtils.conv2D): ``kx`` along
    X, then ``ky`` along Y. The taps take the image's dtype."""

    def conv_axis(x, k, axis):
        k = torch.as_tensor(np.asarray(k, np.float32), device=x.device).to(x.dtype)
        pad_low = (len(k) - 1) // 2
        pad_high = len(k) - 1 - pad_low
        moved = x.movedim(axis, -1)
        shape = moved.shape
        flat = F.pad(moved.reshape(-1, 1, shape[-1]), (pad_low, pad_high))
        return F.conv1d(flat, k[None, None, :]).reshape(shape).movedim(-1, axis)

    return conv_axis(conv_axis(img2d, kx, -2), ky, -1)


@dataclasses.dataclass(eq=False)
class DaisyExtractor(Transformer):
    daisy_t: int = 8  # angles per ring
    daisy_q: int = 3  # rings
    daisy_r: int = 7  # outer radius
    daisy_h: int = 8  # orientation histograms
    pixel_border: int = 16
    stride: int = 4
    patch_size: int = 24
    feature_threshold: float = 1e-8
    conv_threshold: float = 1e-6
    device: Optional[str] = None

    def __post_init__(self):
        q, r = self.daisy_q, self.daisy_r
        sigma_sq = [(r * n / (2 * q)) ** 2 for n in range(q + 1)]
        self._sigma_sq_diff = [
            b - a for a, b in zip(sigma_sq, sigma_sq[1:])
        ]
        self._g: List[np.ndarray] = []
        for t in self._sigma_sq_diff:
            half = int(
                math.ceil(
                    math.sqrt(
                        -2 * t * math.log(self.conv_threshold)
                        - t * math.log(2 * math.pi * t)
                    )
                )
            )
            ns = np.arange(-half, half + 1)
            self._g.append(
                np.exp(-(ns**2) / (2 * t)) / math.sqrt(2 * math.pi * t)
            )

    @property
    def daisy_feature_size(self) -> int:
        return self.daisy_h * (self.daisy_t * self.daisy_q + 1)

    def apply(self, img):
        return self.extract(torch.as_tensor(img)[None])[0]

    def apply_batch(self, ds: Dataset) -> Dataset:
        if not ds.is_array:  # images of several sizes: one batch per size
            return self._bucketed_batch(ds)
        return Dataset.from_array(self.extract(ds.padded()), n=ds.n)

    def extract(self, imgs: torch.Tensor) -> torch.Tensor:
        """(B, X, Y) or (B, X, Y, C) images (channel 0 is used) ->
        (B, daisyFeatureSize, numKeypoints)."""
        x = torch.as_tensor(imgs).to(device=resolve_device(self.device), dtype=torch.float32)
        if x.dim() == 4:
            x = x[..., 0]
        H, Q, T = self.daisy_h, self.daisy_q, self.daisy_t
        B, X, Y = x.shape
        ix = _conv2d_same(x, [1.0, 0.0, -1.0], [1.0, 2.0, 1.0])
        iy = _conv2d_same(x, [1.0, 2.0, 1.0], [1.0, 0.0, -1.0])

        # oriented half-rectified planes, cascade-blurred per ring:
        # layers[level] is (B, H, X, Y)
        planes = torch.stack([
            torch.clamp(math.cos(2 * math.pi * a / H) * ix
                        + math.sin(2 * math.pi * a / H) * iy, min=0.0)
            for a in range(H)
        ], dim=1)
        layers = [_conv2d_same(planes, self._g[0], self._g[0])]
        for level in range(1, Q):
            layers.append(_conv2d_same(layers[-1], self._g[level], self._g[level]))

        kx = np.arange(self.pixel_border, X - self.pixel_border, self.stride)
        ky = np.arange(self.pixel_border, Y - self.pixel_border, self.stride)
        gx, gy = np.meshgrid(kx, ky, indexing="ij")  # (nx, ny)
        gxf = torch.as_tensor(gx.reshape(-1), device=x.device)
        gyf = torch.as_tensor(gy.reshape(-1), device=x.device)

        def norm_hist(h):
            # (B, H, n_keys) L2-normalized over H, with a zero threshold
            nrm = torch.linalg.vector_norm(h, dim=1, keepdim=True)
            return torch.where(nrm > self.feature_threshold, h / nrm, 0.0)

        blocks = [None] * (1 + T * Q)
        blocks[0] = norm_hist(layers[0][:, :, gxf, gyf])
        for level in range(Q):
            cur_rad = self.daisy_r * (1 + level) / Q
            for a in range(T):
                theta = 2 * math.pi * (a - 1) / T
                ox = int(round(cur_rad * math.sin(theta)))
                oy = int(round(cur_rad * math.cos(theta)))
                # column block H + a·Q·H + level·H
                blocks[1 + a * Q + level] = norm_hist(layers[level][:, :, gxf + ox, gyf + oy])
        return torch.cat(blocks, dim=1)  # (B, daisyFeatureSize, numKeypoints)
