"""Dense multi-scale SIFT, batched over images (counterpart of
``keystone_tpu/ops/images/sift.py``; see there for the vl_dsift spec).

Per scale s: bin size = bin + 2s, Gaussian pre-smoothing with sigma =
binSize / 6, sampling bounds offset (1 + 2·numScales) − 3s, step = step +
s·scaleStep, contrast-threshold 0.005 zeroing, descriptors scaled ×512,
floored and clamped to 255. The spatial-binning stage (triangular
convolution → bin-center sample → Gaussian window) is two sampling
matrices applied as products, fused with the trilinear orientation binning
in the ``sift_bin_sample`` kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from keystone_tpu_torch.ops.images.kernels import sift_bands, sift_bin_sample
from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.workflow.api import Transformer

NUM_ORIENTATIONS = 8
NUM_SPATIAL_BINS = 4
DESCRIPTOR_DIMS = 128
MAGNIF = 6.0
CONTRAST_THRESHOLD = 0.005
WINDOW_SIZE = 1.5


def _gaussian_kernel(sigma: float) -> np.ndarray:
    """vl_imsmooth-style truncated Gaussian (radius ceil(4 sigma))."""
    if sigma < 1e-8:
        return np.ones(1, np.float32)
    r = int(np.ceil(4.0 * sigma))
    xs = np.arange(-r, r + 1)
    k = np.exp(-(xs**2) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _sep_conv2d(planes: torch.Tensor, k) -> torch.Tensor:
    """Separable same-size conv of (P, H, W) planes with a 1-D kernel
    (numpy or tensor), borders replicated (vl_imsmooth's continuity
    padding)."""
    kt = torch.as_tensor(k, device=planes.device).view(1, 1, -1)
    pad = (len(k) - 1) // 2

    def conv1d(x, axis):
        moved = x.movedim(axis, -1)
        shape = moved.shape
        flat = moved.reshape(-1, 1, shape[-1])
        if pad > 0:
            flat = F.pad(flat, (pad, pad), mode="replicate")
        out = F.conv1d(flat, kt)
        return out.reshape(shape[:-1] + (out.shape[-1],)).movedim(-1, axis)

    return conv1d(conv1d(planes, 1), 2)


def _window_factors(bin_size: int) -> np.ndarray:
    """Per-bin Gaussian window factor at bin centers."""
    centers = (
        np.arange(NUM_SPATIAL_BINS) - (NUM_SPATIAL_BINS - 1) / 2.0
    ) * bin_size
    sigma = WINDOW_SIZE * bin_size
    return np.exp(-0.5 * (centers / sigma) ** 2).astype(np.float32)


def _sampling_matrix(
    n: int, nf: int, bin_size: int, step: int, bound: int
) -> np.ndarray:
    """(n, nf·4) one-axis spatial-binning operator: column f·4+j holds the
    triangular kernel tri(d) = max(0, (bin−|d|)/bin) centered at bound +
    f·step + j·bin (zero outside the image), scaled by the window factor
    wf[j]."""
    wf = _window_factors(bin_size)
    m = np.zeros((n, nf * NUM_SPATIAL_BINS), np.float32)
    ys = np.arange(n)
    for f in range(nf):
        for j in range(NUM_SPATIAL_BINS):
            c = bound + f * step + j * bin_size
            tri = np.maximum(0.0, (bin_size - np.abs(ys - c)) / bin_size)
            m[:, f * NUM_SPATIAL_BINS + j] = tri * wf[j]
    return m


def _dsift_one_scale(img: torch.Tensor, ayt, ax, bands):
    """Dense SIFT at one scale over pre-smoothed (B, H, W) images, with the
    scale's transposed y-axis (M, H) and x-axis (W, N) sampling matrices
    (None when the frame grid is empty) and their ``sift_bands``.

    Returns (B, num_frames, 128) descriptors (normalized + clamped) and
    (B, num_frames) pre-normalization norms."""
    B = img.shape[0]
    if ayt is None:
        return img.new_zeros((B, 0, DESCRIPTOR_DIMS)), img.new_zeros((B, 0))
    gy, gx = torch.gradient(img, dim=(1, 2))
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.remainder(torch.atan2(gy, gx), 2.0 * math.pi)
    t = ang / (2.0 * math.pi) * NUM_ORIENTATIONS
    nfy = ayt.shape[0] // NUM_SPATIAL_BINS
    nfx = ax.shape[1] // NUM_SPATIAL_BINS
    g = sift_bin_sample(mag.contiguous(), t.contiguous(), ayt, ax, bands)
    g = g.reshape(B, NUM_ORIENTATIONS, nfy, NUM_SPATIAL_BINS, nfx, NUM_SPATIAL_BINS)
    g = g.permute(0, 2, 4, 3, 5, 1)  # (B, nfy, nfx, j, i, t)
    raw = g.reshape(B, -1, DESCRIPTOR_DIMS)
    norms = torch.linalg.vector_norm(raw, dim=-1)
    desc = raw / torch.clamp(norms, min=1e-12)[..., None]
    desc = torch.clamp(desc, max=0.2)
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1), min=1e-12)[..., None]
    return desc, norms


def scale_operators(H: int, W: int, step: int, bin: int, num_scales: int,
                    scale_step: int, device) -> List[tuple]:
    """Per scale, on ``device``: the Gaussian pre-smoothing kernel, the
    transposed y-axis and x-axis sampling matrices and their bands
    (``sift_bands``; all three None when the frame grid is empty). Frame
    grid: top-left corners at bound + f·step along both axes, descriptor
    extent 4·binSize."""
    ops = []
    for scale in range(num_scales):
        bin_size = bin + 2 * scale
        k = torch.as_tensor(_gaussian_kernel(bin_size / MAGNIF), device=device)
        scale_step_ = step + scale * scale_step
        bound = (1 + 2 * num_scales) - 3 * scale
        extent = (NUM_SPATIAL_BINS - 1) * bin_size
        nfy = max((H - 1 - bound - extent) // scale_step_ + 1, 0)
        nfx = max((W - 1 - bound - extent) // scale_step_ + 1, 0)
        if nfy == 0 or nfx == 0:
            ops.append((k, None, None, None))
            continue
        ayt = torch.as_tensor(
            _sampling_matrix(H, nfy, bin_size, scale_step_, bound).T.copy(), device=device
        )
        ax = torch.as_tensor(_sampling_matrix(W, nfx, bin_size, scale_step_, bound), device=device)
        ops.append((k, ayt, ax, sift_bands(ayt, ax)))
    return ops


def dsift_unquantized(x: torch.Tensor, ops: List[tuple]) -> torch.Tensor:
    """(B, H, W) float32 gray images and their ``scale_operators`` ->
    (B, numDescriptors, 128) descriptors of every scale,
    contrast-thresholded, before the ×512 quantization."""
    descs: List[torch.Tensor] = []
    for k, ayt, ax, bands in ops:
        desc, norms = _dsift_one_scale(_sep_conv2d(x, k), ayt, ax, bands)
        # contrast-threshold zeroing (VLFeat.cxx:141-175)
        desc = torch.where(
            (norms >= CONTRAST_THRESHOLD)[..., None], desc, torch.zeros((), device=x.device)
        )
        descs.append(desc)
    return torch.cat(descs, dim=1)


@dataclasses.dataclass(eq=False)
class SIFTExtractor(Transformer):
    """Image -> (128, numDescriptors) short-valued descriptor matrix (the
    columns are descriptors)."""

    step: int = 3
    bin: int = 4
    num_scales: int = 4
    scale_step: int = 1

    def operators(self, H: int, W: int, device) -> List[tuple]:
        """``scale_operators`` (matrices and bands) for (H, W) images
        on ``device``, built once per (H, W, device) — the counterpart of
        the JAX package building them once per jit trace — so a dispatch
        does no numpy work."""
        cache = self.__dict__.setdefault("_operator_cache", {})
        key = (H, W, str(device))
        ops = cache.get(key)
        if ops is None:
            ops = cache[key] = scale_operators(
                H, W, self.step, self.bin, self.num_scales, self.scale_step, device
            )
        return ops

    def unquantized(self, imgs: torch.Tensor) -> torch.Tensor:
        """(B, H, W) or (B, H, W, C) images -> (B, numDescriptors, 128)
        descriptors before the ×512 quantization."""
        x = imgs.to(torch.float32)
        if x.ndim == 4:
            x = x[..., 0]
        return dsift_unquantized(
            x.contiguous(), self.operators(x.shape[1], x.shape[2], x.device)
        )

    def extract(self, imgs: torch.Tensor) -> torch.Tensor:
        """(B, H, W) or (B, H, W, C) images -> (B, 128, numDescriptors)."""
        # x512, clamp 255 (the uint8-style convention, VLFeat.cxx glue)
        quantized = torch.clamp(torch.floor(self.unquantized(imgs) * 512.0), max=255.0)
        return quantized.transpose(1, 2)

    def apply(self, img):
        return self.extract(img[None])[0]

    def apply_batch(self, ds: Dataset) -> Dataset:
        return Dataset.from_array(self.extract(ds.padded()), n=ds.n)
