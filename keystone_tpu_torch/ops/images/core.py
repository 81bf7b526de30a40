"""Core image nodes: scaling, convolution, pooling, rectification, patch
extraction (counterpart of ``keystone_tpu/ops/images/core.py``).

Reference: nodes/images/{Convolver,Pooler,SymmetricRectifier,Windower,
CenterCornerPatcher,RandomPatcher,RandomImageTransformer,Cropper}.scala
and the small utilities (ImageVectorizer, PixelScaler, GrayScaler).

Conventions: an image is a tensor ``A[x, y, c]`` (the reference's
``Image.get(x, y, channel)``); batches are ``(B, X, Y, C)``; an items-mode
dataset of images of several sizes runs one batch per size. Channel-major
vectorization flattens as ``vec[c + x·C + y·C·X]``, i.e.
``A.transpose(0, 1).reshape(-1)``.

The Convolver folds patch normalization and whitening around one
convolution, as the JAX package does:

    out = (conv(A, W) − m·S_f) / sd − ⟨μ_zca, W_f⟩

where m and sd are each patch's mean and standard deviation from two
box-filter convolutions (``F.conv2d``, float32 with cuDNN's TF32 off). The
nodes whose whole-set outputs run to tens of GB at CIFAR-10's 50,000
images (Convolver, SymmetricRectifier, Pooler with a ``pixel_fn``) work
through chunks of images written into one output tensor, so no node's
temporaries exceed a small share of its output; each image is
independent, so the values are those of a single batch (to float32
rounding: a convolution's blocking may change with the batch size).
Random draws (crop positions, flips) come from numpy generators seeded as
in the JAX package, so both draw the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.utils.chunks import map_rows, rows_for
from keystone_tpu_torch.utils.precision import mm
from keystone_tpu_torch.workflow.api import FunctionNode, Transformer
from keystone_tpu_torch.workflow.operators import cached_on

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
        """The (3,) weights on ``device``, made once per device."""
        return cached_on(self, "weights", lambda: torch.tensor(
            GRAYSCALE_WEIGHTS, dtype=torch.float32), device)

    def apply(self, img):
        return (img.to(torch.float32) @ self.weights(img.device))[..., None]

    def apply_batch(self, ds: Dataset) -> Dataset:
        if not ds.is_array:
            return self._bucketed_batch(ds)
        return Dataset.from_array(self.apply(ds.padded()), n=ds.n)

    def eq_key(self):
        return ("gray_scaler",)


def channel_major_vectorize(img: torch.Tensor) -> torch.Tensor:
    """A[x,y,c] -> vec[c + x·C + y·C·X] (ChannelMajor flatten)."""
    return img.transpose(0, 1).reshape(-1)


def pack_filters(filters: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stack filter images into the (num_filters, k·k·C) matrix layout of
    Convolver.packFilters (row i, col c + x·C + y·C·k = filter_i[x,y,c])."""
    return torch.stack([channel_major_vectorize(torch.as_tensor(f)) for f in filters])


@dataclasses.dataclass(eq=False)
class Convolver(Transformer):
    """Convolve images with a filter bank (reference: Convolver.scala:20).

    ``filters``: (num_filters, k·k·C) packed rows (optionally already
    whitened, as RandomPatchCifar does); ``whitener``: the ZCAWhitener
    whose means are subtracted from each (normalized) patch.

    Every convolution runs in float32. ``fast=True`` (the JAX package's
    switch to the TPU's DEFAULT precision, whose test bounds the feature
    error at 8e-3 of the largest feature) is accepted and runs the same
    float32 path. On the H100 at RandomPatchCifar's shape a bf16 filter
    convolution saves about a tenth of the Convolver's time (PERF.md);
    a bf16 path that keeps that gain and the JAX test's bar is not
    written yet."""

    filters: Any
    img_width: int
    img_height: int
    img_channels: int
    whitener: Optional[Any] = None
    normalize_patches: bool = True
    var_constant: float = 10.0
    fast: bool = False

    def __post_init__(self):
        self.filters = torch.as_tensor(self.filters).to(torch.float32)
        self.conv_size = int(np.sqrt(self.filters.shape[1] // self.img_channels))

    @property
    def res_width(self) -> int:
        return self.img_width - self.conv_size + 1

    @property
    def res_height(self) -> int:
        return self.img_height - self.conv_size + 1

    def _weight(self, device) -> torch.Tensor:
        """(F, C, k, k) for ``F.conv2d``: packed column c + x·C + y·C·k is
        W[f, x, y, c], and the image's x axis is the convolution's H."""
        k, C = self.conv_size, self.img_channels
        return cached_on(self, "weight", lambda: self.filters.reshape(-1, k, k, C)
                         .permute(0, 3, 2, 1).contiguous(), device)

    def apply(self, img):
        return self._convolve(img[None])[0]

    def apply_batch(self, ds: Dataset) -> Dataset:
        if not ds.is_array:
            return ds.map(self.apply)
        x = ds.padded()
        F_ = self.filters.shape[0]
        rows = rows_for(x.shape[1] * x.shape[2] * F_ * 4)
        return Dataset.from_array(map_rows(self._convolve, x, rows), n=ds.n)

    def _convolve(self, imgs: torch.Tensor) -> torch.Tensor:
        """imgs: (n, X, Y, C) -> (n, resX, resY, F)."""
        dev = imgs.device
        k, C = self.conv_size, self.img_channels
        P = k * k * C
        # out[n, f, x, y] = Σ A[n, x+dx, y+dy, c]·W[f, dx, dy, c]
        x = imgs.to(torch.float32).permute(0, 3, 1, 2)
        out = F.conv2d(x, self._weight(dev))
        if self.normalize_patches:
            ones = cached_on(self, "ones", lambda: torch.ones((1, C, k, k)), dev)
            s1 = F.conv2d(x, ones)
            s2 = F.conv2d(x * x, ones)
            m = s1 / P
            # Stats.normalizeRows: var over patch entries, /(P-1), +alpha
            var = (s2 - P * m * m) / (P - 1)
            sd = torch.sqrt(var + self.var_constant)
            sums = cached_on(self, "sums", lambda: self.filters.sum(dim=1), dev)
            out = (out - m * sums[None, :, None, None]) / sd
        if self.whitener is not None:
            # ⟨μ_zca, W_f⟩: the packed rows are W flattened as the patches are
            wdot = cached_on(self, "wdot", lambda: mm(
                self.filters, torch.as_tensor(self.whitener.means).to(torch.float32)), dev)
            out = out - wdot[None, :, None, None]
        return out.permute(0, 2, 3, 1).contiguous()


@dataclasses.dataclass(eq=False)
class Pooler(Transformer):
    """Strided spatial pooling (reference: Pooler.scala:21 — strides start
    at poolSize/2, windows truncate at the image edge, ``pixel_fn`` applied
    before pooling, ``pool_fn`` reduces each (n, wx, wy, C) window to
    (n, C); a sum by default). Both take tensors."""

    stride: int
    pool_size: int
    pixel_fn: Optional[Callable] = None
    pool_fn: Optional[Callable] = None

    def apply(self, img):
        return self._pool(img[None])[0]

    def apply_batch(self, ds: Dataset) -> Dataset:
        if not ds.is_array:
            return ds.map(self.apply)
        x = ds.padded()
        if self.pixel_fn is None:  # window sums make no image-sized temporary
            return Dataset.from_array(self._pool(x), n=ds.n)
        rows = rows_for(x[0].numel() * 4)
        return Dataset.from_array(map_rows(self._pool, x, rows), n=ds.n)

    def _pool(self, imgs: torch.Tensor) -> torch.Tensor:
        x_dim, y_dim = imgs.shape[1], imgs.shape[2]
        half = self.pool_size // 2
        xs = range(half, x_dim, self.stride)
        ys = range(half, y_dim, self.stride)
        vals = imgs.to(torch.float32)
        if self.pixel_fn is not None:
            vals = self.pixel_fn(vals)
        pool_fn = self.pool_fn or (lambda w: torch.sum(w, dim=(1, 2)))
        rows = [
            torch.stack([
                pool_fn(vals[:, px - half : min(px + half, x_dim),
                             py - half : min(py + half, y_dim), :])
                for py in ys
            ], dim=1)  # (n, ny, C)
            for px in xs
        ]
        return torch.stack(rows, dim=1)  # (n, nx, ny, C)


@dataclasses.dataclass(eq=False)
class SymmetricRectifier(Transformer):
    """Two-sided ReLU doubling the channel count: channels [0,C) are
    max(maxVal, x−α), channels [C,2C) are max(maxVal, −x−α)
    (reference: SymmetricRectifier.scala:7)."""

    max_val: float = 0.0
    alpha: float = 0.0

    def apply(self, img):
        pos = torch.clamp(img - self.alpha, min=self.max_val)
        neg = torch.clamp(-img - self.alpha, min=self.max_val)
        return torch.cat([pos, neg], dim=-1)

    def apply_batch(self, ds: Dataset) -> Dataset:
        if not ds.is_array:
            return ds.map(self.apply)
        x = ds.padded()
        out = map_rows(self.apply, x, rows_for(2 * x[0].numel() * 4))
        if self.max_val > 0 or self.alpha < 0:
            # rectified zero pad rows would be nonzero: keep them zero
            out = out * ds.mask().reshape((-1,) + (1,) * (out.ndim - 1))
        return Dataset.from_array(out, n=ds.n)


class ImageVectorizer(Transformer):
    """Image -> channel-major vector (reference:
    nodes/images/ImageVectorizer.scala)."""

    def apply(self, img):
        return channel_major_vectorize(img)

    def apply_batch(self, ds: Dataset) -> Dataset:
        if not ds.is_array:
            return ds.map(self.apply)
        x = ds.padded()
        return Dataset.from_array(x.transpose(1, 2).reshape(x.shape[0], -1), n=ds.n)

    def eq_key(self):
        return ("image_vectorizer",)


@dataclasses.dataclass(eq=False)
class Cropper(Transformer):
    """Static crop [startX:endX, startY:endY] (reference:
    nodes/images/Cropper.scala)."""

    start_x: int
    start_y: int
    end_x: int
    end_y: int

    def apply(self, img):
        return img[self.start_x : self.end_x, self.start_y : self.end_y]

    def apply_batch(self, ds: Dataset) -> Dataset:
        if not ds.is_array:
            return ds.map(self.apply)
        return Dataset.from_array(
            ds.padded()[:, self.start_x : self.end_x, self.start_y : self.end_y],
            n=ds.n,
        )


class Windower(FunctionNode):
    """Eagerly explode each image into all strided windows (reference:
    nodes/images/Windower.scala:13 — a FunctionNode flatMap). The windows
    come out (n·numWindows, k, k, C), window-major within each image (x
    positions outer, y inner), made on the images' device in one copy."""

    def __init__(self, stride: int, window_size: int):
        self.stride = stride
        self.window_size = window_size

    def apply(self, data) -> Dataset:
        ds = Dataset.of(data).to_array_mode()
        imgs = ds.padded()[: ds.n]
        k = self.window_size
        # (n, nx, ny, C, k, k) view: no copy until the reshape below
        w = imgs.unfold(1, k, self.stride).unfold(2, k, self.stride)
        return Dataset.from_array(
            w.permute(0, 1, 2, 4, 5, 3).reshape(-1, k, k, imgs.shape[3])
        )


@dataclasses.dataclass(eq=False)
class RandomPatcher(Transformer):
    """Random crops for train augmentation (reference:
    RandomPatcher.scala:17): emits ``num_patches`` random (size x size)
    crops per image. The corners are drawn on the host in the JAX
    package's order (image by image, x then y of each patch, one
    ``integers`` call each); the crops are gathered on the images'
    device."""

    num_patches: int
    patch_size_x: int
    patch_size_y: int
    seed: int = 0

    def apply_batch(self, ds: Dataset) -> Dataset:
        ds = ds.to_array_mode()
        imgs = ds.padded()[: ds.n]
        n, X, Y = imgs.shape[:3]
        px, py = self.patch_size_x, self.patch_size_y
        rng = np.random.default_rng(self.seed)
        corners = np.empty((n * self.num_patches, 2), np.int64)
        for i in range(corners.shape[0]):
            corners[i, 0] = rng.integers(0, X - px + 1)
            corners[i, 1] = rng.integers(0, Y - py + 1)
        dev = imgs.device
        src = torch.arange(n, device=dev).repeat_interleave(self.num_patches)
        cx = torch.as_tensor(corners[:, 0], device=dev)
        cy = torch.as_tensor(corners[:, 1], device=dev)
        # (n, X-px+1, Y-py+1, C, px, py) view: indexing it copies the crops
        windows = imgs.unfold(1, px, 1).unfold(2, py, 1)
        return Dataset.from_array(windows[src, cx, cy].permute(0, 2, 3, 1).contiguous())

    def apply(self, img):
        raise TypeError("RandomPatcher is a batch augmentation node")


@dataclasses.dataclass(eq=False)
class CenterCornerPatcher(Transformer):
    """Test-time augmentation: center + 4 corner crops, optionally with
    horizontal flips (reference: CenterCornerPatcher.scala:19)."""

    patch_size_x: int
    patch_size_y: int
    horizontal_flips: bool = False

    def _positions(self, X, Y):
        px, py = self.patch_size_x, self.patch_size_y
        return [
            (0, 0),
            (X - px, 0),
            (0, Y - py),
            (X - px, Y - py),
            ((X - px) // 2, (Y - py) // 2),
        ]

    def apply_batch(self, ds: Dataset) -> Dataset:
        ds = ds.to_array_mode()
        imgs = ds.padded()[: ds.n]
        X, Y = imgs.shape[1], imgs.shape[2]
        px, py = self.patch_size_x, self.patch_size_y
        crops = []
        for (x, y) in self._positions(X, Y):
            crop = imgs[:, x : x + px, y : y + py, :]
            crops.append(crop)
            if self.horizontal_flips:
                crops.append(crop.flip(2))
        # patch-major within each image: (n·numPatches, px, py, C)
        return Dataset.from_array(
            torch.stack(crops, dim=1).reshape((-1, px, py, imgs.shape[3]))
        )

    def apply(self, img):
        raise TypeError("CenterCornerPatcher is a batch augmentation node")

    @property
    def patches_per_image(self) -> int:
        return 10 if self.horizontal_flips else 5


@dataclasses.dataclass(eq=False)
class RandomImageTransformer(Transformer):
    """Random horizontal flip with probability ``flip_chance``
    (reference: RandomImageTransformer.scala); one draw per padded row
    from ``default_rng(seed)``, as in the JAX package."""

    flip_chance: float = 0.5
    seed: int = 0

    def apply_batch(self, ds: Dataset) -> Dataset:
        ds = ds.to_array_mode()
        imgs = ds.padded()
        rng = np.random.default_rng(self.seed)
        flips = torch.as_tensor(rng.random(imgs.shape[0]) < self.flip_chance,
                                device=imgs.device)
        out = torch.where(flips[:, None, None, None], imgs.flip(2), imgs)
        return Dataset.from_array(out, n=ds.n)

    def apply(self, img):
        return img
