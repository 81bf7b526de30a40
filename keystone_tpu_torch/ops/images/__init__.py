"""Image featurizers and their CUDA kernels (counterpart of
``keystone_tpu/ops/images``). The core nodes are exported here as in the
JAX package; SIFT, LCS, Fisher vectors, HOG, DAISY, the conversions and
the image utilities are in their modules."""

from keystone_tpu_torch.ops.images.core import (
    CenterCornerPatcher,
    Convolver,
    Cropper,
    GrayScaler,
    ImageVectorizer,
    PixelScaler,
    Pooler,
    RandomImageTransformer,
    RandomPatcher,
    SymmetricRectifier,
    Windower,
    channel_major_vectorize,
    pack_filters,
)

__all__ = [
    "CenterCornerPatcher",
    "Convolver",
    "Cropper",
    "GrayScaler",
    "ImageVectorizer",
    "PixelScaler",
    "Pooler",
    "RandomImageTransformer",
    "RandomPatcher",
    "SymmetricRectifier",
    "Windower",
    "channel_major_vectorize",
    "pack_filters",
]
