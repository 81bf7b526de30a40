"""ImageNet and VOC tar-archive image loaders, labeled images and their
extractors (counterpart of ``keystone_tpu/loaders/image_loaders.py``).

These are the eager loaders: they collect a ``Dataset`` of decoded images
at their native sizes, in items mode, for sets that fit in host memory.
They are thin collectors over the streaming loaders of
``loaders/streaming.py``; a set that does not fit goes through
``StreamingImageNetLoader`` and is never collected.

Images are ``(x=row, y=col, c)`` float32 arrays of 0..255.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from keystone_tpu_torch.loaders.streaming import (
    StreamingImageLoader,
    imagenet_label_fn,
    tar_shard_paths,
    voc_label_fn,
)
from keystone_tpu_torch.parallel.dataset import Dataset

NUM_IMAGENET_CLASSES = 1000


@dataclasses.dataclass
class LabeledImage:
    image: np.ndarray
    label: int
    filename: str = ""


def ImageNetLoader(location: str, labels_path: str) -> Dataset:
    """Labeled ImageNet images from a tar file or a directory of them.
    ``labels_path`` maps WNID -> integer class ("n15075141 12" lines); a
    member whose WNID it lacks is skipped."""
    stream = StreamingImageLoader(
        tar_shard_paths(location, 0, 1), imagenet_label_fn(labels_path)
    )
    return Dataset.from_items(
        [LabeledImage(arr, label, name) for name, label, arr in stream.items()]
    )


def VOCLoader(location: str, labels_path: str) -> Dataset:
    """VOC2007 images: the labels CSV has (id, class, classname,
    traintesteval, filename) rows, and an image may be under several
    classes, kept as ``labels`` (its ``label`` is -1)."""
    stream = StreamingImageLoader(
        tar_shard_paths(location, 0, 1), voc_label_fn(labels_path)
    )
    items = []
    for name, labels, arr in stream.items():
        li = LabeledImage(arr, -1, name.split("/")[-1])
        li.labels = labels
        items.append(li)
    return Dataset.from_items(items)


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


class MultiLabelExtractor:
    """LabeledImage dataset -> each image's classes as an int array (its
    ``labels``, else its one ``label``), items mode on the host."""

    @staticmethod
    def apply(ds: Dataset) -> Dataset:
        return ds.map(lambda li: np.asarray(getattr(li, "labels", [li.label])))

    def __call__(self, ds: Dataset) -> Dataset:
        return self.apply(ds)
