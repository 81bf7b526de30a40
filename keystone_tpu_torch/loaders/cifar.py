"""CIFAR-10 binary loader (counterpart of ``keystone_tpu/loaders/cifar.py``).

Reference: loaders/CifarLoader.scala:13 — parses the binary record format
(1 label byte + 3·1024 channel-plane bytes per image). Images come out as
(32, 32, 3) float32 arrays indexed [x, y, c] with x = row, on the host; the
apps move them to their device.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from keystone_tpu_torch.native import read_cifar
from keystone_tpu_torch.parallel.dataset import Dataset

CIFAR_DIM = 32
CIFAR_CHANNELS = 3
RECORD_LEN = 1 + CIFAR_DIM * CIFAR_DIM * CIFAR_CHANNELS


@dataclasses.dataclass
class LabeledImages:
    """(labels, images) pair — the CifarLoader output shape."""

    labels: Dataset
    images: Dataset


def CifarLoader(path: str) -> LabeledImages:
    """One CIFAR binary file; a file that is not a whole number of records
    raises."""
    if os.path.getsize(path) % RECORD_LEN != 0:
        raise ValueError(f"{path}: not a whole number of CIFAR records")
    labels, imgs = read_cifar(path, CIFAR_CHANNELS, CIFAR_DIM)
    return LabeledImages(
        labels=Dataset.from_array(torch.from_numpy(labels)),
        images=Dataset.from_array(torch.from_numpy(imgs)),
    )
