"""Text and speech dataset loaders (counterpart of
``keystone_tpu/loaders/text_loaders.py``).

Reference: loaders/NewsgroupsDataLoader.scala (per-class directories of
plaintext files), loaders/AmazonReviewsDataLoader.scala (JSON reviews, a
rating threshold giving a binary label), loaders/TimitFeaturesDataLoader.scala
(CSV features and "row label" sparse label files, 440 dimensions, 147
classes). Texts stay host items; TIMIT's features are parsed by
``native.read_csv_f32`` (the native multi-threaded parser, ``np.loadtxt``
without it) and put on the requested device.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from keystone_tpu_torch._device import resolve_device
from keystone_tpu_torch.loaders.csv_loader import LabeledData
from keystone_tpu_torch.native import read_csv_f32
from keystone_tpu_torch.parallel.dataset import Dataset

NEWSGROUPS_CLASSES = [
    "comp.graphics",
    "comp.os.ms-windows.misc",
    "comp.sys.ibm.pc.hardware",
    "comp.sys.mac.hardware",
    "comp.windows.x",
    "rec.autos",
    "rec.motorcycles",
    "rec.sport.baseball",
    "rec.sport.hockey",
    "sci.crypt",
    "sci.electronics",
    "sci.med",
    "sci.space",
    "misc.forsale",
    "talk.politics.misc",
    "talk.politics.guns",
    "talk.politics.mideast",
    "talk.religion.misc",
    "alt.atheism",
    "soc.religion.christian",
]

TIMIT_DIMENSION = 440
TIMIT_NUM_CLASSES = 147


def _int_labels(labels: List[int]) -> Dataset:
    return Dataset.from_array(torch.as_tensor(np.asarray(labels, np.int32)))


def NewsgroupsDataLoader(data_dir: str) -> LabeledData:
    """``data_dir/<class name>/<document>`` plaintext files, one directory
    per class of ``NEWSGROUPS_CLASSES``, labels the class's index."""
    labels: List[int] = []
    texts: List[str] = []
    for index, class_name in enumerate(NEWSGROUPS_CLASSES):
        class_dir = os.path.join(data_dir, class_name)
        if not os.path.isdir(class_dir):
            continue
        for fname in sorted(os.listdir(class_dir)):
            path = os.path.join(class_dir, fname)
            try:
                with open(path, errors="replace") as f:
                    texts.append(f.read())
                labels.append(index)
            except OSError:
                continue
    return LabeledData(labels=_int_labels(labels), data=Dataset.from_items(texts))


def AmazonReviewsDataLoader(path: str, threshold: float = 3.5) -> LabeledData:
    """JSON-lines reviews with "overall" and "reviewText" fields; label 1
    iff the rating is at least ``threshold``."""
    labels: List[int] = []
    texts: List[str] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            labels.append(1 if float(row["overall"]) >= threshold else 0)
            texts.append(row["reviewText"])
    return LabeledData(labels=_int_labels(labels), data=Dataset.from_items(texts))


@dataclasses.dataclass
class TimitFeaturesData:
    train: LabeledData
    test: LabeledData


def _parse_sparse_labels(path: str) -> Dict[int, int]:
    """"row label" lines, both 1-based -> {0-based row: label}."""
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out[int(parts[0]) - 1] = int(parts[1])
    return out


def TimitFeaturesDataLoader(
    train_data_location: str,
    train_labels_location: str,
    test_data_location: str,
    test_labels_location: str,
    device: Optional[Union[str, torch.device]] = None,
) -> TimitFeaturesData:
    """TIMIT's feature CSVs (one frame a row) and their sparse label files
    (1-based rows and labels; the labels become 0-based class ids), the
    features and labels on ``device`` (``None`` means ``cuda``)."""
    dev = resolve_device(device)

    def load(data_path: str, labels_path: str) -> LabeledData:
        feats = read_csv_f32(data_path)
        label_map = _parse_sparse_labels(labels_path)
        labels = np.asarray([label_map[i] - 1 for i in range(feats.shape[0])], np.int32)
        return LabeledData(
            labels=Dataset.from_array(torch.from_numpy(labels).to(dev)),
            data=Dataset.from_array(torch.from_numpy(feats).to(dev)),
        )

    return TimitFeaturesData(
        train=load(train_data_location, train_labels_location),
        test=load(test_data_location, test_labels_location),
    )
