"""CSV loading and the labeled-data pair holder (counterpart of
``keystone_tpu/loaders/csv_loader.py``).

Reference: loaders/CsvDataLoader.scala:10 (textFile -> split ->
DenseVector) and loaders/LabeledData.scala:12 (labeled-RDD pair holder).
Both parse on the host through ``native.read_csv_f32`` (the native
multi-threaded parser, or ``np.loadtxt`` without it) into host tensors;
the apps move them to their device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from keystone_tpu_torch.native import read_csv_f32
from keystone_tpu_torch.parallel.dataset import Dataset


def CsvDataLoader(path: str, delimiter: str = ",") -> Dataset:
    """Load a numeric CSV into one array-mode Dataset (n, d)."""
    return Dataset.from_array(torch.from_numpy(read_csv_f32(path, delimiter=delimiter)))


@dataclasses.dataclass
class LabeledData:
    """Holds (labels, data) (reference: loaders/LabeledData.scala)."""

    labels: Dataset
    data: Dataset

    @staticmethod
    def from_csv(path: str, label_col: int = 0, label_offset: int = 0,
                 delimiter: str = ",") -> "LabeledData":
        """First (or ``label_col``-th) column is the integer label;
        ``label_offset`` is subtracted (MNIST CSVs are 1-indexed in the
        reference app, MnistRandomFFT.scala:31-38)."""
        arr = read_csv_f32(path, delimiter=delimiter)
        labels = arr[:, label_col].astype(np.int32) - label_offset
        data = np.delete(arr, label_col, axis=1)
        return LabeledData(
            labels=Dataset.from_array(torch.from_numpy(labels)),
            data=Dataset.from_array(torch.from_numpy(data)),
        )

    @staticmethod
    def of(labels, data) -> "LabeledData":
        return LabeledData(labels=Dataset.of(labels), data=Dataset.of(data))
