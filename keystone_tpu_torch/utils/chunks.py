"""Row-chunked batch application.

A fit runs a whole training set through each node as one batch. The
descriptor extractors and the Fisher-vector node make temporaries several
times the size of their output, so they run over fixed-size chunks of
rows (images) and write each chunk into one output tensor. Each image is
independent, so the values are those of a single batch.
"""

from __future__ import annotations

from typing import Callable

import torch

CHUNK_ROWS = 64


def map_rows(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
             rows: int = CHUNK_ROWS) -> torch.Tensor:
    """``fn`` over ``x[i : i + rows]`` for each chunk, the results stacked
    along the first axis into one preallocated tensor."""
    n = x.shape[0]
    if n <= rows:
        return fn(x)
    first = fn(x[:rows])
    out = first.new_empty((n,) + tuple(first.shape[1:]))
    out[:rows] = first
    del first
    for i in range(rows, n, rows):
        out[i : i + rows] = fn(x[i : i + rows])
    return out


# the output bytes of one chunk of the random-features image nodes
# (Convolver, SymmetricRectifier, Pooler, Windower) and of
# RandomFFTFeatures' intermediate: their whole-set
# outputs run to tens of GB at CIFAR-10's 50,000 images, so each chunk's
# temporaries stay a small fraction of the output
CHUNK_BYTES = 256 * 2**20


def rows_for(bytes_per_row: int) -> int:
    """Rows per chunk whose output is about ``CHUNK_BYTES`` (at least 1)."""
    return max(1, CHUNK_BYTES // max(1, int(bytes_per_row)))
