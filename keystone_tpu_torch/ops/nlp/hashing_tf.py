"""Hashing-trick term frequencies (counterpart of
``keystone_tpu/ops/nlp/hashing_tf.py``).

Reference: nodes/nlp/HashingTF.scala:15 (Scala ``.##`` hash mod
numFeatures -> SparseVector of counts) and NGramsHashingTF.scala:25
(rolling MurmurHash3-style n-gram hashing that avoids materializing the
n-gram lists). Hashes are the JAX package's stable FNV-1a, reproducible
across processes (Python's builtin hash is salted), so both packages put
every term in the same column.

A batch comes out as a sparse row matrix on the host (``Dataset``'s CSR
mode); a single document as a 1-D sparse COO vector. The estimator or
model that consumes the rows moves them to its device: featurizing text
is host work.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from keystone_tpu_torch.parallel.dataset import (
    Dataset,
    csr_from_coo,
    csr_from_parts,
    csr_rows,
)
from keystone_tpu_torch.workflow.api import Transformer

# FNV-1a's 32-bit constants, as in the JAX package and native/text.cc
_FNV_OFFSET = 0x811C9DC5
_FNV_PRIME = 0x01000193
_MASK = 0xFFFFFFFF


def stable_hash(term: Any) -> int:
    """FNV-1a over the utf-8 of str(term): the same in every process."""
    h = _FNV_OFFSET
    for b in str(term).encode("utf-8"):
        h = ((h ^ b) * _FNV_PRIME) & _MASK
    return h


def stable_hashes(terms: Sequence[Any]) -> np.ndarray:
    """``stable_hash`` of every term as a uint64 array, computed a byte
    position at a time over all terms at once (the values are equal)."""
    enc = [str(t).encode("utf-8") for t in terms]
    lens = np.fromiter(map(len, enc), np.int64, len(enc))
    h = np.full(len(enc), _FNV_OFFSET, np.uint64)
    if not enc or lens.max() == 0:
        return h
    # the bytes as a (terms, longest) matrix, zero past each term's end
    buf = np.zeros((len(enc), int(lens.max())), np.uint8)
    starts = np.repeat(np.cumsum(lens) - lens, lens)
    cols = np.arange(int(lens.sum())) - starts
    buf[np.repeat(np.arange(len(enc)), lens), cols] = np.frombuffer(b"".join(enc), np.uint8)
    prime, mask = np.uint64(_FNV_PRIME), np.uint64(_MASK)
    for j in range(buf.shape[1]):
        step = ((h ^ buf[:, j]) * prime) & mask
        h = np.where(lens > j, step, h)
    return h


def _vector(counts: Dict[int, float], num_features: int) -> torch.Tensor:
    """A {column: value} dict as a 1-D sparse vector, columns ascending."""
    cols = sorted(counts)
    return torch.sparse_coo_tensor(
        torch.tensor([cols], dtype=torch.int64).reshape(1, -1),
        torch.tensor([counts[c] for c in cols], dtype=torch.float32),
        (num_features,), is_coalesced=True,
    )


def _rows_matrix(per_doc: List[Dict[int, float]], num_features: int) -> Dataset:
    """One {column: value} dict per document as an (n, num_features) CSR
    matrix in a Dataset."""
    rows, cols, vals = [], [], []
    for r, counts in enumerate(per_doc):
        rows.extend([r] * len(counts))
        cols.extend(counts.keys())
        vals.extend(counts.values())
    mat = csr_from_coo(rows, cols, vals, (len(per_doc), num_features))
    return Dataset.from_array(mat, n=len(per_doc))


@dataclasses.dataclass(eq=False)
class HashingTF(Transformer):
    """term sequence -> sparse count vector (reference:
    HashingTF.scala:15)."""

    num_features: int

    def _counts(self, document: Sequence) -> Dict[int, float]:
        counts: Dict[int, float] = {}
        for term in document:
            i = stable_hash(term) % self.num_features
            counts[i] = counts.get(i, 0.0) + 1.0
        return counts

    def apply(self, document: Sequence) -> torch.Tensor:
        return _vector(self._counts(document), self.num_features)

    def apply_batch(self, ds: Dataset) -> Dataset:
        return _rows_matrix([self._counts(d) for d in ds.items()], self.num_features)


@dataclasses.dataclass(eq=False)
class NGramsHashingTF(Transformer):
    """Rolling-hash n-gram TF: hashes every n-gram of the given consecutive
    orders without materializing them (reference:
    NGramsHashingTF.scala:25)."""

    orders: Sequence[int]
    num_features: int

    def __post_init__(self):
        orders = list(self.orders)
        for a, b in zip(orders, orders[1:]):
            if b != a + 1:
                raise ValueError(f"orders are not consecutive: {orders}")
        self._lo = min(orders)
        self._hi = max(orders)

    def _counts(self, tokens: Sequence) -> Dict[int, float]:
        counts: Dict[int, float] = {}
        n = len(tokens)
        token_hashes = [stable_hash(t) for t in tokens]
        for i in range(n):
            h = _FNV_OFFSET
            for order in range(1, self._hi + 1):
                if i + order > n:
                    break
                # roll the n-gram hash forward one token
                h = ((h ^ token_hashes[i + order - 1]) * _FNV_PRIME) & _MASK
                if order >= self._lo:
                    c = h % self.num_features
                    counts[c] = counts.get(c, 0.0) + 1.0
        return counts

    def apply(self, tokens: Sequence) -> torch.Tensor:
        return _vector(self._counts(tokens), self.num_features)

    def apply_batch(self, ds: Dataset) -> Dataset:
        return _rows_matrix([self._counts(d) for d in ds.items()], self.num_features)


@dataclasses.dataclass(eq=False)
class FusedTextHashTF(Transformer):
    """raw document string -> hashed n-gram TF sparse row, with the whole
    Trim -> LowerCase -> Tokenizer -> NGramsHashingTF chain in one
    multi-threaded pass of the native library (``native/text.cc``, built
    into the port's ``_build/`` at first use): hash-identical output, no
    per-token Python objects. ``binarize`` maps counts to 1
    (TermFrequency(x => 1)).

    A non-ASCII document goes through the composed Python nodes, since the
    C++ tokenizer is byte-level; so does every document when the library
    cannot be built or loaded. The JAX package sends a whole batch through
    Python when one of its documents is non-ASCII; the port sends only
    that document, which gives every document the same row. ``routes``
    counts the documents each way (``{"native": n, "python": m}``), so a
    caller can tell that the native path ran."""

    orders: Sequence[int]
    num_features: int
    binarize: bool = False

    def __post_init__(self):
        self._delegate = NGramsHashingTF(self.orders, self.num_features)
        if self.num_features <= 0:
            raise ValueError(
                f"num_features must be positive, got {self.num_features}"
            )
        self._lo = self._delegate._lo
        self._hi = self._delegate._hi
        self.routes = {"native": 0, "python": 0}

    def _python_rows(self, docs: Sequence[str]) -> List[Dict[int, float]]:
        from keystone_tpu_torch.ops.nlp.string_utils import LowerCase, Tokenizer, Trim

        tok, lc, tr = Tokenizer(), LowerCase(), Trim()
        out = []
        for d in docs:
            counts = self._delegate._counts(tok.apply(lc.apply(tr.apply(d))))
            if self.binarize:
                counts = {c: min(v, 1.0) for c, v in counts.items()}
            out.append(counts)
        return out

    def apply(self, doc: str) -> torch.Tensor:
        mat = self.apply_batch(Dataset.from_items([doc])).padded()
        return csr_rows(mat, 1)[0]

    def apply_batch(self, ds: Dataset) -> Dataset:
        from keystone_tpu_torch import native

        items = ds.items()
        n = len(items)
        ascii_idx = [i for i, d in enumerate(items) if d.isascii()]
        out = None
        if ascii_idx:
            out = native.text_ngram_hash_tf(
                [items[i] for i in ascii_idx] if len(ascii_idx) < n else items,
                self._lo, self._hi, self.num_features, self.binarize,
            )
        if out is None:  # no library: every document through Python
            self.routes["python"] += n
            return _rows_matrix(self._python_rows(items), self.num_features)
        row_ptr, cols, values = out
        self.routes["native"] += len(ascii_idx)
        if len(ascii_idx) == n:
            mat = csr_from_parts(row_ptr, cols, values, (n, self.num_features))
            return Dataset.from_array(mat, n=n)
        # some documents are non-ASCII: their rows from the Python nodes,
        # put back in dataset order
        others = [i for i, d in enumerate(items) if not d.isascii()]
        self.routes["python"] += len(others)
        per_doc: List[Dict[int, float]] = [None] * n
        for k, i in enumerate(ascii_idx):
            s, e = int(row_ptr[k]), int(row_ptr[k + 1])
            per_doc[i] = dict(zip(cols[s:e].tolist(), values[s:e].tolist()))
        for i, counts in zip(others, self._python_rows([items[i] for i in others])):
            per_doc[i] = counts
        return _rows_matrix(per_doc, self.num_features)
