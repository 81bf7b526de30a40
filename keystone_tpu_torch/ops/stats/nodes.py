"""Statistical feature nodes (counterpart of
``keystone_tpu/ops/stats/nodes.py``): the flagship path's
``NormalizeRows``, ``SignedHellingerMapper`` and ``ColumnSampler``, and
the random-features apps' ``RandomSignNode``, ``PaddedFFT``,
``RandomFFTFeatures``, ``LinearRectifier``, ``StandardScaler`` and
``Sampler``; TIMIT's ``CosineRandomFeatures``.

Reference: nodes/stats/*.scala. Random signs, sample indices and cosine
features' frequencies and phases are drawn with numpy generators seeded as
in the JAX package, so both packages draw the same numbers; the FFTs are ``torch.fft.rfft`` (cuFFT on the card),
whose bins are the first half of the full transform's. The text apps'
``TermFrequency`` counts terms on the host.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any, Callable, Optional

import numpy as np
import torch

from keystone_tpu_torch.ops.nlp.string_utils import HostTextTransformer
from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.utils.chunks import map_rows, rows_for
from keystone_tpu_torch.utils.precision import mm
from keystone_tpu_torch.workflow.api import Estimator, FunctionNode, Transformer
from keystone_tpu_torch.workflow.operators import cached_on


def _pad_len(d: int) -> int:
    """The next power of two at or above ``d``."""
    return int(2 ** np.ceil(np.log2(max(d, 1))))


def _signs(d: int, seed: int) -> np.ndarray:
    """(d,) float32 ±1 drawn as the JAX package's RandomSignNode.create."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, size=d).astype(np.float32) * 2.0 - 1.0


def _fft_real_half(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Real parts of the first pad/2 bins of the zero-padded FFT along the
    last axis (PaddedFFT.scala: Breeze fourierTr, x(0 until pad/2).real)."""
    return torch.fft.rfft(x.to(torch.float32), n=pad, dim=-1).real[..., : pad // 2]


@dataclasses.dataclass(eq=False)
class RandomSignNode(Transformer):
    """Elementwise multiply by a fixed ±1 sign vector (reference:
    nodes/stats/RandomSignNode.scala:10; factory draws Binomial signs)."""

    signs: Any  # (d,) tensor of ±1

    def __post_init__(self):
        self.signs = torch.as_tensor(self.signs)

    @staticmethod
    def create(d: int, seed: int = 0, device=None) -> "RandomSignNode":
        return RandomSignNode(torch.as_tensor(_signs(d, seed), device=device))

    def apply(self, x):
        return x * cached_on(self, "signs", lambda: self.signs, x.device)

    def apply_batch(self, ds: Dataset) -> Dataset:
        return Dataset.from_array(self.apply(ds.padded()), n=ds.n)


@dataclasses.dataclass(eq=False)
class PaddedFFT(Transformer):
    """Zero-pad to the next power of two, real FFT, keep the real parts of
    the first half (reference: nodes/stats/PaddedFFT.scala:13)."""

    def apply(self, x):
        return _fft_real_half(x, _pad_len(x.shape[-1]))

    def apply_batch(self, ds: Dataset) -> Dataset:
        return Dataset.from_array(self.apply(ds.padded()), n=ds.n)

    def eq_key(self):
        return ("padded_fft",)


@dataclasses.dataclass(eq=False)
class RandomFFTFeatures(Transformer):
    """All ``num_ffts`` random-sign -> PaddedFFT -> rectify branches of
    the MnistRandomFFT featurization as one batched transform (reference
    composes per-branch pipelines, MnistRandomFFT.scala:28-37): one
    (num_ffts, d) sign matrix and one batched FFT per chunk of rows
    (``utils.chunks.rows_for`` of the (num_ffts, pad) intermediate a row
    makes, and at most ``row_chunk``), written into one
    (n, num_ffts · pad/2) output."""

    signs: Any  # (num_ffts, d)
    rectify_threshold: float = 0.0
    row_chunk: int = 8192  # bounds the (chunk, num_ffts, pad) intermediate

    def __post_init__(self):
        self.signs = torch.as_tensor(self.signs)

    @staticmethod
    def create(d: int, num_ffts: int, seed: int = 0,
               rectify_threshold: float = 0.0, device=None) -> "RandomFFTFeatures":
        """Branch i's signs match ``RandomSignNode.create(d, seed + i)``,
        so the fused node is numerically interchangeable with the
        composed per-branch pipelines."""
        signs = np.stack([_signs(d, seed + i) for i in range(num_ffts)])
        return RandomFFTFeatures(torch.as_tensor(signs, device=device),
                                 rectify_threshold=rectify_threshold)

    @property
    def out_dim(self) -> int:
        return self.signs.shape[0] * (_pad_len(self.signs.shape[1]) // 2)

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        """(..., d) -> (..., num_ffts · pad/2)."""
        signs = cached_on(self, "signs", lambda: self.signs, x.device)
        spec = _fft_real_half(x[..., None, :] * signs, _pad_len(x.shape[-1]))
        out = torch.clamp(spec, min=self.rectify_threshold)
        return out.reshape(x.shape[:-1] + (-1,))

    def apply(self, x):
        return self._features(x)

    def apply_batch(self, ds: Dataset) -> Dataset:
        x = ds.local()
        rows = min(rows_for(self.signs.shape[0] * _pad_len(x.shape[-1]) * 4), self.row_chunk)
        out = map_rows(self._features, x, rows)
        if self.rectify_threshold > 0:
            # pad rows rectify to the threshold: keep them zero
            out *= ds.mask()[:, None]
        return Dataset(arrays=out, n=ds.n, mesh=ds.mesh)


@dataclasses.dataclass(eq=False)
class LinearRectifier(Transformer):
    """max(max_val, x - alpha) (reference:
    nodes/stats/LinearRectifier.scala:12)."""

    max_val: float = 0.0
    alpha: float = 0.0

    def apply(self, x):
        return torch.clamp(x - self.alpha, min=self.max_val)

    def apply_batch(self, ds: Dataset) -> Dataset:
        out = self.apply(ds.local())
        if self.max_val > 0 or self.alpha < 0:
            # rectified zero pad rows would be nonzero: keep the invariant
            out = out * ds.mask()[:, None]
        return Dataset(arrays=out, n=ds.n, mesh=ds.mesh)


@dataclasses.dataclass(eq=False)
class NormalizeRows(Transformer):
    """L2 row normalization with a tiny-norm floor (2.2e-16)."""

    floor: float = 2.2e-16

    def apply(self, x):
        return x / torch.clamp(torch.linalg.vector_norm(x), min=self.floor)

    def apply_batch(self, ds: Dataset) -> Dataset:
        x = ds.padded()
        nrm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return Dataset.from_array(x / torch.clamp(nrm, min=self.floor), n=ds.n)


@dataclasses.dataclass(eq=False)
class SignedHellingerMapper(Transformer):
    """Signed square-root power normalization: sign(x) * sqrt(|x|)."""

    def apply(self, x):
        # sign(x)·sqrt(|x|) with one temporary: multiplying by ±1 is exact,
        # so copysign gives the same values (a zero may keep its sign)
        return torch.abs(x).sqrt_().copysign_(x)

    def apply_batch(self, ds: Dataset) -> Dataset:
        if not ds.is_array:  # descriptor matrices of several widths
            return self._bucketed_batch(ds)
        return Dataset.from_array(self.apply(ds.padded()), n=ds.n)

    def eq_key(self):
        return ("signed_hellinger",)


class ColumnSampler(Transformer):
    """Sample ``num_cols`` columns of each (d, m) matrix datum — used to
    subsample per-image descriptor sets before the PCA and GMM fits.

    The indices are drawn on the host, one ``default_rng((seed, counter))``
    per datum in dataset order with the counter running on across calls,
    as in the JAX package, so both draw the same columns. They are applied
    on the data's device: a batch is gathered there, never copied to the
    host."""

    def __init__(self, num_cols: int, seed: int = 0):
        self.num_cols = num_cols
        self.seed = seed
        self._counter = 0

    def _draw(self, m: int) -> np.ndarray:
        # independent draw per datum (the reference samples per image)
        rng = np.random.default_rng((self.seed, self._counter))
        self._counter += 1
        return rng.integers(0, m, self.num_cols)

    def apply(self, m):
        m = torch.as_tensor(m)
        idx = torch.as_tensor(self._draw(m.shape[1]), device=m.device)
        return m[:, idx]

    def apply_batch(self, ds: Dataset) -> Dataset:
        if not ds.is_array:
            return ds.map(self.apply)
        x = ds.array()  # (n, d, m)
        n, d, m = x.shape
        idx = np.stack([self._draw(m) for _ in range(n)]) if n else (
            np.zeros((0, self.num_cols), np.int64)
        )
        idx = torch.as_tensor(idx, device=x.device)
        out = torch.gather(x, 2, idx[:, None, :].expand(n, d, self.num_cols))
        return Dataset.from_array(out, n=n)

    def eq_key(self):
        return ("column_sampler", self.num_cols, self.seed)


@dataclasses.dataclass(eq=False)
class StandardScalerModel(Transformer):
    """x -> (x - mean) / std (std division optional). Pad rows are
    re-zeroed after centering so downstream Gram-matrix math stays exact
    (reference: nodes/stats/StandardScaler.scala:16)."""

    mean: Any  # (d,)
    std: Optional[Any] = None  # (d,) or None

    def apply(self, x):
        out = x - cached_on(self, "mean", lambda: self.mean, x.device)
        if self.std is not None:
            out = out / cached_on(self, "std", lambda: self.std, x.device)
        return out

    def apply_batch(self, ds: Dataset) -> Dataset:
        """Sharded rows are scaled where they are."""
        return ds.map_arrays(lambda x: self.apply(x) * ds.mask()[:, None])


@dataclasses.dataclass(eq=False)
class StandardScaler(Estimator):
    """Column mean and std in one pass over the rows (reference:
    nodes/stats/StandardScaler.scala:38, a treeAggregate of a
    MultivariateOnlineSummarizer): float32 sums of x and x², unbiased
    variance (n − 1), a std below ``eps`` taken as 1, as in the JAX
    package. Sharded rows: each process's sums plus an ``all_sum``."""

    normalize_std_dev: bool = True
    eps: float = 1e-12

    def fit(self, data: Dataset) -> StandardScalerModel:
        x = data.local().to(torch.float32)
        n = data.n
        s1, s2 = data.row_sum(x, x * x)
        mean = s1 / n
        if not self.normalize_std_dev:
            return StandardScalerModel(mean, None)
        var = (s2 - n * mean * mean) / max(n - 1, 1)
        std = torch.sqrt(torch.clamp(var, min=0.0))
        std = torch.where(std < self.eps, torch.ones_like(std), std)
        return StandardScalerModel(mean, std)


class Sampler(FunctionNode):
    """Eager takeSample of ~``size`` examples (reference:
    nodes/stats/Sampling.scala:28): the JAX package's sorted
    ``default_rng(seed).choice`` indices, gathered on the data's device
    (the sample of 100,000 windows of CIFAR-10's 36 M never sends the
    windows to the host)."""

    def __init__(self, size: int, seed: int = 0):
        self.size = size
        self.seed = seed

    def apply(self, data: Any) -> Dataset:
        ds = Dataset.of(data)
        rng = np.random.default_rng(self.seed)
        k = min(self.size, ds.n)
        idx = np.sort(rng.choice(ds.n, size=k, replace=False))
        if ds.is_array and not isinstance(ds.padded(), tuple):
            x = ds.padded()
            return Dataset.from_array(x[torch.as_tensor(idx, device=x.device)], n=k)
        items = ds.items()
        return Dataset.from_items([items[i] for i in idx])


@dataclasses.dataclass(eq=False)
class CosineRandomFeatures(Transformer):
    """Random Fourier features cos(x Wᵀ + b)
    (nodes/stats/CosineRandomFeatures.scala:19,49): one float32 matmul and
    a cosine; pad rows stay zero."""

    W: Any  # (num_features, d)
    b: Any  # (num_features,)

    @staticmethod
    def create(d: int, num_features: int, gamma: float, seed: int = 0,
               distribution: str = "gaussian", device=None) -> "CosineRandomFeatures":
        """W with entries γ·N(0, 1) (or γ·Cauchy) and b uniform in [0, 2π),
        drawn by ``np.random.default_rng(seed)`` as the JAX package draws
        them, then put on ``device`` (the CPU when it is not given)."""
        rng = np.random.default_rng(seed)
        if distribution == "cauchy":
            w = rng.standard_cauchy((num_features, d)) * gamma
        else:
            w = rng.standard_normal((num_features, d)) * gamma
        b = rng.uniform(0.0, 2.0 * np.pi, num_features)
        return CosineRandomFeatures(
            torch.as_tensor(w.astype(np.float32), device=device),
            torch.as_tensor(b.astype(np.float32), device=device),
        )

    def apply(self, x):
        return torch.cos(mm(x, self.W.T) + self.b)

    def apply_batch(self, ds: Dataset) -> Dataset:
        # cos(0 + b) is not 0: keep the pad rows zero (sharded rows where they are)
        out = self.apply(ds.local()) * ds.mask()[:, None]
        return Dataset.from_array(out, n=ds.n, mesh=ds.mesh)


def identity(x):
    return x


def presence(x):
    """TermFrequency(x => 1): a term counts once however often it occurs.
    A module-level function, unlike the JAX package's lambda, so that a
    fitted pipeline holding it can be saved."""
    return 1


@dataclasses.dataclass(eq=False)
class TermFrequency(HostTextTransformer):
    """term sequence -> {term: weighted count} with a pluggable weighting
    function (reference: nodes/stats/TermFrequency.scala:19). N-gram lists
    become hashable tuples on the way in."""

    fn: Callable[[float], float] = identity

    def apply(self, terms):
        counts = Counter(tuple(t) if isinstance(t, list) else t for t in terms)
        return {k: self.fn(v) for k, v in counts.items()}

    def eq_key(self):
        return ("term_frequency", self.fn)
