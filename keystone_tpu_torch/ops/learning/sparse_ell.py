"""Fixed-width sparse rows (ELL format) and a streamed one-pass solver
(counterpart of ``keystone_tpu/ops/learning/sparse_ell.py``).

Reference: the Amazon reviews workload — hashed-TF features (65M rows x
1,024 hashed dims, ~0.5% dense; scripts/constantEstimator.R:34-36) solved
by LeastSquaresSparseGradient L-BFGS (nodes/learning/LBFGS.scala:208) or
the Exact normal-equations solver (nodes/learning/LinearMapper.scala).

Hashed-TF rows have a bounded number of nonzeros, so they are stored as
ELL: ``(n, nnz)`` column ids and values. The fit streams row chunks,
expands each to a dense ``(chunk, d)`` bfloat16 tile and accumulates the
normal equations G = AᵀA and AᵀY in float32 in one pass; the (d, d) system
is then solved on the device (``block_ls._psd_solve_device``).

Precision, as in the JAX package. A tile's entries are bfloat16: the
duplicate column ids of a row are summed in bfloat16 in column order
``j`` (one gather and scatter per ``j``, never an atomic add, so the
order is fixed). G and AᵀY are bf16 × bf16 products accumulated and
returned in float32: on the card ``torch.mm(..., out_dtype=float32)``
(cuBLAS with float32 accumulation; a plain bf16 ``torch.mm`` would round
every partial Gram to bf16), on the CPU the tiles upcast to float32 (a
product of two bf16 values is exact in float32). float32 labels meet a
float32 copy of the tile (the JAX package's ``Precision.HIGHEST``).

``segment_flops`` is kept from the JAX package, where it cut a fit into
dispatches short enough for a remote TPU worker's watchdog: the chunks of
one segment are queued, then the host waits for the device. On the GPU
each chunk is its own few kernels and no single launch runs long, so a
segment only bounds how far the host runs ahead; at the Amazon shape
(65M x 1,024) the default bound is one segment.

Rows sharded over processes (the JAX package's ``_sharded_normal_eq``, a
shard_map of the pass and a psum): each process runs the pass over its
own rows and G and AᵀY are added over the shards in one ``all_reduce``
(``all_sum``); the (d, d) solve then runs on every process. As in the
JAX package, a fit under a mesh of several shards shards unsharded rows
itself (``Dataset.shard`` pads them to a shard multiple with zero rows,
which add nothing).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from keystone_tpu_torch.ops.learning.block_ls import _psd_solve_device
from keystone_tpu_torch.ops.learning.linear import LinearMapper
from keystone_tpu_torch.parallel import mesh as mesh_lib
from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.workflow.api import LabelEstimator


def ell_dataset(idx, vals, n: Optional[int] = None) -> Dataset:
    """``(n, nnz)`` int32 column ids and their values as a Dataset whose
    element is the ELL pair. Pad rows must have ``vals == 0`` (their
    contributions then vanish)."""
    return Dataset.from_array((torch.as_tensor(idx), torch.as_tensor(vals)), n=n)


def ell_to_dense(idx: torch.Tensor, vals: torch.Tensor, d: int) -> torch.Tensor:
    """Dense (rows, d) bfloat16 tile of ELL rows; duplicate column ids sum
    in bfloat16 in column order, and ids outside [0, d) are dropped, as the
    JAX package's iota-compare densify does."""
    out = torch.zeros((idx.shape[0], d), dtype=torch.bfloat16, device=idx.device)
    for j in range(idx.shape[1]):
        col = idx[:, j : j + 1].to(torch.int64)
        inside = (col >= 0) & (col < d)
        col = col.clamp(0, d - 1)
        v = torch.where(inside, vals[:, j : j + 1], 0).to(torch.bfloat16)
        out.scatter_(1, col, out.gather(1, col) + v)
    return out


def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in float32: bf16 operands on the
    card through cuBLAS with a float32 output, else float32 operands."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.to(torch.float32), b.to(torch.float32))


def _normal_eq_pass(idx, vals, Y, *, d: int, chunk: int,
                    G: Optional[torch.Tensor] = None,
                    AY: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(AᵀA, AᵀY) over the rows, one dense tile of ``chunk`` rows at a
    time, added into ``G`` and ``AY`` when given."""
    k = Y.shape[1]
    if G is None:
        G = torch.zeros((d, d), dtype=torch.float32, device=idx.device)
        AY = torch.zeros((d, k), dtype=torch.float32, device=idx.device)
    for s in range(0, idx.shape[0], chunk):
        dense = ell_to_dense(idx[s : s + chunk], vals[s : s + chunk], d)
        G += _f32_product(dense.T, dense)
        AY += _f32_product(dense.T, Y[s : s + chunk])
    return G, AY


@dataclasses.dataclass(eq=False)
class EllLeastSquaresEstimator(LabelEstimator):
    """One-pass L2-regularized least squares on ELL sparse features:
    accumulate the normal equations in one streamed pass, solve the (d, d)
    system on the device (float32 Cholesky with refinement, the eigh
    fallback for a rank-deficient λ = 0 system). Replaces both reference
    solvers for this workload (LinearMapper.scala's Exact solver,
    LBFGS.scala:208's re-streaming sparse L-BFGS)."""

    d: int  # feature dimension (hash space size)
    lam: float = 0.0
    chunk: int = 1_000_000
    segment_flops: float = 2.5e15  # Gram FLOPs between waits for the device

    def fit(self, data: Dataset, labels: Dataset) -> "EllLinearMapper":
        data = data.to_array_mode()
        if (not data.is_sharded and torch.distributed.is_initialized()
                and mesh_lib.n_data_shards() > 1):
            data = data.shard()
        idx, vals = data.local()
        Y = labels.local_like(data).to(idx.device)
        n = data.n
        chunk = min(self.chunk, idx.shape[0])
        seg_rows = int(self.segment_flops / (2.0 * self.d * self.d))
        # a whole number of chunks per segment, at least one
        seg = max(seg_rows // chunk, 1) * chunk
        G = AY = None
        for s in range(0, idx.shape[0], seg):
            G, AY = _normal_eq_pass(idx[s : s + seg], vals[s : s + seg], Y[s : s + seg],
                                    d=self.d, chunk=chunk, G=G, AY=AY)
            if s + seg < idx.shape[0]:
                G[0, 0].item()  # wait for the segment's chunks
        G, AY = data.all_sum(G, AY)
        return EllLinearMapper(_psd_solve_device(G, AY, self.lam * n))

    @property
    def weight(self) -> int:
        return 2


@dataclasses.dataclass(eq=False)
class EllLinearMapper(LinearMapper):
    """LinearMapper whose batch apply takes ELL Datasets directly:
    ``Σ_j vals[r, j] · W[idx[r, j]]`` by a row gather of W (nothing is
    densified)."""

    def apply_batch(self, ds: Dataset) -> Dataset:
        ds = ds.to_array_mode()
        x = ds.local()
        if isinstance(x, tuple):
            if self.feature_scaler is not None:
                raise NotImplementedError(
                    "feature_scaler on ELL input would densify; scale "
                    "before ELL conversion instead"
                )
            idx, vals = x
            W = self.W.to(torch.float32)
            out = torch.einsum("rj,rjk->rk", vals.to(W.device, torch.float32),
                               W[idx.to(W.device, torch.int64)])
            if self.intercept is not None:
                out = (out + self.intercept) * ds.mask().to(out.device)[:, None]
            return Dataset(arrays=out, n=ds.n, mesh=ds.mesh)
        return super().apply_batch(ds)
