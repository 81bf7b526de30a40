"""Linear algebra over row-sharded matrices (counterpart of
``keystone_tpu/parallel/linalg.py``: ``gram``, ``tsqr_r``, ``qr_q``).

A tensor carries no sharding, so each function takes the ``mesh`` its
rows are sharded over: given one, ``A`` is this process's rows (every
shard the same count) and the reductions run over the mesh's example
axes; without one, ``A`` is the whole matrix, as in one process.

- ``gram``: AᵀA, a local product and one ``all_reduce``.
- ``tsqr_r``: the tree QR of mlmatrix's TSQR (DistributedPCA.scala:47) as
  the JAX package's: a local QR per shard, an ``all_gather`` of the (d,
  d) R factors in shard order, one QR of the stack. Both QRs fix the sign
  of R's diagonal, which makes R unique for a full-rank matrix; with one
  shard the tree has one leaf and R is its local QR.
- ``qr_q``: each shard's rows of Q = A R⁻¹ (CholeskyQR with the TSQR R).
- ``tsqr_q``: each shard's rows of the tree's own Q (the local Q times
  its block of the stacked R's Q), as orthogonal as a Householder QR
  whatever A's conditioning; one shard's is ``torch.linalg.qr``'s Q.

``gram`` accumulates and returns float32 whatever the input's type (JAX's
``preferred_element_type``); float32 products run with TF32 off
(``_device.resolve_device``), as JAX's HIGHEST precision. Each function
runs on its input's device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from keystone_tpu_torch.parallel import mesh as mesh_lib


def gram(A: torch.Tensor, mesh: Optional[mesh_lib.Mesh] = None) -> torch.Tensor:
    """AᵀA, accumulated and returned in float32. Narrower inputs are cast
    to float32 first (their products are exact there): on an H100,
    cuBLAS's bf16 product with a float32 output strayed ~30 times further
    from float64 than this at 65,536 rows."""
    a = A if A.dtype == torch.float32 else A.to(torch.float32)
    g = a.T @ a
    return g if mesh is None else mesh_lib.all_reduce_sum_(g, mesh)


def _fix_sign(r: torch.Tensor) -> torch.Tensor:
    s = torch.sign(torch.diagonal(r))
    s = torch.where(s == 0, torch.ones((), dtype=r.dtype, device=r.device), s)
    return r * s[:, None]


def tsqr_r(A: torch.Tensor, mesh: Optional[mesh_lib.Mesh] = None) -> torch.Tensor:
    """R factor of a thin QR of an (n, d) matrix, n >> d, with a
    non-negative diagonal; ``A`` is this shard's rows when ``mesh`` is
    given."""
    r = _fix_sign(torch.linalg.qr(A, mode="r").R)
    if mesh is None or mesh_lib.n_data_shards(mesh) == 1:
        return r
    return _fix_sign(torch.linalg.qr(mesh_lib.all_gather_rows(r, mesh), mode="r").R)


def tsqr_q(A: torch.Tensor, mesh: Optional[mesh_lib.Mesh] = None) -> torch.Tensor:
    """Explicit thin Q of an (n, l) matrix, this shard's rows of it when
    ``mesh`` is given: A_i = Q1_i R_i on each shard, the stacked R's
    [R_1; ...; R_s] = Q2 R, and Q_i = Q1_i · (Q2's block i). Only the
    (l, l) R factors cross processes."""
    if mesh is None or mesh_lib.n_data_shards(mesh) == 1:
        return torch.linalg.qr(A).Q
    l = A.shape[1]
    q1, r1 = torch.linalg.qr(A)
    if r1.shape[0] < l:  # fewer rows than columns here: pad to (l, l)
        q1 = torch.cat([q1, q1.new_zeros((q1.shape[0], l - r1.shape[0]))], dim=1)
        r1 = torch.cat([r1, r1.new_zeros((l - r1.shape[0], l))])
    q2 = torch.linalg.qr(mesh_lib.all_gather_rows(r1, mesh)).Q
    i = mesh_lib.shard_index(mesh)
    return q1 @ q2[i * l : (i + 1) * l]


def qr_q(A: torch.Tensor, mesh: Optional[mesh_lib.Mesh] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Explicit thin Q of an (n, d) matrix (this shard's rows of it when
    ``mesh`` is given) and its R: Q = A R⁻¹ (CholeskyQR-style with the
    TSQR R, one triangular solve)."""
    r = tsqr_r(A, mesh)
    return torch.linalg.solve_triangular(r, A, upper=True, left=False), r
