"""Linear algebra on one device (counterpart of
``keystone_tpu/parallel/linalg.py``: ``gram``, ``tsqr_r``, ``qr_q``).

The JAX package QRs each data shard and then the stacked R factors; on
one device that tree has one leaf, so ``tsqr_r`` is one QR. Both fix the
sign of R's diagonal, which makes R unique for a full-rank matrix.
``gram`` is one product with float32 accumulation and a float32 result
whatever the input's type (JAX's ``preferred_element_type``); float32
products run with TF32 off (``_device.resolve_device``), as JAX's
HIGHEST precision. Each function runs on its input's device.
"""

from __future__ import annotations

from typing import Tuple

import torch


def gram(A: torch.Tensor) -> torch.Tensor:
    """AᵀA, accumulated and returned in float32. Narrower inputs are cast
    to float32 first (their products are exact there): on an H100,
    cuBLAS's bf16 product with a float32 output strayed ~30 times further
    from float64 than this at 65,536 rows."""
    a = A if A.dtype == torch.float32 else A.to(torch.float32)
    return a.T @ a


def _fix_sign(r: torch.Tensor) -> torch.Tensor:
    s = torch.sign(torch.diagonal(r))
    s = torch.where(s == 0, torch.ones((), dtype=r.dtype, device=r.device), s)
    return r * s[:, None]


def tsqr_r(A: torch.Tensor) -> torch.Tensor:
    """R factor of a thin QR of an (n, d) matrix, with a non-negative
    diagonal."""
    return _fix_sign(torch.linalg.qr(A, mode="r").R)


def qr_q(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Explicit thin Q of an (n, d) matrix and its R: Q = A R⁻¹
    (CholeskyQR-style with the TSQR R, one triangular solve)."""
    r = tsqr_r(A)
    return torch.linalg.solve_triangular(r, A, upper=True, left=False), r
