"""Linear algebra on one device (counterpart of
``keystone_tpu/parallel/linalg.py``'s ``tsqr_r``).

The JAX package QRs each data shard and then the stacked R factors; on
one device that tree has one leaf, so ``tsqr_r`` is one QR. Both fix the
sign of R's diagonal, which makes R unique for a full-rank matrix.
"""

from __future__ import annotations

import torch


def _fix_sign(r: torch.Tensor) -> torch.Tensor:
    s = torch.sign(torch.diagonal(r))
    s = torch.where(s == 0, torch.ones((), dtype=r.dtype, device=r.device), s)
    return r * s[:, None]


def tsqr_r(A: torch.Tensor) -> torch.Tensor:
    """R factor of a thin QR of an (n, d) matrix, with a non-negative
    diagonal."""
    return _fix_sign(torch.linalg.qr(A, mode="r").R)
