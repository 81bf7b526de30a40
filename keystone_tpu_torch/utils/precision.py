"""Shared float32 matmul policy.

The JAX package asks for ``Precision.HIGHEST`` on float32 operands. On the
card a float32 ``torch.matmul`` is full float32 as long as TF32 stays off,
which ``_device.resolve_device`` ensures before the port serves. When both
operands are bf16 the product stays bf16, as in the JAX package.
"""

from __future__ import annotations

import torch


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``; any float32 operand gives a float32 product."""
    if a.dtype == torch.float32 or b.dtype == torch.float32:
        return torch.matmul(a.to(torch.float32), b.to(torch.float32))
    return torch.matmul(a, b)
