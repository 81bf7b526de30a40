"""GEMM-sandwich kernels of the SIFT and LCS extractors (counterpart of
``keystone_tpu/ops/images/pallas_kernels.py``).

- ``sift_bin_sample``: trilinear orientation binning of the gradient
  magnitude fused with the two sampling-matrix products, ``(B, 8, M, N)``.
  The ``(B, 8, H, W)`` plane stack never exists in device memory.
- ``plane_sandwich``: ``out[b, p] = at @ planes[b, p] @ b_mat`` over a
  ``(B, P, H, W)`` stack, each plane kept on chip between its two products.

Both are CUDA kernels (``csrc/sandwich.cu``) on CUDA tensors and their
plain PyTorch versions on CPU tensors; any other device raises. The plain
versions materialise the planes and use ``matmul`` in float32.
"""

from __future__ import annotations

import torch

from keystone_tpu_torch import _cuda

NUM_ORIENTATIONS = 8

def orientation_planes(mag: torch.Tensor, orient: torch.Tensor) -> torch.Tensor:
    """(B, H, W) magnitude and continuous orientation in [0, 8) ->
    (B, 8, H, W) trilinear orientation planes (the vl_dsift binning)."""
    b0f = torch.floor(orient)
    frac = orient - b0f
    b0 = torch.remainder(b0f.to(torch.int32), NUM_ORIENTATIONS)
    b1 = torch.remainder(b0 + 1, NUM_ORIENTATIONS)
    t = torch.arange(NUM_ORIENTATIONS, device=mag.device).view(1, -1, 1, 1)
    zero = torch.zeros((), dtype=mag.dtype, device=mag.device)
    share = torch.where(b0[:, None] == t, 1.0 - frac[:, None], zero) + torch.where(
        b1[:, None] == t, frac[:, None], zero
    )
    return mag[:, None] * share


def sift_bin_sample_plain(mag, orient, ayt, ax):
    return torch.matmul(torch.matmul(ayt, orientation_planes(mag, orient)), ax)


def plane_sandwich_plain(planes, at, b):
    return torch.matmul(torch.matmul(at, planes), b)


def sift_bin_sample(
    mag: torch.Tensor, orient: torch.Tensor, ayt: torch.Tensor, ax: torch.Tensor
) -> torch.Tensor:
    """Fused trilinear orientation binning + spatial-binning GEMMs.

    ``mag``/``orient``: (B, H, W) gradient magnitude and continuous
    orientation (angle / 2π · 8); ``ayt``: (M, H) transposed y-axis
    sampling matrix; ``ax``: (W, N) x-axis sampling matrix. Returns
    (B, 8, M, N)."""
    for t, name, nd in ((mag, "mag", 3), (orient, "orient", 3), (ayt, "ayt", 2), (ax, "ax", 2)):
        _cuda.check_arg(t, name, nd)
    B, H, W = mag.shape
    M, N = ayt.shape[0], ax.shape[1]
    if orient.shape != mag.shape or ayt.shape[1] != H or ax.shape[0] != W:
        raise ValueError(
            f"shapes disagree: mag {tuple(mag.shape)}, orient "
            f"{tuple(orient.shape)}, ayt {tuple(ayt.shape)}, ax {tuple(ax.shape)}"
        )
    if not _cuda.on_cuda(mag, orient, ayt, ax):
        return sift_bin_sample_plain(mag, orient, ayt, ax)
    out = torch.empty((B, NUM_ORIENTATIONS, M, N), dtype=torch.float32, device=mag.device)
    lib = _cuda.lib("sandwich")
    with torch.cuda.device(mag.device):
        err = lib.ks_sift_bin_sample(
            mag.data_ptr(), orient.data_ptr(), ayt.data_ptr(), ax.data_ptr(),
            out.data_ptr(), B, H, W, M, N, _cuda.stream(mag),
        )
    _cuda.check(err, f"ks_sift_bin_sample (W={W})")
    _cuda.LAUNCHES["sift_bin_sample"] += 1
    return out


def plane_sandwich(planes: torch.Tensor, at: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, P, M, N) GEMM sandwich ``out[i, p] = at @ planes[i, p] @ b`` —
    the LCS box-filter→sample stage over the stacked image/image² channel
    planes (``at``: (M, H), ``b``: (W, N))."""
    _cuda.check_arg(planes, "planes", 4)
    _cuda.check_arg(at, "at", 2)
    _cuda.check_arg(b, "b", 2)
    B, P, H, W = planes.shape
    M, N = at.shape[0], b.shape[1]
    if at.shape[1] != H or b.shape[0] != W:
        raise ValueError(
            f"shapes disagree: planes {tuple(planes.shape)}, at "
            f"{tuple(at.shape)}, b {tuple(b.shape)}"
        )
    if not _cuda.on_cuda(planes, at, b):
        return plane_sandwich_plain(planes, at, b)
    out = torch.empty((B, P, M, N), dtype=torch.float32, device=planes.device)
    lib = _cuda.lib("sandwich")
    with torch.cuda.device(planes.device):
        err = lib.ks_plane_sandwich(
            planes.data_ptr(), at.data_ptr(), b.data_ptr(), out.data_ptr(),
            B, P, H, W, M, N, _cuda.stream(planes),
        )
    _cuda.check(err, f"ks_plane_sandwich (W={W})")
    _cuda.LAUNCHES["plane_sandwich"] += 1
    return out
