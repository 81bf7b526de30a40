"""GEMM-sandwich kernels of the SIFT and LCS extractors (counterpart of
``keystone_tpu/ops/images/pallas_kernels.py``).

- ``sift_bin_sample``: trilinear orientation binning of the gradient
  magnitude fused with the two sampling-matrix products, ``(B, 8, M, N)``.
  The ``(B, 8, H, W)`` plane stack never exists in device memory, and the
  kernel walks only the band of each operator row and column
  (``sift_bands``).
- ``plane_sandwich``: ``out[b, p] = at @ planes[b, p] @ b_mat`` over a
  ``(B, P, H, W)`` stack, each plane kept on chip between its two products.

Both are CUDA kernels (``csrc/sift_bin.cu``, ``csrc/sandwich.cu``) on CUDA
tensors and their plain PyTorch versions on CPU tensors; any other device
raises. The plain versions materialise the planes and use ``matmul`` in
float32.
"""

from __future__ import annotations

import torch

from keystone_tpu_torch import _cuda

NUM_ORIENTATIONS = 8


def band_extents(op: torch.Tensor, dim: int) -> torch.Tensor:
    """int32 ``(2, n)``: ``[lo, hi)`` of the nonzeros of each slice of the
    2-D ``op`` along ``dim`` (``dim=1``: each row; ``dim=0``: each column).
    An all-zero slice gives ``lo == hi == 0``."""
    n = op.shape[dim]
    idx = torch.arange(n, dtype=torch.int32, device=op.device)
    idx = idx.view(-1, 1) if dim == 0 else idx.view(1, -1)
    nz = op != 0
    lo = torch.where(nz, idx, n).amin(dim)
    hi = torch.where(nz, idx + 1, 0).amax(dim)
    return torch.stack([torch.where(hi > 0, lo, 0), hi])


def sift_bands(ayt: torch.Tensor, ax: torch.Tensor):
    """What ``sift_bin_sample`` needs to know of its operators:
    ``(band_extents(ayt, 1), band_extents(ax, 0), row_order)``, the rows of
    ``ayt`` sorted by band start (stable) as int32, so that the rows the
    kernel takes together share most of their band."""
    rows = band_extents(ayt, 1)
    order = torch.argsort(rows[0], stable=True).to(torch.int32)
    return rows, band_extents(ax, 0), order


def _check_bands(bands, ayt, ax):
    """Raise unless ``bands`` has the form ``sift_bands`` gives: contiguous
    int32 on ``ayt``'s device, of shapes (2, M), (2, N) and (M,)."""
    if not isinstance(bands, (tuple, list)) or len(bands) != 3:
        raise ValueError("bands must be (ayt row extents, ax column extents, row order)")
    M, N = ayt.shape[0], ax.shape[1]
    for t, shape, name in zip(bands, ((2, M), (2, N), (M,)), ("ayt extents", "ax extents", "row order")):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError(f"{name} must be an int32 tensor")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.device != ayt.device:
            raise ValueError(f"{name} on device {t.device}, operators on {ayt.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


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
    mag: torch.Tensor, orient: torch.Tensor, ayt: torch.Tensor, ax: torch.Tensor,
    bands=None,
) -> torch.Tensor:
    """Fused trilinear orientation binning + spatial-binning GEMMs.

    ``mag``/``orient``: (B, H, W) gradient magnitude and continuous
    orientation (angle / 2π · 8); ``ayt``: (M, H) transposed y-axis
    sampling matrix; ``ax``: (W, N) x-axis sampling matrix. ``bands``:
    ``sift_bands(ayt, ax)``, computed here when not given; the kernel skips
    the operators' zeros outside the extents, so they must be the
    operators' own. Returns (B, 8, M, N)."""
    for t, name, nd in ((mag, "mag", 3), (orient, "orient", 3), (ayt, "ayt", 2), (ax, "ax", 2)):
        _cuda.check_arg(t, name, nd)
    B, H, W = mag.shape
    M, N = ayt.shape[0], ax.shape[1]
    if orient.shape != mag.shape or ayt.shape[1] != H or ax.shape[0] != W:
        raise ValueError(
            f"shapes disagree: mag {tuple(mag.shape)}, orient "
            f"{tuple(orient.shape)}, ayt {tuple(ayt.shape)}, ax {tuple(ax.shape)}"
        )
    if bands is not None:
        _check_bands(bands, ayt, ax)
    if not _cuda.on_cuda(mag, orient, ayt, ax):
        return sift_bin_sample_plain(mag, orient, ayt, ax)
    if bands is None:
        bands = sift_bands(ayt, ax)
    ay_b, ax_b, order = bands
    out = torch.empty((B, NUM_ORIENTATIONS, M, N), dtype=torch.float32, device=mag.device)
    lib = _cuda.lib("sift_bin")
    with torch.cuda.device(mag.device):
        err = lib.ks_sift_bin_sample(
            mag.data_ptr(), orient.data_ptr(), ayt.data_ptr(), ax.data_ptr(),
            ay_b[0].data_ptr(), ay_b[1].data_ptr(), ax_b[0].data_ptr(),
            ax_b[1].data_ptr(), order.data_ptr(), out.data_ptr(), B, H, W, M, N,
            _cuda.stream(mag),
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
