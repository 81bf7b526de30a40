"""GEMM-sandwich kernels of the SIFT and LCS extractors (counterpart of
``keystone_tpu/ops/images/pallas_kernels.py``).

- ``sift_bin_sample``: trilinear orientation binning of the gradient
  magnitude fused with the two sampling-matrix products, ``(B, 8, M, N)``.
  The ``(B, 8, H, W)`` plane stack never exists in device memory.
- ``plane_sandwich``: ``out[b, p] = at @ planes[b, p] @ b_mat`` over a
  ``(B, P, H, W)`` stack, each plane's first product kept on chip until
  the second.

Both kernels walk only the band of each operator row and column: the
extents, and a row order that groups rows of like band, come from the
operators (``operator_bands``) and are cached with them by the
extractors.

Both are CUDA kernels (``csrc/sift_bin.cu``, ``csrc/sandwich.cu``) on CUDA
tensors and their plain PyTorch versions on CPU tensors; any other device
raises. The plain versions materialise the planes and use ``matmul`` in
float32.

Each wrapper reports its function's work to the cost model
(``observability/device.kernel_cost``) by shape, on both routes:
``band_flops`` over the operators' bands, and each input read once and the
output written once (``sift_bin_sample_work``, ``plane_sandwich_work``).
"""

from __future__ import annotations

import torch

from keystone_tpu_torch import _cuda
from keystone_tpu_torch.observability.device import kernel_cost

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


def operator_bands(left: torch.Tensor, right: torch.Tensor):
    """What a banded sandwich ``left @ Z @ right`` needs to know of its
    operators: ``(band_extents(left, 1), band_extents(right, 0),
    row_order)``, the rows of ``left`` sorted by band start (stable) as
    int32, so that the rows a kernel takes together share most of their
    band."""
    rows = band_extents(left, 1)
    order = torch.argsort(rows[0], stable=True).to(torch.int32)
    return rows, band_extents(right, 0), order


def _check_bands(bands, left, right):
    """Raise unless ``bands`` has the form ``operator_bands`` gives:
    contiguous int32 on ``left``'s device, of shapes (2, M), (2, N) and
    (M,)."""
    if not isinstance(bands, (tuple, list)) or len(bands) != 3:
        raise ValueError("bands must be (row extents, column extents, row order)")
    M, N = left.shape[0], right.shape[1]
    for t, shape, name in zip(bands, ((2, M), (2, N), (M,)), ("row extents", "column extents", "row order")):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError(f"{name} must be an int32 tensor")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.device != left.device:
            raise ValueError(f"{name} on device {t.device}, operators on {left.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def band_flops(row_bands, col_bands, z_cols: int, t1_rows: int, reps: int) -> int:
    """FLOPs of ``reps`` sandwiches ``At · Z · B`` over the operators'
    bands: 2 · (Σ band widths) · (other extent) per product, with the row
    bands of At, the column bands of B, Z's column count and T1 = At · Z's
    row count."""
    wr = int((row_bands[1] - row_bands[0]).sum())
    wc = int((col_bands[1] - col_bands[0]).sum())
    return 2 * reps * (wr * z_cols + wc * t1_rows)


def sift_bin_sample_work(mag, ayt, ax, bands=None):
    """``(flops, bytes)`` of ``sift_bin_sample``: the two banded products
    over the 8 orientation planes of each image, and mag, orient, the
    operators and the (B, 8, M, N) output each moved once."""
    B, H, W = mag.shape
    M, N = ayt.shape[0], ax.shape[1]
    if bands is None:
        bands = operator_bands(ayt, ax)
    flops = band_flops(bands[0], bands[1], W, M, B * NUM_ORIENTATIONS)
    nbytes = 4 * (2 * B * H * W + ayt.numel() + ax.numel() + B * NUM_ORIENTATIONS * M * N)
    return flops, nbytes


def plane_sandwich_work(planes, at, b, bands=None):
    """``(flops, bytes)`` of ``plane_sandwich``: the two banded products
    of each of the B·P planes, and the planes, operators and (B, P, M, N)
    output each moved once."""
    B, P, H, W = planes.shape
    M, N = at.shape[0], b.shape[1]
    if bands is None:
        bands = operator_bands(at, b)
    flops = band_flops(bands[0], bands[1], W, M, B * P)
    nbytes = 4 * (planes.numel() + at.numel() + b.numel() + B * P * M * N)
    return flops, nbytes


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
    ``operator_bands(ayt, ax)``, computed here when not given; the kernel skips
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
    with kernel_cost("sift_bin_sample", lambda: sift_bin_sample_work(mag, ayt, ax, bands)):
        if not _cuda.on_cuda(mag, orient, ayt, ax):
            return sift_bin_sample_plain(mag, orient, ayt, ax)
        if bands is None:
            bands = operator_bands(ayt, ax)
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
        _cuda.count("sift_bin_sample")
        return out


def plane_sandwich(
    planes: torch.Tensor, at: torch.Tensor, b: torch.Tensor, bands=None
) -> torch.Tensor:
    """(B, P, M, N) GEMM sandwich ``out[i, p] = at @ planes[i, p] @ b`` —
    the LCS box-filter→sample stage over the stacked image/image² channel
    planes (``at``: (M, H), ``b``: (W, N)). ``bands``:
    ``operator_bands(at, b)``, computed here when not given; the kernel
    skips the operators' zeros outside the extents, so they must be the
    operators' own."""
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
    if bands is not None:
        _check_bands(bands, at, b)
    with kernel_cost("plane_sandwich", lambda: plane_sandwich_work(planes, at, b, bands)):
        if not _cuda.on_cuda(planes, at, b):
            return plane_sandwich_plain(planes, at, b)
        if bands is None:
            bands = operator_bands(at, b)
        at_b, b_b, order = bands
        out = torch.empty((B, P, M, N), dtype=torch.float32, device=planes.device)
        lib = _cuda.lib("sandwich")
        with torch.cuda.device(planes.device):
            err = lib.ks_plane_sandwich(
                planes.data_ptr(), at.data_ptr(), b.data_ptr(), at_b[0].data_ptr(),
                at_b[1].data_ptr(), b_b[0].data_ptr(), b_b[1].data_ptr(),
                order.data_ptr(), out.data_ptr(), B, P, H, W, M, N, _cuda.stream(planes),
            )
        _cuda.check(err, f"ks_plane_sandwich (W={W})")
        _cuda.count("plane_sandwich")
        return out
