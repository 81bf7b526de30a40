"""Fused Fisher-vector statistics (counterpart of
``keystone_tpu/ops/images/fv_pallas.py``).

    logits = -0.5 * X² @ (1/σ²) + X @ (μ/σ²) + c
    q      = softmax(logits), thresholded at ``weight_threshold``, renormalized
    s0 = Σ_rows q ;  s1 = Xᵀ q ;  s2 = (X²)ᵀ q,   each / m

On CUDA tensors this is the kernel in ``csrc/fv_stats.cu``, which forms
the GMM terms on the card, never writes the (m, k) posterior to device
memory and reduces its per-slab partial sums in a fixed order (run-to-run
identical output); on CPU tensors it is the plain PyTorch version below.
The kernel takes any ``d`` and ``k``. Up to 64 of both it runs float32 FMA
on the CUDA cores; past 64 of either, its tiled path runs the four products
on the tensor cores in 3xTF32 (each operand split into a TF32 high and low
part), with one pass for each descriptor's max, softmax sum and
thresholded sum over all ``k`` and one that forms each k tile's logits once
and adds q's statistics.

The wrapper reports the function's work to the cost model
(``observability/device.kernel_cost``) by shape, on both routes
(``fisher_vector_stats_work``).
"""

from __future__ import annotations

import math

import torch

from keystone_tpu_torch import _cuda
from keystone_tpu_torch.observability.device import kernel_cost

# Descriptors per block of the d, k <= 64 path, a multiple of its
# 128-descriptor chunk. Two blocks fit on an SM, so a wave of the H100 is
# 264 blocks; at B = 64 both serving descriptor counts give at least two:
# m = 3,136 -> 9 slabs (576 blocks), m = 13,165 -> 35 slabs (2,240).
ROWS_PER_BLOCK = 384
# The tiled path's statistics pass runs one block of (slab, k tile of 64,
# d tile of 128) per SM at a time; its slabs are as long as leaves about
# this many blocks an SM, so that one image fills the card and the partial
# sums (one (1 + 2d) x k set a slab) stay small beside x.
TILED_BLOCKS_PER_SM = 4


def tiled(d: int, k: int) -> bool:
    """Whether the kernel takes its tiled path (tensor cores) at (d, k)."""
    return d > 64 or k > 64


def terms_floats(d: int, k: int) -> int:
    """Floats of the kernel's terms scratch: inv_var, proj and const, then
    (from a multiple of 4) their split into TF32 fragments, 512 floats per
    16 mixtures and 8 rows of d (``frag_offset``, ``frag_floats`` in the
    source)."""
    head = -(-(2 * d + 1) * k // 4) * 4
    return head + (-(-k // 16)) * (-(-d // 8)) * 512


def rows_per_block(B: int, d: int, m: int, k: int, sms: int) -> int:
    """Descriptors a block of the kernel's first (or, tiled, statistics)
    pass takes: ``ROWS_PER_BLOCK`` on the d, k <= 64 path; on the tiled
    path enough slabs for ``TILED_BLOCKS_PER_SM`` blocks on each of the
    card's ``sms`` SMs, rounded up to the 128-descriptor multiple the
    kernel takes."""
    if not tiled(d, k):
        return ROWS_PER_BLOCK
    tiles = -(-k // 64) * -(-d // 128)
    slabs = max(1, -(-TILED_BLOCKS_PER_SM * sms // (tiles * B)))
    per_slab = -(-m // slabs)
    return max(128, -(-per_slab // 128) * 128)


def copy_bytes(x: torch.Tensor) -> int:
    """The width of the tiled path's cp.async copies of x's rows (4·m bytes
    apart): 16 where m % 4 == 0 and x is 16-byte aligned, 8 where m is even
    (and x 8-byte aligned), else 4; as ``launch_tiled`` chooses."""
    m, p = x.shape[-1], x.data_ptr()
    return 16 if m % 4 == 0 and p % 16 == 0 else 8 if m % 2 == 0 and p % 8 == 0 else 4


def fv_flops(B: int, m: int, d: int, k: int) -> int:
    """The statistics' operations at B images of m descriptors: the four
    products (8·d·k a descriptor) and the softmax, threshold and s0
    (12·k)."""
    return B * m * (8 * d * k + 12 * k)


def fisher_vector_stats_work(x, k: int):
    """``(flops, bytes, transcendentals)`` of ``fisher_vector_stats`` on
    x (B, d, m) and k mixtures: ``fv_flops``; x, the GMM's means,
    variances and weights and the (B, 1 + 2d, k) statistics each moved
    once; one exp per descriptor and mixture."""
    B, d, m = x.shape
    nbytes = 4 * (x.numel() + 2 * d * k + k + B * (1 + 2 * d) * k)
    return fv_flops(B, m, d, k), nbytes, B * m * k


def gmm_terms(means, variances, weights):
    """(inv_var (d, k), proj (d, k), const (k,)) of the logits."""
    inv_var = 1.0 / variances
    proj = means / variances
    const = (
        torch.log(weights)
        - 0.5 * torch.sum(torch.log(2.0 * math.pi * variances), dim=0)
        - 0.5 * torch.sum(means * proj, dim=0)
    )
    return inv_var, proj, const


def fisher_vector_stats_plain(x, means, variances, weights, weight_threshold=1e-4):
    inv_var, proj, const = gmm_terms(means, variances, weights)
    xt = x.transpose(1, 2)  # (B, m, d)
    x2 = xt * xt
    logits = -0.5 * torch.matmul(x2, inv_var) + torch.matmul(xt, proj) + const
    logits = logits - torch.amax(logits, dim=-1, keepdim=True)
    q = torch.exp(logits)
    q = q / torch.sum(q, dim=-1, keepdim=True)
    q = torch.where(q > weight_threshold, q, torch.zeros((), dtype=q.dtype, device=q.device))
    q = q / torch.sum(q, dim=-1, keepdim=True)
    inv_m = 1.0 / x.shape[2]
    s0 = torch.sum(q, dim=1)
    s1 = torch.matmul(x, q)
    s2 = torch.matmul(x * x, q)
    return s0 * inv_m, s1 * inv_m, s2 * inv_m


def fisher_vector_stats(x, means, variances, weights, weight_threshold=1e-4):
    """x: (B, d, m) descriptors -> (s0 (B, k), s1 (B, d, k), s2 (B, d, k)),
    each already divided by m, with the GMM's posterior thresholding."""
    for t, name, nd in ((x, "x", 3), (means, "means", 2), (variances, "variances", 2), (weights, "weights", 1)):
        _cuda.check_arg(t, name, nd)
    B, d, m = x.shape
    k = means.shape[1]
    if means.shape != (d, k) or variances.shape != (d, k) or weights.shape != (k,):
        raise ValueError(
            f"GMM shapes disagree with x {tuple(x.shape)}: means "
            f"{tuple(means.shape)}, variances {tuple(variances.shape)}, "
            f"weights {tuple(weights.shape)}"
        )
    if m < 1:
        raise ValueError("x holds no descriptors")
    with kernel_cost("fisher_vector_stats", lambda: fisher_vector_stats_work(x, k)):
        if not _cuda.on_cuda(x, means, variances, weights):
            return fisher_vector_stats_plain(x, means, variances, weights, weight_threshold)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        rows = rows_per_block(B, d, m, k, sms)
        n_blocks = -(-m // rows)
        terms = torch.empty(terms_floats(d, k), dtype=torch.float32, device=x.device)
        # each descriptor's max, softmax sum and thresholded sum, for the tiled
        # path (3/d of x's size)
        norms = torch.empty((B, m, 3) if tiled(d, k) else (0,), dtype=torch.float32, device=x.device)
        partial = torch.empty((B, n_blocks, 1 + 2 * d, k), dtype=torch.float32, device=x.device)
        out = torch.empty((B, 1 + 2 * d, k), dtype=torch.float32, device=x.device)
        lib = _cuda.lib("fv_stats")
        with torch.cuda.device(x.device):
            err = lib.ks_fv_stats(
                x.data_ptr(), means.data_ptr(), variances.data_ptr(), weights.data_ptr(),
                float(weight_threshold), terms.data_ptr(), norms.data_ptr(), partial.data_ptr(),
                out.data_ptr(),
                B, d, m, k, rows, _cuda.stream(x),
            )
        _cuda.check(err, "ks_fv_stats")
        _cuda.count("fisher_vector_stats")
        return out[:, 0], out[:, 1 : 1 + d], out[:, 1 + d :]
