"""Fused Fisher-vector statistics (counterpart of
``keystone_tpu/ops/images/fv_pallas.py``).

    logits = -0.5 * X² @ (1/σ²) + X @ (μ/σ²) + c
    q      = softmax(logits), thresholded at ``weight_threshold``, renormalized
    s0 = Σ_rows q ;  s1 = Xᵀ q ;  s2 = (X²)ᵀ q,   each / m

On CUDA tensors this is the kernel in ``csrc/fv_stats.cu``, which forms
the GMM terms on the card, never writes the (m, k) posterior to device
memory and reduces its per-block partial sums in a fixed order (run-to-run
identical output); on CPU tensors it is the plain PyTorch version below.
The kernel takes any ``d`` and ``k`` up to ``K_BOUND`` mixtures: past 64 of
either it tiles them, with one pass for each descriptor's softmax and
threshold sums over all ``k`` before any statistic.
"""

from __future__ import annotations

import math

import torch

from keystone_tpu_torch import _cuda

# Descriptors per block of the kernel's first pass, a multiple of its
# 128-descriptor chunk. Two blocks fit on an SM, so a wave of the H100 is
# 264 blocks; at B = 64 both serving descriptor counts give at least two:
# m = 3,136 -> 9 slabs (576 blocks), m = 13,165 -> 35 slabs (2,240).
ROWS_PER_BLOCK = 384
# The kernel's one bound: its per-descriptor pass keeps 128 bytes of shared
# memory per mixture. Four times the largest vocabulary of a configuration
# of the JAX package (VOC's 256).
K_BOUND = 1024


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
    if not _cuda.on_cuda(x, means, variances, weights):
        return fisher_vector_stats_plain(x, means, variances, weights, weight_threshold)
    if k > K_BOUND:
        raise ValueError(f"the kernel takes k <= {K_BOUND} mixtures, got k={k}")
    n_blocks = -(-m // ROWS_PER_BLOCK)
    terms = torch.empty((2 * d + 1) * k, dtype=torch.float32, device=x.device)
    # each descriptor's softmax and threshold sums, for the tiled path the
    # kernel takes past d or k = 64 (it alone decides; 3/d of x's size)
    norms = torch.empty((B, m, 3), dtype=torch.float32, device=x.device)
    partial = torch.empty((B, n_blocks, 1 + 2 * d, k), dtype=torch.float32, device=x.device)
    out = torch.empty((B, 1 + 2 * d, k), dtype=torch.float32, device=x.device)
    lib = _cuda.lib("fv_stats")
    with torch.cuda.device(x.device):
        err = lib.ks_fv_stats(
            x.data_ptr(), means.data_ptr(), variances.data_ptr(), weights.data_ptr(),
            float(weight_threshold), terms.data_ptr(), norms.data_ptr(), partial.data_ptr(),
            out.data_ptr(),
            B, d, m, k, ROWS_PER_BLOCK, _cuda.stream(x),
        )
    _cuda.check(err, "ks_fv_stats")
    _cuda.count("fisher_vector_stats")
    return out[:, 0], out[:, 1 : 1 + d], out[:, 1 + d :]
