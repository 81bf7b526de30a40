"""Weighted block coordinate descent for per-class mixture-weighted least
squares — the ImageNet flagship solver (counterpart of
``keystone_tpu/ops/learning/weighted_ls.py``'s
``BlockWeightedLeastSquaresEstimator``).

The objective re-weights each class's examples by ``mixture_weight`` w:
per class c the solve uses the joint statistics
    jointXTX_c = (1−w)·popCov + w·classCov_c + w(1−w)·δ_c δ_cᵀ
    jointXTR_c = (1−w)·popXTR[:,c] + w·classXTR_c − jointMean_c·mmw_c
with δ_c = classMean_c − popMean and
mmw_c = (1−w)·residualMean_c + w·mean(resLocal_c).

Two solvers, as in the JAX package:

- **pcg**: all C per-class systems in one batched, matrix-free CG on the
  original row layout, preconditioned by the explicit inverse of
  (1−w)·popCov + (λ+ε)I. Class membership is a 0/1 matrix P, so every
  per-class contraction is a matmul. The JAX package runs each block's CG
  as one ``while_loop`` and the blocks × epochs as one ``scan``; here both
  are Python loops over device work, and the CG exit test reads the
  residual back once per iteration (testing less often would change the
  iteration count and so the result).
- **chol**: exact per-class covariances over a class-grouped row layout
  (one padded gather, or per-chunk gathers), then a Jacobi-scaled batched
  Cholesky per chunk of classes. The class index building runs on the
  host, as there.

A host-blocks dataset (``Dataset.from_host_blocks``, features in host RAM
as column slabs) takes the pcg solver only, with the dataset's own column
blocks as the coordinate blocks: each slab is uploaded once per sweep
through ``block_ls``'s pooled pinned buffers and copy stream, at most
``SLABS_ON_CARD`` of them on the card.

``PerClassWeightedLeastSquaresEstimator`` solves the same objective class by
class, as reweighted single-output block coordinate descent.

**Rows sharded over processes** (``Dataset.shard``, in memory or as host
blocks): every sum over rows — the class counts, the population and
per-class sums, the Grams and Xᵀ·R, the CG products — is taken over this
process's rows and added over the shards with ``all_sum`` (one
``all_reduce`` per step: per block in the statistics, per iteration in
the CG, per chunk of classes in the chol path); the small solves then run
on every process from the same reduced bytes, so the model is identical
on every one, and with one process it is the unsharded fit bit for bit
(the same code, with sums that are not reduced). The chol path lays out
each process's own rows (grouped or gathered by class): its per-class
covariances are summed over the shards, and no row crosses processes.

All products are float32 ``torch.matmul``s (TF32 off on the card), the
counterpart of the JAX package's ``Precision.HIGHEST``. bf16 and fp16
features stay in their dtype in storage (in memory, in the class-grouped
copy and in host blocks); each column block is upcast to float32 where
the solver reads it, which is exact, since every bf16 or fp16 value is a
float32. The JAX package takes bf16 blocks through 3-limb bf16 products
with float32 outputs (``_limb3``), made for the TPU's MXU; both compute
float32 products of the same bf16 values.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from keystone_tpu_torch.observability.device import device_memory_stats, host_memory_stats
from keystone_tpu_torch.ops.learning.block_ls import BlockLinearMapper, _SlabStream
from keystone_tpu_torch.parallel.dataset import Dataset, all_sum, on_every_shard
from keystone_tpu_torch.workflow.api import LabelEstimator


def _eye(b: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(b, dtype=like.dtype, device=like.device)


def _block(X, start, width):
    """Columns [start, start + width) of ``X`` in float32: a bf16 or fp16
    X is upcast one block at a time, never whole."""
    return X[:, start : start + width].to(torch.float32)


def _chunk_sums(Xc, r_g):
    """Per-class sums over a chunk's rows: Σx (G, b), Σx·r (G, b), Σr (G,)
    and Σxxᵀ (G, b, b). Padded slots of Xc and r_g are zero, so plain sums
    are per-class sums."""
    return (torch.sum(Xc, dim=1), torch.einsum("gmb,gm->gb", Xc, r_g),
            torch.sum(r_g, dim=1), torch.matmul(Xc.transpose(1, 2), Xc))


def _chunk_moments(sums, inv):
    """classCov (G, b, b), classMean (G, b), classXTR (G, b) and
    resLocalMean (G,) from the chunk's sums over every shard's rows."""
    sx, sxr, sr, sxx = sums
    cmean = sx * inv[:, None]
    cxtr = sxr * inv[:, None]
    rlm = sr * inv
    cov = sxx * inv[:, None, None] - cmean[:, :, None] * cmean[:, None, :]
    return cov, cmean, cxtr, rlm


def _class_chunk_stats(Xg, R, wt, class_ids, c0, start, *, G, m, width):
    """``_chunk_sums`` for one chunk of G classes starting at class
    ``c0``, from the class-grouped layout (class c in rows [c·m, (c+1)·m)
    of ``Xg`` and ``R``, padded slots zero)."""
    D = Xg.shape[1]
    C = R.shape[1]
    Xc = Xg.reshape(-1, m, D)[c0 : c0 + G, :, start : start + width].to(torch.float32)
    wc = wt[c0 : c0 + G]
    Rc = R.reshape(-1, m, C)[c0 : c0 + G]
    # resLocal_c = R[rows of c, c]
    r_g = Rc[torch.arange(G, device=R.device), :, class_ids] * wc
    return _chunk_sums(Xc, r_g)


def _class_chunk_stats_gathered(X, R, idx_c, wt_c, class_ids, start, *, width):
    """``_class_chunk_stats`` on the original layout: the chunk's rows are
    gathered, padded only to the chunk's own largest class."""
    Xc = _block(X, start, width)[idx_c] * wt_c[:, :, None]
    r_g = R[idx_c, class_ids[:, None]] * wt_c
    return _chunk_sums(Xc, r_g)


def _group_rows(X, Y, idx, wt, joint_label_mean):
    """One gather into the class-grouped layout: Xg (C·m, D) with padded
    slots zero, and the initial residual R (C·m, C) = (Y − jlm)·wt in the
    same row order. Xg keeps X's dtype (the weights are 0/1)."""
    flat = idx.reshape(-1)
    w = wt.reshape(-1)
    Xg = X[flat] * w[:, None].to(X.dtype)
    R = (Y[flat] - joint_label_mean[None, :]) * w[:, None]
    return Xg, R


def _pop_stats(X, R, mask, start, *, width, n, mesh=None):
    """popMean, popCov, popXTR and residualMean over every shard's rows."""
    Xb = _block(X, start, width)
    s, gram, xtr, r_sum = all_sum(
        mesh, torch.sum(Xb * mask[:, None], dim=0), torch.matmul(Xb.T, Xb),
        torch.matmul(Xb.T, R), torch.sum(R, dim=0))
    pop_mean = s / n
    pop_cov = gram / n - torch.outer(pop_mean, pop_mean)
    return pop_mean, pop_cov, xtr / n, r_sum / n


def _batched_psd_solve(A, B, lam):
    """Solve (A_g + λI) x_g = B_g for a batch of g, by a Jacobi-scaled
    float32 Cholesky (the systems are covariance-normalized, O(1) scale).
    Like ``jnp.linalg.cholesky`` it does not raise on a failed
    factorization."""
    b = A.shape[-1]
    A = A + lam * _eye(b, A)[None]
    d = torch.sqrt(torch.clamp(torch.diagonal(A, dim1=1, dim2=2), min=1e-12))
    An = A / (d[:, :, None] * d[:, None, :])
    L = torch.linalg.cholesky_ex(An).L
    Bn = B / d[:, :, None] if B.ndim == 3 else (B / d)[:, :, None]
    y = torch.linalg.solve_triangular(L, Bn, upper=False)
    x = torch.linalg.solve_triangular(L.transpose(1, 2), y, upper=True)
    return x[:, :, 0] / d if B.ndim == 2 else x / d[:, :, None]


def _apply_delta(X, R, delta, start, *, width):
    return R - torch.matmul(_block(X, start, width), delta)


def _device_memory_limit(device: torch.device) -> int:
    """Memory budget in bytes for the chol path's grouped-copy decision:
    the card's memory on CUDA; on the CPU a quarter of the host RAM still
    available, else 4 GiB. Both read the probes of
    ``observability/device.py``, which the auto-cache rule's budget reads
    too."""
    stats = device_memory_stats(device)
    if stats is not None:
        return stats["bytes_limit"]
    host = host_memory_stats()
    if host and "bytes_limit" in host and "bytes_in_use" in host:
        # a quarter of what is available: the layout copy competes with
        # the data itself and the OS
        return (host["bytes_limit"] - host["bytes_in_use"]) // 4
    return 4 * 1024**3


def _precond_inverse(pop_cov, w, lam):
    """Explicit inverse of the shared CG preconditioner M = (1−w)·popCov +
    (λ+ε·scale)·I, through one Cholesky and a solve against I, so that its
    apply is one matmul per CG iteration. The ε jitter guards a
    rank-deficient population covariance (λ may be 0); it perturbs only
    the preconditioner, never the solution; symmetrizing keeps CG's SPD
    contract."""
    b = pop_cov.shape[0]
    eye = _eye(b, pop_cov)
    eps = 1e-6 * torch.clamp(torch.trace(pop_cov) / b, min=1e-12)
    M = (1.0 - w) * pop_cov + (lam + eps) * eye
    Minv = torch.cholesky_solve(eye, torch.linalg.cholesky(M))
    return (Minv + Minv.T) * 0.5


def _pcg_setup_core(Y, mask, w, n, mesh=None):
    """0/1 class membership P (n, C), per-class inverse counts (over every
    shard), the validity of each class, the joint label mean and the
    initial residual.
    A row's class is its FIRST positive entry: for ±1 indicator labels
    every positive entry ties at +1, so this is the argmax with
    first-index tie-breaking that the chol path (and the reference)
    uses. Rows with no positive entry (pad rows) belong to no class."""
    pos = Y > 0
    first_pos = pos & (torch.cumsum(pos.to(torch.int32), dim=1) == 1)
    P = first_pos.to(torch.float32) * mask[:, None]
    (counts,) = all_sum(mesh, torch.sum(P, dim=0))
    inv_counts = 1.0 / torch.clamp(counts, min=1.0)
    valid = (counts > 0).to(torch.float32)
    # jointLabelMean[c] = 2w + 2(1-w)·n_c/n − 1
    jlm = 2.0 * w + 2.0 * (1.0 - w) * counts / n - 1.0
    R = (Y - jlm[None, :]) * mask[:, None]
    return P, inv_counts, valid, jlm, R


def _pcg_block_core(X, R, P, Wb, inv_counts, valid, start, w, lam,
                    *, width, n, max_iters=96, tol=1e-6, mesh=None):
    """One weighted-BCD block update for all classes at once: population
    stats, the preconditioner's inverse, batched matrix-free PCG over the
    C per-class systems, and the residual update. The matvec is
        A_c v = (1−w)·popCov·v + w·(X_cᵀ(X_c v)/n_c − μ_c(μ_cᵀv))
                + w(1−w)·δ_c(δ_cᵀv) + λv
    so no (C, b, b) covariance is formed. The sums over rows (the
    statistics once, X_bᵀ(P∘z) once per CG iteration) are this process's
    rows' plus an ``all_sum``. Returns (Wb_new, R_new, jointMeans (C, b),
    exit max relative residual, CG iterations)."""
    Xb = _block(X, start, width)
    r = torch.sum(R * P, dim=1)  # own-class residual per row
    gram, xtr, csum, cxtr, r_sum, rl = all_sum(
        mesh, torch.matmul(Xb.T, Xb), torch.matmul(Xb.T, R), torch.matmul(P.T, Xb),
        torch.matmul(Xb.T, P * r[:, None]), torch.sum(R, dim=0), torch.matmul(r, P))
    pop_xtr = xtr / n  # (b, C)
    cmean = csum * inv_counts[:, None]  # (C, b)
    cxtr = cxtr.T * inv_counts[:, None]
    # popMean = Σ_c n_c·classMean_c / n: P excludes pad rows, and empty
    # classes contribute zero
    counts = valid / inv_counts
    pop_mean = torch.matmul(counts, cmean) / n
    pop_cov = gram / n - torch.outer(pop_mean, pop_mean)
    residual_mean = r_sum / n
    rlm = rl * inv_counts

    Minv = _precond_inverse(pop_cov, w, lam)

    mean_diff = cmean - pop_mean[None, :]
    jm = cmean * w + pop_mean[None, :] * (1.0 - w)
    mmw = residual_mean * (1.0 - w) + w * rlm
    joint_xtr = pop_xtr.T * (1.0 - w) + cxtr * w - jm * mmw[:, None]
    rhs = joint_xtr - Wb.T * lam  # (C, b)

    def matvec(v):  # (C, b) -> (C, b)
        pv = (1.0 - w) * torch.matmul(v, pop_cov)
        T = torch.matmul(Xb, v.T)  # (n, C): X_b·v_c for every class c
        z = torch.sum(T * P, dim=1)  # each row's own-class entry
        (xxv,) = all_sum(mesh, torch.matmul(Xb.T, P * z[:, None]))
        xxv = xxv.T  # (C, b)
        ccov_v = xxv * inv_counts[:, None] - cmean * torch.sum(cmean * v, dim=1)[:, None]
        dd = mean_diff * torch.sum(mean_diff * v, dim=1)[:, None] * (w * (1.0 - w))
        return pv + w * ccov_v + dd + lam * v

    tiny = 1e-30
    b_norm = torch.clamp(torch.linalg.vector_norm(rhs, dim=1), min=tiny)

    def rel_res(r_):
        return torch.amax(torch.linalg.vector_norm(r_, dim=1) / b_norm)

    zero = torch.zeros((), dtype=rhs.dtype, device=rhs.device)
    x = torch.zeros_like(rhs)
    res = rhs
    z = torch.matmul(res, Minv)
    p = z
    rz = torch.sum(res * z, dim=1)
    it = 0
    # the exit test syncs the host once per iteration, as the JAX
    # package's while_loop tests it once per iteration on the device
    while it < max_iters and bool(rel_res(res) > tol):
        Ap = matvec(p)
        denom = torch.sum(p * Ap, dim=1)
        alpha = torch.where(denom > 0, rz / torch.clamp(denom, min=tiny), zero)
        x = x + alpha[:, None] * p
        res = res - alpha[:, None] * Ap
        z = torch.matmul(res, Minv)
        rz_new = torch.sum(res * z, dim=1)
        beta = torch.where(rz > 0, rz_new / torch.clamp(rz, min=tiny), zero)
        p = z + beta[:, None] * p
        rz = rz_new
        it += 1

    delta = (x * valid[:, None]).T  # (b, C), empty classes masked
    return (Wb + delta, R - torch.matmul(Xb, delta), jm * valid[:, None],
            rel_res(res), it)


def _pcg_fit_full(X, Y, mask, blocks, w, lam, *, n, num_iter, max_iters=96, tol=1e-5,
                  mesh=None):
    """The whole PCG fit: label setup, then every epoch's block updates in
    order (``X`` this process's rows when ``mesh`` is given). Returns
    (per-block W, per-block joint means, joint label mean, max exit
    relative residual, max CG iterations)."""
    P, inv_counts, valid, jlm, R = _pcg_setup_core(Y, mask, w, n, mesh)
    C = Y.shape[1]
    Wb = {s: torch.zeros((wd, C), dtype=torch.float32, device=X.device) for s, wd in blocks}
    joint_means = {}
    rel, iters = None, 0
    for _ in range(num_iter):
        for s, wd in blocks:
            Wb[s], R, joint_means[s], rel_b, its = _pcg_block_core(
                X, R, P, Wb[s], inv_counts, valid, s, w, lam,
                width=wd, n=n, max_iters=max_iters, tol=tol, mesh=mesh,
            )
            rel = rel_b if rel is None else torch.maximum(rel, rel_b)
            iters = max(iters, its)
    return Wb, joint_means, jlm, rel, iters


@dataclasses.dataclass(eq=False)
class BlockWeightedLeastSquaresEstimator(LabelEstimator):
    """fit(features, ±1 indicator labels) -> BlockLinearMapper.

    Label contract: indicator-style matrices (``ClassLabelIndicators``,
    entries in {−1, +1}). Each row's class is its argmax with first-index
    tie-breaking: multi-hot rows join exactly one class (the first
    positive) in both solver paths."""

    block_size: int
    num_iter: int
    lam: float
    mixture_weight: float
    num_features: Optional[int] = None  # pad/truncate hint, parity only
    class_chunk: int = 16  # classes per batched step (chol path)
    solve: str = "auto"  # "chol" | "pcg" | "auto": pcg when the first
    # block is wide (>= 1024, where the C per-class factorizations
    # dominate) and w <= 0.9 (as w -> 1 the shared popCov preconditioner
    # drains and CG may hit its iteration cap), chol otherwise
    layout: str = "auto"  # chol-path rows: "grouped" (one padded (C, m, ·)
    # gather), "gathered" (per-chunk gathers, for skewed classes or tight
    # memory), "auto" (grouped iff the padding stays within ~1.5n and the
    # copy fits a third of the memory budget)
    convergence_check: str = "warn"  # after a pcg fit, "warn" / "raise"
    # when the max CG exit residual exceeds ``pcg_tol``, or "off"
    pcg_tol: float = 1e-5  # CG exit: relative residual per class

    def fit(self, data: Dataset, labels: Dataset) -> BlockLinearMapper:
        if self.solve not in ("auto", "chol", "pcg"):
            raise ValueError(
                f"solve must be 'auto', 'chol', or 'pcg', got {self.solve!r}"
            )
        if self.convergence_check not in ("off", "warn", "raise"):
            raise ValueError(
                "convergence_check must be 'off', 'warn', or 'raise', "
                f"got {self.convergence_check!r}"
            )
        if self.layout not in ("auto", "grouped", "gathered"):
            raise ValueError(
                "layout must be 'auto', 'grouped', or 'gathered', "
                f"got {self.layout!r}"
            )
        if data.is_host:
            # features in host RAM as column slabs: only the matrix-free
            # PCG solver applies (the chol path's class-grouped row layouts
            # are gathered from an X on the device)
            if self.solve == "chol":
                raise ValueError(
                    "host-blocks datasets require the pcg solver "
                    "(solve='auto' or 'pcg'); the chol path gathers "
                    "class-grouped layouts from a device-resident X"
                )
            return self._fit_pcg_host(data, labels)
        data = data.to_array_mode()
        X = data.local()
        # float32 products of each block, as the JAX package computes
        # with x64 off; X itself keeps its dtype
        Y = labels.local_like(data).to(device=X.device, dtype=torch.float32)
        n = data.n
        D = X.shape[1]
        blocks = [
            (s, min(s + self.block_size, D) - s)
            for s in range(0, D, self.block_size)
        ]
        use_pcg = self.solve == "pcg" or (
            self.solve == "auto"
            and blocks[0][1] >= 1024
            and self.mixture_weight <= 0.9
        )
        if use_pcg:
            return self._fit_pcg(data, X, Y, n, blocks)
        return self._fit_chol(data, X, Y, n, blocks)

    def _fit_pcg(self, data, X, Y, n, blocks):
        Wb, joint_means, jlm, rel, iters = _pcg_fit_full(
            X, Y, data.mask(), blocks, self.mixture_weight, self.lam,
            n=n, num_iter=self.num_iter, tol=self.pcg_tol, mesh=data.mesh,
        )
        self._check_convergence(rel, iters)
        return self._finish(blocks, Wb, joint_means, jlm, {
            "pcg_max_rel_residual": rel, "pcg_iterations": iters,
        })

    def _fit_pcg_host(self, data: Dataset, labels: Dataset) -> BlockLinearMapper:
        """Weighted BCD from host-RAM column slabs: one slab per block per
        sweep through ``_SlabStream`` (pooled pinned buffers, a copy
        stream, at most ``SLABS_ON_CARD`` slabs on the card), the next
        slab's upload issued before the current block's PCG. The slab is
        the block (``start`` 0, the slab's width), and the dataset's own
        column blocks are the coordinate blocks (``block_size`` is not
        read), as the reference's Seq of per-block RDDs defines them.

        The JAX package bounds its run-ahead by forcing the output of the
        step two back, so that at most three slabs are in flight; here the
        three pooled device buffers are all there is, a slab's buffer is
        rewritten only after the block that read it is done with it
        (``release``), and the CG's exit test syncs the host once per
        iteration, so the host never runs ahead of the card by more than
        the next slab's upload."""
        blocks_host = data.host_blocks
        dev = data.device
        mesh = data.mesh
        Y = labels.local_like(data).to(device=dev, dtype=torch.float32)
        n = data.n
        w = self.mixture_weight
        widths = data.block_widths
        starts = np.cumsum([0] + widths[:-1]).tolist()
        blocks = list(zip(starts, widths))
        C = Y.shape[1]

        P, inv_counts, valid, jlm, R = _pcg_setup_core(Y, data.mask(), w, n, mesh)
        Wb = {s: torch.zeros((wd, C), dtype=torch.float32, device=dev) for s, wd in blocks}
        joint_means = {}
        rel, iters = None, 0
        slabs = _SlabStream(blocks_host, dev)
        schedule = [bi for _ in range(self.num_iter) for bi in range(len(blocks))]
        nxt = slabs.put(schedule[0])
        for j, bi in enumerate(schedule):
            cur = nxt
            if j + 1 < len(schedule):
                nxt = slabs.put(schedule[j + 1])
            s, wd = blocks[bi]
            Xb = slabs.acquire(cur).to(torch.float32)
            Wb[s], R, joint_means[s], rel_b, its = _pcg_block_core(
                Xb, R, P, Wb[s], inv_counts, valid, 0, w, self.lam,
                width=wd, n=n, tol=self.pcg_tol, mesh=mesh,
            )
            slabs.release(cur)
            rel = rel_b if rel is None else torch.maximum(rel, rel_b)
            iters = max(iters, its)

        self._check_convergence(rel, iters)
        return self._finish(blocks, Wb, joint_means, jlm, {
            "pcg_max_rel_residual": rel, "pcg_iterations": iters,
        })

    def _check_convergence(self, pcg_rel, pcg_iters) -> None:
        if self.convergence_check == "off":
            return
        rel_val = float(pcg_rel)
        if rel_val > self.pcg_tol:
            msg = (
                f"weighted PCG hit its iteration cap "
                f"(max {int(pcg_iters)} iters) with max relative "
                f"residual {rel_val:.2e} > tol {self.pcg_tol:.0e}; "
                "the fit may be under-converged — try solve='chol', "
                "a smaller mixture_weight, or a larger lam"
            )
            if self.convergence_check == "raise":
                raise RuntimeError(msg)
            warnings.warn(msg, stacklevel=2)

    def _fit_chol(self, data, X, Y, n, blocks):
        """Exact batched per-class Cholesky. The class index building runs
        on the host; the weighted solve is row-permutation invariant, so
        the layout changes nothing numerically. On sharded rows each
        process lays out its own rows, the layout's choice is the one
        every process can hold, and the per-chunk class sums are added
        over the shards before the solve."""
        w = self.mixture_weight
        D = X.shape[1]
        C = Y.shape[1]
        dev = X.device
        mesh = data.mesh
        n_here = data.local_valid
        class_of = torch.argmax(Y, dim=1)[:n_here].cpu().numpy()
        counts_here = np.bincount(class_of, minlength=C).astype(np.int64)
        (counts,) = all_sum(mesh, torch.as_tensor(counts_here, device=dev))
        counts = counts.cpu().numpy()
        # classes with no examples get no model update
        valid_class = counts > 0
        m = max(int(counts_here.max()), 1)
        grouped_bytes = (C * m) * (D * X.element_size() + C * 4)
        if self.layout == "auto":
            fits = (
                C * m <= int(1.5 * n_here) + 4096
                and grouped_bytes <= 0.33 * _device_memory_limit(dev)
            )
            # one layout on every process: they must reduce the same chunks
            use_grouped = on_every_shard(mesh, fits, dev)
        else:
            use_grouped = self.layout == "grouped"
        # clamp to 1 so empty-class divisions stay finite; their zero wt
        # rows already zero the numerators, and their delta is masked out
        counts_j = torch.as_tensor(np.maximum(counts, 1), dtype=torch.float32, device=dev)
        valid_j = torch.as_tensor(valid_class, dtype=torch.float32, device=dev)
        # jointLabelMean[c] = 2w + 2(1-w)·n_c/n − 1
        joint_label_mean = torch.as_tensor(
            (2 * w + 2 * (1 - w) * counts / n - 1.0).astype(np.float32), device=dev
        )

        rows_of = {c: np.flatnonzero(class_of == c) for c in range(C)}
        if use_grouped:
            idx = np.zeros((C, m), np.int64)
            wt = np.zeros((C, m), np.float32)
            for c in range(C):
                idx[c, : counts_here[c]] = rows_of[c]
                wt[c, : counts_here[c]] = 1.0
            wt = torch.as_tensor(wt, device=dev)
            XX, R = _group_rows(X, Y, torch.as_tensor(idx, device=dev), wt, joint_label_mean)
            mask = wt.reshape(-1)
            chunk_order = list(range(C))
        else:
            XX = X
            mask = data.mask()
            R = (Y - joint_label_mean[None, :]) * mask[:, None]
            # classes in descending size order, so same-size classes share
            # a chunk and each chunk's padding stays small
            chunk_order = list(np.argsort(-counts, kind="stable"))

        chunks = [chunk_order[g : g + self.class_chunk] for g in range(0, C, self.class_chunk)]
        if not use_grouped:
            # per-chunk gather indices, padded to the chunk's own largest
            # class (on this process) rounded up to a power of two
            chunk_idx = {}
            for ci, chunk in enumerate(chunks):
                mc = max(1, max(int(counts_here[c]) for c in chunk))
                mc = 1 << (mc - 1).bit_length()
                ic = np.zeros((len(chunk), mc), np.int64)
                wc = np.zeros((len(chunk), mc), np.float32)
                for g, c in enumerate(chunk):
                    ic[g, : counts_here[c]] = rows_of[c]
                    wc[g, : counts_here[c]] = 1.0
                chunk_idx[ci] = (torch.as_tensor(ic, device=dev), torch.as_tensor(wc, device=dev))

        Wb = {s: torch.zeros((wd, C), dtype=torch.float32, device=dev) for s, wd in blocks}
        joint_means = {}  # per block: (C, b)
        for _ in range(self.num_iter):
            for s, wd in blocks:
                pop_mean, pop_cov, pop_xtr, residual_mean = _pop_stats(
                    XX, R, mask, s, width=wd, n=n, mesh=mesh)
                delta = torch.zeros((wd, C), dtype=torch.float32, device=dev)
                jm_block = torch.zeros((C, wd), dtype=torch.float32, device=dev)
                for ci, chunk in enumerate(chunks):
                    cids = torch.as_tensor(np.asarray(chunk, np.int64), device=dev)
                    if use_grouped:
                        sums = _class_chunk_stats(XX, R, wt, cids, int(chunk[0]), s,
                                                 G=len(chunk), m=m, width=wd)
                    else:
                        ic, wc = chunk_idx[ci]
                        sums = _class_chunk_stats_gathered(XX, R, ic, wc, cids, s, width=wd)
                    ccov, cmean, cxtr, rlm = _chunk_moments(all_sum(mesh, *sums),
                                                          1.0 / counts_j[cids])
                    mean_diff = cmean - pop_mean[None, :]
                    joint_xtx = (
                        pop_cov[None] * (1.0 - w)
                        + ccov * w
                        + mean_diff[:, :, None] * mean_diff[:, None, :] * ((1.0 - w) * w)
                    )
                    jm = cmean * w + pop_mean[None, :] * (1.0 - w)
                    mmw = residual_mean[cids] * (1.0 - w) + w * rlm
                    joint_xtr = pop_xtr[:, cids].T * (1.0 - w) + cxtr * w - jm * mmw[:, None]
                    rhs = joint_xtr - Wb[s][:, cids].T * self.lam
                    dW = _batched_psd_solve(joint_xtx, rhs, self.lam)
                    v = valid_j[cids][:, None]
                    delta[:, cids] = (dW * v).T
                    jm_block[cids] = jm * v
                Wb[s] = Wb[s] + delta
                joint_means[s] = jm_block
                R = _apply_delta(XX, R, delta, s, width=wd)
        return self._finish(blocks, Wb, joint_means, joint_label_mean, None)

    def _finish(self, blocks, Wb, joint_means, joint_label_mean, solver_info):
        W = torch.cat([Wb[s] for s, _ in blocks], dim=0)
        jm_full = torch.cat([joint_means[s] for s, _ in blocks], dim=1)  # (C, D)
        # finalB = jointLabelMean − Σ_d jointMeans[c,d]·W[d,c]
        intercept = joint_label_mean - torch.einsum("cd,dc->c", jm_full, W)
        return BlockLinearMapper(
            W, self.block_size, explicit_intercept=intercept,
            solver_info=solver_info,
        )

    @property
    def weight(self) -> int:
        return (3 * self.num_iter) + 1


def _rwls_block_step(X, mu_b, B, y_zm, res, Wb, aTa, lam, start, *, width, first_pass,
                     mesh=None):
    """One reweighted least-squares block update for one class
    (ReWeightedLeastSquares.scala:80-137):
        aTa   = X̃ᵀ(B ∘ X̃)               (first pass, kept)
        res'  = res − B ∘ (X̃ W_old)
        aTb   = X̃ᵀ(B ∘ y − res')
        W_new = (aTa + λI) \\ aTb          (Cholesky; no raise on failure)
        res   = res' + B ∘ (X̃ W_new)
    with X̃ the block centered by the class's joint feature mean and its
    pad rows (B = 0) zeroed; aTa and aTb summed over every shard's rows."""
    Xb = _block(X, start, width)
    Xzm = (Xb - mu_b[None, :]) * (B > 0).to(Xb.dtype)[:, None]
    BX = Xzm * B[:, None]
    res_upd = res - torch.matmul(BX, Wb)
    aTb = torch.matmul(Xzm.T, (y_zm * B)[:, None] - res_upd)
    if first_pass:
        aTa, aTb = all_sum(mesh, torch.matmul(Xzm.T, BX), aTb)
    else:
        (aTb,) = all_sum(mesh, aTb)
    L = torch.linalg.cholesky_ex(aTa + lam * _eye(width, aTa)).L
    Wb_new = torch.cholesky_solve(aTb, L)
    return Wb_new, res_upd + torch.matmul(BX, Wb_new), aTa


@dataclasses.dataclass(eq=False)
class PerClassWeightedLeastSquaresEstimator(LabelEstimator):
    """The mixture-weighted objective solved class by class, as reweighted
    single-output block coordinate descent
    (PerClassWeightedLeastSquares.scala:31, 63-227). Class c's row weights
    are (1−w)/n everywhere plus w/n_c on its own rows; features are centered
    by the class's joint mean w·classMean_c + (1−w)·popMean, labels by the
    joint label mean 2w + 2(1−w)·n_c/n − 1. The loop over classes, epochs
    and blocks runs on the data's device; on sharded rows each sum over
    rows is this process's plus an ``all_sum``."""

    block_size: int
    num_iter: int
    lam: float
    mixture_weight: float
    num_features: Optional[int] = None  # pad/truncate hint, parity only

    def fit(self, data: Dataset, labels: Dataset) -> BlockLinearMapper:
        data = data.to_array_mode()
        mesh = data.mesh
        X = data.local()
        dev = X.device
        Y = labels.local_like(data).to(device=dev, dtype=torch.float32)
        n = data.n
        pn, D = X.shape
        C = Y.shape[1]
        w = self.mixture_weight
        mask = data.mask()

        n_here = data.local_valid
        class_of = torch.argmax(Y, dim=1)[:n_here]
        (counts,) = all_sum(mesh, torch.bincount(class_of, minlength=C).to(torch.float64))
        if bool((counts == 0).any()):
            raise ValueError("every class needs at least one example")

        blocks = [(s, min(s + self.block_size, D) - s) for s in range(0, D, self.block_size)]
        # the means in float64, as the JAX package takes them in numpy;
        # the sums in float32, one block at a time
        onehot = torch.zeros((pn, C), dtype=torch.float32, device=dev)
        onehot[torch.arange(n_here, device=dev), class_of] = 1.0
        pop_sum, class_sums = all_sum(
            mesh,
            torch.cat([torch.sum(_block(X, s, wd) * mask[:, None], dim=0) for s, wd in blocks]),
            torch.cat([torch.matmul(onehot.T, _block(X, s, wd)) for s, wd in blocks], dim=1))
        pop_mean = pop_sum / n
        class_means = class_sums.to(torch.float64) / counts[:, None]
        jfm = class_means * w + pop_mean.to(torch.float64)[None, :] * (1.0 - w)
        joint_label_mean = (2.0 * w + 2.0 * (1.0 - w) * counts / n - 1.0).to(torch.float32)

        W = torch.zeros((D, C), dtype=torch.float32, device=dev)
        neg_wt = (1.0 - w) / n
        for c in range(C):
            # the class's share added in float64 and rounded once, as numpy
            # adds a float64 scalar to the float32 weights
            B = (torch.full((pn,), neg_wt, dtype=torch.float32, device=dev) * mask).to(torch.float64)
            B[torch.nonzero(class_of == c).flatten()] += w / counts[c]
            B = B.to(torch.float32)
            y_zm = (Y[:, c] - joint_label_mean[c]) * mask
            res = torch.zeros((pn, 1), dtype=torch.float32, device=dev)
            Wb = {s: torch.zeros((wd, 1), dtype=torch.float32, device=dev) for s, wd in blocks}
            aTa = {s: None for s, _ in blocks}
            mu = {s: jfm[c, s : s + wd].to(torch.float32) for s, wd in blocks}
            for it in range(self.num_iter):
                for s, wd in blocks:
                    Wb[s], res, aTa[s] = _rwls_block_step(
                        X, mu[s], B, y_zm, res, Wb[s], aTa[s], self.lam, s,
                        width=wd, first_pass=(it == 0), mesh=mesh,
                    )
            W[:, c] = torch.cat([Wb[s][:, 0] for s, _ in blocks])

        intercept = joint_label_mean - torch.einsum("cd,dc->c", jfm.to(torch.float32), W)
        return BlockLinearMapper(W, self.block_size, explicit_intercept=intercept)
