"""Kernel ridge regression by block Gauss-Seidel on the dual
(arXiv:1602.05310), with RBF kernel generation (counterpart of
``keystone_tpu/ops/learning/kernel.py``).

Reference: nodes/learning/KernelGenerator.scala:18-206 (GaussianKernel
column blocks), KernelMatrix.scala:17,50 (lazy column-block view with
caching), KernelRidgeRegression.scala:37,86-235 (per epoch and column
block: materialize K(:,B), reduce K_Bᵀ·W, solve
(K_BB + λI) W_B = Y_B − K_BᵀW + K_BBᵀW_B_old, update the model; lineage
checkpoint every 25 blocks) and KernelBlockLinearMapper.scala:28
(test-time blockwise K_test(:,B)·W_B accumulation).

On the device a kernel column block is one float32 product and an
elementwise tail (‖x‖² + ‖x_B‖² − 2·X X_Bᵀ → exp). The JAX package forms
the cross product with XLA's 3-pass bf16 algorithm (``BF16_BF16_F32_X3``,
about 1.5e-5 relative error); here it is a float32 ``matmul`` with TF32
off, which is at least as accurate. Pad rows and pad columns of every
block are zeroed, since exp(·) of a zero pad vector is not zero.

``solve="device"`` solves each (b, b) system on the device (float32
Cholesky and one refinement step, ``block_ls._psd_solve_device``), reading
the factor's success once per block; ``solve="host"`` solves it in
float64 on the host. ``cache_kernel`` keeps the whole n × n train kernel on
the device with every diagonal block factored once (the reference's
cacheKernel mode), so epochs after the first regenerate nothing.

**Training rows sharded over processes** (``Dataset.shard``). The
transformer keeps this process's rows; a kernel block K(:, B) needs B's
training rows against every row, so B's rows (block × d) come from the
processes that hold them (``Dataset.global_rows``) and each process forms
its own rows of the block. The Gauss-Seidel step's K_BᵀW is a sum over
rows (this process's plus an ``all_sum``), K_BB and Y_B are B's rows; the
dual model W is kept whole on every process and updated there from the
same reduced bytes, so it is identical on every one, and one process
gives the unsharded fit bit for bit. A test-time apply forms the same
blocks against its own rows.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from keystone_tpu_torch.ops.learning.block_ls import (
    _checkpointer,
    _f32_mm,
    _psd_solve_device,
    _psd_solve_with_factor,
)
from keystone_tpu_torch.ops.learning.hostsolve import psd_solve_host
from keystone_tpu_torch.parallel.dataset import Dataset, on_every_shard
from keystone_tpu_torch.utils.checkpoint import (
    data_probe,
    two_level_schedule,
)
from keystone_tpu_torch.utils.profiling import PhaseTimer
from keystone_tpu_torch.workflow.api import Estimator, LabelEstimator, Transformer


def _rbf_block(Xa: torch.Tensor, na: torch.Tensor, mask_a: torch.Tensor,
               Xb: torch.Tensor, nb: torch.Tensor, mask_b: torch.Tensor,
               gamma: float) -> torch.Tensor:
    """exp(−γ·max(‖a‖² + ‖b‖² − 2a·b, 0)) for every row pair, pad rows and
    pad columns zeroed; one (rows_a, rows_b) buffer, updated in place."""
    K = torch.matmul(Xa, Xb.T)
    K.mul_(-2.0).add_(na[:, None]).add_(nb[None, :]).clamp_(min=0.0)
    K.mul_(-gamma).exp_()
    return K.mul_(mask_a[:, None]).mul_(mask_b[None, :])


@dataclasses.dataclass(eq=False)
class GaussianKernelTransformer(Transformer):
    """Holds the train set; produces kernel blocks against it (reference:
    KernelGenerator.scala:49)."""

    train_X: Any  # (local rows, d) tensor: the training rows
    # ``train_rows`` holds here, pad rows zero
    n_train: int
    gamma: float
    train_mask: Any = None  # ``train_rows.mask()`` when not given
    train_rows: Optional[Dataset] = None  # the training set (sharded or
    # not) whose local rows ``train_X`` holds; None: ``train_X`` itself

    def __post_init__(self):
        if self.train_rows is None:
            self.train_rows = Dataset.from_array(self.train_X, n=self.n_train)
        if self.train_mask is None:
            self.train_mask = self.train_rows.mask().to(self.train_X.device)
        self._norms = torch.sum(self.train_X.to(torch.float32) ** 2, dim=1)

    def _rows(self, start: int, stop: int):
        """Training rows ``start .. stop``, their squared norms and mask, on
        every process: from the processes that hold them when sharded."""
        rows = self.train_rows
        return rows.all_sum(rows.rows_piece(self.train_X, start, stop),
                            rows.rows_piece(self._norms, start, stop),
                            rows.rows_piece(self.train_mask, start, stop))

    def apply(self, x):
        """kernel row of a single test point vs the whole train set (each
        process's part of it added in, when the training rows are
        sharded)."""
        x = x.to(torch.float32)
        d2 = torch.sum(x * x) + self._norms - 2.0 * torch.matmul(self.train_X, x)
        k = torch.exp(-self.gamma * torch.clamp(d2, min=0.0)) * self.train_mask
        return self.train_rows.global_rows(k, 0, self.train_rows.padded_n)

    def apply_batch(self, ds: Dataset) -> Dataset:
        """Kernel rows vs the train set as a Dataset (pipeline contract),
        one training shard's columns at a time; KRR uses
        ``kernel_matrix`` for the lazy block view instead."""
        ds = ds.to_array_mode()
        km = self.kernel_matrix(ds)
        per = self.train_X.shape[0]
        out = torch.cat([km.block(s, per) for s in range(0, self.train_rows.padded_n, per)],
                        dim=1)
        return Dataset(arrays=out, n=ds.n, mesh=ds.mesh)

    def kernel_matrix(self, ds: Dataset) -> "KernelMatrix":
        return KernelMatrix(self, ds.to_array_mode())

    def train_block(self, start: int, width: int) -> torch.Tensor:
        """K(train, B) for the train block [start, start + width): this
        process's training rows against B's."""
        return _rbf_block(self.train_X, self._norms, self.train_mask,
                          *self._rows(start, start + width), self.gamma)


class KernelMatrix:
    """Lazy column-block view of K(rows, train) with optional block cache
    (reference: KernelMatrix.scala:17 / BlockKernelMatrix:50); a sharded
    ``ds``'s blocks hold this process's rows."""

    def __init__(self, transformer: GaussianKernelTransformer, ds: Dataset,
                 cache_blocks: bool = False):
        self.transformer = transformer
        self.ds = ds
        self._X = ds.local().to(torch.float32)
        self._norms = torch.sum(self._X * self._X, dim=1)
        self._mask = ds.mask()
        self.cache_blocks = cache_blocks
        self._cache: Dict[tuple, torch.Tensor] = {}

    def block(self, start: int, width: int) -> torch.Tensor:
        key = (start, width)
        if key in self._cache:
            return self._cache[key]
        t = self.transformer
        out = _rbf_block(self._X, self._norms, self._mask, *t._rows(start, start + width),
                         t.gamma)
        if self.cache_blocks:
            self._cache[key] = out
        return out

    def diag_block(self, start: int, width: int) -> torch.Tensor:
        """K_BB of a train-set kernel matrix (the square view only)."""
        if self.ds.padded_n < start + width:
            raise ValueError("diag_block requires a square (train) kernel matrix")
        return self.ds.global_rows(self.block(start, width), start, start + width)

    def unpersist(self, start: int, width: int) -> None:
        self._cache.pop((start, width), None)


@dataclasses.dataclass(eq=False)
class GaussianKernelGenerator(Estimator):
    """fit(data) -> GaussianKernelTransformer (reference:
    KernelGenerator.scala:18)."""

    gamma: float

    def fit(self, data: Dataset) -> GaussianKernelTransformer:
        ds = data.to_array_mode()
        X = ds.local().to(torch.float32) * ds.mask()[:, None]
        return GaussianKernelTransformer(X, ds.n, self.gamma, train_rows=ds)


@dataclasses.dataclass(eq=False)
class KernelBlockLinearMapper(Transformer):
    """Test-time apply: accumulate K_test(:, B) · W_B over blocks
    (reference: KernelBlockLinearMapper.scala:28)."""

    model: Any  # (n_train_pad, k)
    block_size: int
    kernel_transformer: GaussianKernelTransformer
    n_train: int

    def apply(self, x):
        return torch.matmul(self.kernel_transformer.apply(x), self.model)

    def apply_batch(self, ds: Dataset) -> Dataset:
        """Predictions of ``ds``'s rows (this process's when sharded)."""
        ds = ds.to_array_mode()
        km = self.kernel_transformer.kernel_matrix(ds)
        n_pad = self.kernel_transformer.train_rows.padded_n
        out = torch.zeros((ds.local_n, self.model.shape[1]), dtype=torch.float32,
                          device=self.model.device)
        for start in range(0, n_pad, self.block_size):
            width = min(self.block_size, n_pad - start)
            out += _f32_mm(km.block(start, width), self.model[start : start + width])
        return Dataset(arrays=out, n=ds.n, mesh=ds.mesh)


def _gauss_seidel_rhs(t: GaussianKernelTransformer, Kcol: torch.Tensor, W: torch.Tensor,
                      Y: torch.Tensor, s: int, w: int):
    """Y_B − (K_BᵀW − K_BBᵀW_B), block B's right-hand side with its own
    old contribution taken back out, and K_BB. ``Kcol`` and ``Y`` hold the
    training rows ``t`` holds: K_BᵀW is their sum plus an ``all_sum``, and
    K_BB and Y_B come from the processes that hold B's rows, in the same
    ``all_reduce``. Unsharded, K_BB is a view of ``Kcol``."""
    rows = t.train_rows
    lo = rows.offset
    ktw, K_bb, Y_b = rows.all_sum(torch.matmul(Kcol.T, W[lo : lo + Kcol.shape[0]]),
                                  rows.rows_piece(Kcol, s, s + w), rows.rows_piece(Y, s, s + w))
    return Y_b - (ktw - torch.matmul(K_bb.T, W[s : s + w])), K_bb


@dataclasses.dataclass(eq=False)
class KernelRidgeRegression(LabelEstimator):
    """(K + λI) W = Y via column-block Gauss-Seidel (reference:
    KernelRidgeRegression.scala:37)."""

    kernel_generator: GaussianKernelGenerator
    lam: float
    block_size: int
    num_epochs: int
    block_permuter: Optional[int] = None
    solve: str = "device"  # "device": float32 Cholesky + one refinement
    # step on the device, one host sync per block | "host": float64
    # LAPACK per block for pathological conditioning
    checkpoint_path: Optional[str] = None  # periodic model snapshot every
    # ``checkpoint_every`` block solves; a re-run with the same path
    # resumes at the last completed block (reference checkpoints lineage
    # every 25 blocks: KernelRidgeRegression.scala:200-210)
    checkpoint_every: int = 25
    block_callback: Optional[Any] = None  # called with a running count
    # after each completed block solve
    cache_kernel: Optional[bool] = None  # keep the whole train kernel on
    # the device and factor every diagonal block once (the reference's
    # cacheKernel mode, KernelMatrix.scala:50). None = auto: on when
    # num_epochs > 1 and the cache fits in 0.6 of the device's memory. It
    # takes the device solve without a checkpoint or a block callback;
    # blocks of several widths (a ragged last block) are cached too

    def _epoch_order(self, epoch: int, n_blocks: int) -> List[int]:
        """Block order for an epoch, seeded per (permuter, epoch) so a
        resumed fit replays the identical schedule."""
        order = list(range(n_blocks))
        if self.block_permuter is not None:
            np.random.default_rng((self.block_permuter, epoch)).shuffle(order)
        return order

    def fit(self, data: Dataset, labels: Dataset) -> KernelBlockLinearMapper:
        if self.solve not in ("device", "host"):
            raise ValueError(f"solve must be 'device' or 'host', got {self.solve!r}")
        # per-phase wall clock, published as registry metrics
        # (keystone_phase_seconds_total{timer="krr_fit"}); the device
        # path's phases include its one sync per block
        timer = PhaseTimer("krr_fit")
        data = data.to_array_mode()
        transformer = self.kernel_generator.fit(data)
        X = transformer.train_X
        n = data.n
        n_pad = transformer.train_rows.padded_n
        Y = labels.local_like(data).to(device=X.device, dtype=torch.float32)
        k = Y.shape[1]
        blocks = [
            (s, min(s + self.block_size, n_pad) - s)
            for s in range(0, n_pad, self.block_size)
        ]
        W = torch.zeros((n_pad, k), dtype=torch.float32, device=X.device)

        ckpt = None
        start_epoch, start_pos = 0, 0
        if self.checkpoint_path is not None:
            fp = (
                f"krr bs={self.block_size} ep={self.num_epochs} "
                f"lam={self.lam} gamma={self.kernel_generator.gamma} "
                f"perm={self.block_permuter} n={n} n_pad={n_pad} k={k} "
                f"solve={self.solve} "
                f"probe={data_probe(X, Y)}"
            )
            ckpt, writes = _checkpointer(self.checkpoint_path, self.checkpoint_every, fp,
                                         data.mesh)
            state = ckpt.load()
            if state is not None:
                W = torch.as_tensor(state["W"], dtype=torch.float32, device=X.device)
                start_epoch = int(state["epoch"])
                start_pos = int(state["pos"])

        use_cached = False
        if self.solve == "device" and ckpt is None and self.block_callback is None:
            use_cached = self.cache_kernel
            if use_cached is None:
                from keystone_tpu_torch.ops.learning.weighted_ls import (
                    _device_memory_limit,
                )

                # the column blocks, the ridged diagonal blocks and their
                # factors, and one (n_pad, b) transient
                width = blocks[0][1]
                cache_bytes = 4 * (
                    X.shape[0] * n_pad + 2 * len(blocks) * width * width + X.shape[0] * width
                )
                # one choice on every process: they must reduce the same blocks
                use_cached = on_every_shard(data.mesh, (
                    self.num_epochs > 1
                    and cache_bytes <= 0.6 * _device_memory_limit(X.device)
                ), X.device)
        if use_cached:
            order = [
                i
                for epoch in range(self.num_epochs)
                for i in self._epoch_order(epoch, len(blocks))
            ]
            W = self._cached_sweeps(transformer, W, Y, blocks, order, timer)
            timer.publish()
            return KernelBlockLinearMapper(W, self.block_size, transformer, n)

        if self.cache_kernel:  # asked for, and not possible here
            warnings.warn(
                "cache_kernel=True has no effect with solve='host', "
                "checkpoint_path or block_callback — falling back to "
                "per-block kernel regeneration",
                stacklevel=2,
            )

        done = 0
        order, order_epoch = [], -1
        for epoch, pos, nxt in two_level_schedule(
            self.num_epochs, len(blocks), (start_epoch, start_pos)
        ):
            if epoch != order_epoch:
                order = self._epoch_order(epoch, len(blocks))
                order_epoch = epoch
            s, wd = blocks[order[pos]]
            if self.solve == "device":
                with timer.phase("block_step"):
                    Kcol = transformer.train_block(s, wd)
                    rhs, K_bb = _gauss_seidel_rhs(transformer, Kcol, W, Y, s, wd)
                    # K_BB becomes K_BB + λI in place: a view of Kcol's
                    # rows (unsharded), and Kcol is not read again
                    W[s : s + wd] = _psd_solve_device(K_bb, rhs, self.lam, refine=1)
            else:
                with timer.phase("kernel_block"):
                    Kcol = transformer.train_block(s, wd)  # (n_pad, b)
                with timer.phase("residual"):
                    rhs, K_bb = _gauss_seidel_rhs(transformer, Kcol, W, Y, s, wd)
                # pad rows inside the block: K_bb row/col is zero there,
                # λI makes the system nonsingular, W stays 0 via rhs=0
                with timer.phase("host_solve"):
                    Wb_new = psd_solve_host(K_bb.cpu().numpy(), rhs.cpu().numpy(), self.lam)
                with timer.phase("model_update"):
                    W[s : s + wd] = torch.as_tensor(Wb_new, dtype=torch.float32,
                                                    device=W.device)
            done += 1
            if ckpt is not None and writes:
                ckpt.tick(lambda: {
                    "W": W.cpu().numpy(), "epoch": nxt[0], "pos": nxt[1],
                })
            if self.block_callback is not None:
                self.block_callback(done)
        if ckpt is not None and writes:
            ckpt.clear()
        timer.publish()
        return KernelBlockLinearMapper(W, self.block_size, transformer, n)

    def _cached_sweeps(self, transformer: GaussianKernelTransformer, W: torch.Tensor,
                       Y: torch.Tensor, blocks, order: List[int],
                       timer: PhaseTimer) -> torch.Tensor:
        """Gauss-Seidel with the kernel matrix cached on the device: every
        column block built once and every ridged diagonal block factored
        once (their successes read in one sync), then the sweeps over
        ``order`` with no kernel regeneration. Each block is factored on
        its own, as the uncached fit factors it, so the two fits agree bit
        for bit; a batched factorization (the JAX package's bank) rounds
        differently, which the ill-conditioned kernels of large training
        sets amplify (PERF.md § 6)."""
        with timer.phase("kernel_cache"):
            cols = [transformer.train_block(s, w) for s, w in blocks]
            ridged, factors, good = [], [], []
            for (s, w), Kcol in zip(blocks, cols):
                A = transformer.train_rows.global_rows(Kcol, s, s + w).clone()
                A.diagonal().add_(self.lam)
                L, info = torch.linalg.cholesky_ex(A)
                ridged.append(A)
                factors.append(L)
                good.append((info == 0) & torch.isfinite(L).all())
            ok = torch.stack(good).tolist()
        with timer.phase("epoch_scan"):
            for bi in order:
                s, w = blocks[bi]
                rhs, _ = _gauss_seidel_rhs(transformer, cols[bi], W, Y, s, w)
                W[s : s + w] = _psd_solve_with_factor(ridged[bi], factors[bi], rhs,
                                                      refine=1, ok=ok[bi])
        return W
