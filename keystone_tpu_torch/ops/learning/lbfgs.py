"""Full-batch L-BFGS with L2 regularization (counterpart of
``keystone_tpu/ops/learning/lbfgs.py``).

Reference: nodes/learning/LBFGS.scala — per-partition gradients over
partition-stacked matrices, treeReduce sum, Breeze LBFGS driver on the
master; nodes/learning/Gradient.scala for the least-squares gradients.

The value and gradient are float32 products on the data's device: dense
``torch.matmul`` (TF32 off on the card), or, for sparse rows (the
``Dataset``'s CSR mode), ``X·W`` and ``Xᵀ·R`` as two CSR SpMMs, the
transpose's CSR made once per fit. Two drivers, as in the JAX package:

- ``run_lbfgs_device``: the JAX package's fused device driver, with the
  same arithmetic in float32 on the device (the ring buffer of m
  corrections, the ``gamma`` scaling, the reset to ``−g`` on a direction
  that does not descend, Armijo with c = 1e-4 and at most 30 halvings, the
  ``s·y > 1e-10`` store test, ``done = ~ok | improvement < tol``). The JAX
  driver is one ``lax.while_loop`` with no host sync; this one is a
  Python loop that reads one boolean per line-search trial (the Armijo
  test) and one pair per iteration (the store and convergence tests, read
  together): about ``iterations + value-and-gradient calls`` host syncs a
  fit, a few tens, each a wait for the device's queue to drain.
- ``run_lbfgs``: the float64 host driver (the Breeze driver's stand-in),
  one device round trip per value-and-gradient call.

On dense rows sharded over processes (``Dataset.shard``) the loss and
gradient are this process's rows' plus one ``all_sum`` per call (the
reference's treeReduce); the L-BFGS loop then runs on every process from the
same reduced bytes, so every process takes the same steps. Sparse rows
are not sharded (``Dataset.shard`` refuses a CSR matrix), as the JAX
package fits its sparse L-BFGS on unsharded rows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from keystone_tpu_torch.ops.learning.cost import CostModel
from keystone_tpu_torch.ops.learning.linear import LinearMapper, SparseLinearMapper
from keystone_tpu_torch.ops.stats.nodes import StandardScaler
from keystone_tpu_torch.parallel.dataset import Dataset, all_sum, csr_transpose, is_sparse, spmm
from keystone_tpu_torch.utils.precision import mm
from keystone_tpu_torch.workflow.api import LabelEstimator


class Gradient:
    """loss(W; A, b) total and gradient over a batch (reference:
    nodes/learning/Gradient.scala:10). Stateless: equality is by type.
    ``At`` is the CSR of ``Aᵀ`` for sparse ``A`` (made once per fit)."""

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self))

    def value_and_grad(self, A, b, W, At=None) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def regularized_vg(self, W, A, b, reg, n, At=None, mesh=None):
        """Mean loss + L2 and its gradient, in the ``vg(W, *data)`` shape
        ``run_lbfgs`` and ``run_lbfgs_device`` take; ``A`` is this
        process's rows when ``mesh`` is given, and the sums are added
        over the shards."""
        loss, g = all_sum(mesh, *self.value_and_grad(A, b, W, At))
        return loss / n + 0.5 * reg * torch.sum(W * W), g / n + reg * W


class LeastSquaresDenseGradient(Gradient):
    """0.5·‖AW − b‖² summed over examples; grad = Aᵀ(AW − b)
    (reference: Gradient.scala:29). float32 products (TF32 off on the
    card, the JAX package's ``Precision.HIGHEST``)."""

    def value_and_grad(self, A, b, W, At=None):
        res = mm(A, W) - b
        loss = 0.5 * torch.sum(res * res)
        return loss, mm(A.T, res)


class LeastSquaresSparseGradient(Gradient):
    """The same objective with sparse rows (reference: Gradient.scala:58):
    two CSR SpMMs."""

    def value_and_grad(self, A, b, W, At=None):
        res = spmm(A, W) - b
        loss = 0.5 * torch.sum(res * res)
        return loss, spmm(At if At is not None else csr_transpose(A), res)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def run_lbfgs_device(
    device_vg: Callable[..., Tuple[torch.Tensor, torch.Tensor]],
    w0: torch.Tensor,
    num_iterations: int,
    num_corrections: int = 10,
    convergence_tol: float = 1e-4,
    data: tuple = (),
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """L-BFGS in float32 on the device of ``w0``: the two-loop recursion
    over a ring buffer of ``num_corrections`` (s, y) pairs, Armijo
    backtracking, the convergence test; the JAX package's
    ``_lbfgs_device_run`` step for step. ``device_vg(W, *data) -> (loss,
    grad)`` with ``W`` in its (d, k) shape. ``stats``, when given, gets
    ``iterations``, ``vg_calls`` and ``host_syncs``."""
    m = num_corrections
    w = w0.to(torch.float32)
    f, g = device_vg(w, *data)
    calls, syncs = 1, 0
    S = torch.zeros((m,) + tuple(w.shape), dtype=torch.float32, device=w.device)
    Y = torch.zeros_like(S)
    count = 0
    it = 0
    while it < num_iterations:
        n_hist = min(count, m)
        # two-loop recursion, newest pair first
        q = g
        alphas = []
        for i in range(n_hist):
            j = (count - 1 - i) % m
            a = _dot(S[j], q) / _dot(Y[j], S[j])
            q = q - a * Y[j]
            alphas.append(a)
        if count > 0:
            jl = (count - 1) % m
            q = q * (_dot(S[jl], Y[jl]) / torch.clamp(_dot(Y[jl], Y[jl]), min=1e-30))
        for i in reversed(range(n_hist)):
            j = (count - 1 - i) % m
            b = _dot(Y[j], q) / _dot(Y[j], S[j])
            q = q + (alphas[i] - b) * S[j]
        direction = -q
        dg = _dot(direction, g)
        bad = dg >= 0
        direction = torch.where(bad, -g, direction)
        dg = torch.where(bad, -_dot(g, g), dg)

        # Armijo backtracking: halve the step until the test passes
        step, ok, tries = 1.0, False, 0
        while not ok and tries < 30:
            w_try = w + step * direction
            f_try, g_try = device_vg(w_try, *data)
            calls += 1
            ok = bool(f_try <= f + 1e-4 * step * dg)
            syncs += 1
            tries += 1
            if not ok:
                step *= 0.5
        it += 1
        if not ok:  # the line search failed: done, the iterate kept
            break
        s_vec = w_try - w
        y_vec = g_try - g
        improvement = torch.abs(f - f_try) / torch.clamp(
            torch.maximum(torch.abs(f), torch.abs(f_try)), min=1.0)
        store, converged = torch.stack(
            [_dot(s_vec, y_vec) > 1e-10, improvement < convergence_tol]).tolist()
        syncs += 1
        if store:
            S[count % m] = s_vec
            Y[count % m] = y_vec
            count += 1
        w, f, g = w_try, f_try, g_try
        if converged:
            break
    if stats is not None:
        stats.update(iterations=it, vg_calls=calls, host_syncs=syncs)
    return w


def run_lbfgs(
    value_and_grad: Callable[[np.ndarray], Tuple[float, np.ndarray]],
    w0: np.ndarray,
    num_iterations: int,
    num_corrections: int = 10,
    convergence_tol: float = 1e-4,
) -> np.ndarray:
    """Two-loop-recursion L-BFGS with Armijo backtracking, float64 on the
    host (the Breeze LBFGS driver stand-in, LBFGS.scala:135)."""
    w = w0.astype(np.float64).ravel()
    f, g = value_and_grad(w)
    s_hist: list = []
    y_hist: list = []
    for _ in range(num_iterations):
        q = g.copy()
        alphas = []
        for s, y in reversed(list(zip(s_hist, y_hist))):
            rho = 1.0 / (y @ s)
            a = rho * (s @ q)
            alphas.append((a, rho, s, y))
            q -= a * y
        if y_hist:
            y = y_hist[-1]
            s = s_hist[-1]
            q *= (s @ y) / (y @ y)
        for a, rho, s, y in reversed(alphas):
            b = rho * (y @ q)
            q += (a - b) * s
        direction = -q
        step = 1.0
        dg = direction @ g
        if dg >= 0:  # not a descent direction; reset
            direction = -g
            dg = -(g @ g)
        f_new, g_new, w_new = f, g, w
        for _ in range(30):
            w_try = w + step * direction
            f_try, g_try = value_and_grad(w_try)
            if f_try <= f + 1e-4 * step * dg:
                f_new, g_new, w_new = f_try, g_try, w_try
                break
            step *= 0.5
        else:
            break  # line search failed
        s_vec = w_new - w
        y_vec = g_new - g
        if s_vec @ y_vec > 1e-10:
            s_hist.append(s_vec)
            y_hist.append(y_vec)
            if len(s_hist) > num_corrections:
                s_hist.pop(0)
                y_hist.pop(0)
        improvement = abs(f - f_new) / max(abs(f), abs(f_new), 1.0)
        w, f, g = w_new, f_new, g_new
        if improvement < convergence_tol:
            break
    return w


def host_vg(vg: Callable, shape: Tuple[int, int], device: torch.device, *data):
    """``vg(W, *data)`` as the host driver's ``value_and_grad(w_flat)``:
    float64 in and out, float32 on the device in between."""

    def value_and_grad(w_flat: np.ndarray):
        W = torch.as_tensor(w_flat.reshape(shape), dtype=torch.float32, device=device)
        loss, g = vg(W, *data)
        return float(loss), g.detach().to("cpu", torch.float64).numpy().ravel()

    return value_and_grad


@dataclasses.dataclass(eq=False)
class LBFGSwithL2(LabelEstimator, CostModel):
    """min_W (1/n)·Σ loss(W; a_i, b_i) + 0.5·λ‖W‖² (reference:
    LBFGS.scala:14). ``fit_intercept`` mean-centers through
    ``StandardScaler`` as the reference does (:150-166). Fits on the
    labels' device; the data is moved there (sparse rows come from the
    host featurizers). ``fit_stats`` holds the
    last device fit's iterations, value-and-gradient calls and host
    syncs."""

    gradient: Gradient = dataclasses.field(default_factory=LeastSquaresDenseGradient)
    fit_intercept: bool = True
    num_corrections: int = 10
    convergence_tol: float = 1e-4
    num_iterations: int = 20
    reg_param: float = 0.0
    sparse: bool = False
    driver: str = "device"  # "device": float32 on the device, one host
    # sync per line-search trial | "host": float64 Breeze-driver
    # equivalent, one device round trip per value-and-gradient call

    def fit(self, data: Dataset, labels: Dataset):
        if self.driver not in ("device", "host"):
            raise ValueError(f"driver must be 'device' or 'host', got {self.driver!r}")
        data = data.to_array_mode()
        mesh = data.mesh
        b = labels.local_like(data).to(torch.float32)
        A = data.local().to(b.device)
        data = Dataset(arrays=A, n=data.n, mesh=mesh)
        labels = Dataset(arrays=b, n=data.n, mesh=mesh)
        sparse_rows = is_sparse(A)
        d = A.shape[1]
        k = b.shape[1]
        n = data.n

        feat_scaler = label_scaler = None
        if self.fit_intercept and not sparse_rows:
            feat_scaler = StandardScaler(normalize_std_dev=False).fit(data)
            label_scaler = StandardScaler(normalize_std_dev=False).fit(labels)
            data = feat_scaler.apply_batch(data)
            labels = label_scaler.apply_batch(labels)
            A = data.local()
            b = labels.local().to(torch.float32)
        At = csr_transpose(A) if sparse_rows else None
        vg_data = (A, b, float(self.reg_param), float(n), At, mesh)
        w0 = torch.zeros((d, k), dtype=torch.float32, device=b.device)
        if self.driver == "device":
            self.fit_stats = {}
            W = run_lbfgs_device(
                self.gradient.regularized_vg, w0, self.num_iterations,
                self.num_corrections, self.convergence_tol, data=vg_data,
                stats=self.fit_stats,
            )
        else:
            w = run_lbfgs(
                host_vg(self.gradient.regularized_vg, (d, k), b.device, *vg_data),
                np.zeros((d, k)), self.num_iterations, self.num_corrections,
                self.convergence_tol,
            )
            W = torch.as_tensor(w.reshape(d, k), dtype=torch.float32, device=b.device)
        if sparse_rows:
            return SparseLinearMapper(W)
        if self.fit_intercept:
            # reference: LinearMapper(model, Some(labelScaler.mean),
            # Some(featureScaler)): center the input, add the label mean back
            return LinearMapper(W, intercept=label_scaler.mean, feature_scaler=feat_scaler)
        return LinearMapper(W)

    @property
    def weight(self) -> int:
        # reference: LBFGS.scala weight = numIterations + 1
        return self.num_iterations + 1


@dataclasses.dataclass(eq=False)
class DenseLBFGSwithL2(LBFGSwithL2):
    """Dense-gradient variant (reference: LBFGS.scala:135); cost model from
    :175-191."""

    def cost(self, n, d, k, sparsity, num_machines, cpu_weight, mem_weight,
             network_weight):
        flops = n * float(d) * k / num_machines
        bytes_scanned = n * float(d) / num_machines
        network = 2.0 * d * k * max(math.log2(num_machines), 1.0)
        return self.num_iterations * (
            max(cpu_weight * flops, mem_weight * bytes_scanned)
            + network_weight * network
        )


@dataclasses.dataclass(eq=False)
class SparseLBFGSwithL2(LBFGSwithL2):
    """Sparse-gradient variant (reference: LBFGS.scala:208); cost model
    from :264-280 (sparseOverhead ~ 3x the dense per-element cost)."""

    sparse_overhead: float = 3.0

    def __post_init__(self):
        self.gradient = LeastSquaresSparseGradient()
        self.fit_intercept = False
        self.sparse = True

    def cost(self, n, d, k, sparsity, num_machines, cpu_weight, mem_weight,
             network_weight):
        flops = n * sparsity * float(d) * k / num_machines
        bytes_scanned = n * float(d) * sparsity / num_machines
        network = 2.0 * d * k * max(math.log2(num_machines), 1.0)
        return self.num_iterations * (
            self.sparse_overhead
            * max(cpu_weight * flops, mem_weight * bytes_scanned)
            + network_weight * network
        )
