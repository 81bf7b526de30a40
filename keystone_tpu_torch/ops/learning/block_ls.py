"""Block coordinate descent least squares — the workhorse solver
(counterpart of ``keystone_tpu/ops/learning/block_ls.py``).

Reference: nodes/learning/BlockLinearMapper.scala — BlockLinearMapper
(:22,50-73) applies a block-split linear model; BlockLeastSquaresEstimator
(:199-283) mean-centers features and labels per block and runs mlmatrix
BlockCoordinateDescent.solveLeastSquaresWithL2 (Gauss-Seidel sweeps: per
block, the Grams AᵀA and AᵀR, a float64 solve of the (b × b) system on one node,
and a residual update).

Here the feature matrix is one (n, D) tensor on the device and a block is
a column slice of it. Each block update is

    R⁺   = R + X_b W_b            (undo this block's contribution)
    G    = X_bᵀ X_b − n·μ_bμ_bᵀ     (centered algebraically: no centered
    rhs  = X_bᵀ R⁺ − μ_b·(1ᵀR⁺)      copy of X is ever made)
    W_b' = (G + λI)⁻¹ rhs          (float32 Cholesky + 2 refinement steps
                                    on the device, or float64 on the host)
    R    = R⁺ − X_b W_b'

with the residual R updated in place. ``X`` may also live in host RAM as
column slabs (``Dataset.from_host_blocks``): each slab is uploaded through
a pooled pinned buffer on a copy stream, the next one double-buffered
against the current block's update.

**Rows sharded over processes** (``Dataset.shard``; JAX's
``block_ls.py:561-575``). Each process holds a contiguous range of rows
on its card. The sums over examples — the feature and label means, and
per block X_bᵀX_b, X_bᵀR⁺ and 1ᵀR⁺ — are taken on the local rows and
summed in one ``all_reduce`` over the mesh's example axes; the centering
(with the global ``n``) and the (b × b) solve then run on every process
from the same reduced bytes, so W comes out identical on every one. The
residual update and apply stay local. A host-blocks fit uploads only its
rows of each slab, and when the process group spans several processes
an unsharded host-blocks dataset is sharded over the current mesh, as
the JAX package places each slab's rows over the data axis.

Products are float32 ``torch.matmul``s (TF32 off on the card), the
counterpart of the JAX package's ``Precision.HIGHEST``; bf16 features are
upcast one block at a time before the product (a product of two bf16
values is exact in float32, so this is JAX's bf16 × bf16 → float32 path).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from keystone_tpu_torch.ops.learning.cost import (
    H100_CPU_WEIGHT,
    H100_MEM_WEIGHT,
    H100_NETWORK_WEIGHT,
    CostModel,
)
from keystone_tpu_torch.ops.learning.hostsolve import psd_solve_host
from keystone_tpu_torch.parallel import mesh as mesh_lib
from keystone_tpu_torch.parallel.dataset import Dataset, all_sum
from keystone_tpu_torch.utils.checkpoint import (
    LoopCheckpointer,
    data_probe,
    two_level_schedule,
)
from keystone_tpu_torch.utils.precision import mm
from keystone_tpu_torch.workflow.api import LabelEstimator, Transformer

# Host slabs on the card at once: the one a block update reads, the next
# one's upload, and one more so that an upload never waits on the host's
# copy into its pinned buffer (the JAX package's run-ahead window of 2,
# plus one)
SLABS_ON_CARD = 3

# Above this many rows a failed Cholesky factor is not retried with eigh,
# as in the JAX package (whose lax.cond would compile eigh's workspace
# beside the factor's); the solve then comes out non-finite
EIGH_MAX_ROWS = 8192


def _f32(a: torch.Tensor) -> torch.Tensor:
    return a if a.dtype == torch.float32 else a.to(torch.float32)


def _f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with float32 operands and accumulation."""
    return torch.matmul(_f32(a), _f32(b))


def _psd_solve_with_factor(A: torch.Tensor, L: torch.Tensor, rhs: torch.Tensor,
                           refine: int = 2, ok: Optional[bool] = None) -> torch.Tensor:
    """A X = rhs given the (already-ridged) ``A``'s lower Cholesky factor
    ``L``: float32 and ``refine`` iterative-refinement steps, which recover
    most of the float64 accuracy of the reference's single-node solve
    (BlockLinearMapper.scala:234-240). ``ok`` says whether the factor
    succeeded; when it is not given, a non-finite ``L`` means it failed
    (one host sync). A failed factor (indefiniteness from float32 rounding)
    is replaced by ``eigh`` with the eigenvalues clamped, as
    ``hostsolve.py`` does, up to ``EIGH_MAX_ROWS`` rows. Shared by the
    fresh-factor path below and the cached kernel ridge regression's
    factor bank (``kernel.py``)."""
    if ok is None:
        ok = bool(torch.isfinite(L).all().item())
    if ok:
        W = torch.cholesky_solve(rhs, L)
        for _ in range(refine):
            W += torch.cholesky_solve(rhs - torch.matmul(A, W), L)
        return W
    if A.shape[0] > EIGH_MAX_ROWS:
        return torch.full_like(rhs, float("nan"))
    w, V = torch.linalg.eigh(A)
    w = torch.maximum(w, 1e-12 * torch.clamp(w[-1], min=1.0))
    return torch.matmul(V, torch.matmul(V.T, rhs) / w[:, None])


def _psd_solve_device(gram: torch.Tensor, rhs: torch.Tensor, lam: float,
                      refine: int = 2) -> torch.Tensor:
    """(gram + lam·I) X = rhs on the device: a float32 Cholesky factor,
    then the refined solve of ``_psd_solve_with_factor``. ``gram`` becomes
    gram + lam·I in place. The factor's success is read once (one host
    sync)."""
    A = gram
    A.diagonal().add_(lam)
    L, info = torch.linalg.cholesky_ex(A)
    ok = bool(((info == 0) & torch.isfinite(L).all()).item())
    return _psd_solve_with_factor(A, L, rhs, refine, ok)


def _add_contribution(R, Xb, Wb, mu_b, mask, sign: float) -> None:
    """R += sign · (X_b − 1μ_bᵀ) W_b over the valid rows, in place."""
    R.addmm_(Xb, Wb, alpha=sign)
    R.addr_(mask, torch.matmul(mu_b, Wb), alpha=-sign)


def _column_sums(X: torch.Tensor, mask: torch.Tensor, mesh) -> torch.Tensor:
    """Σ over the valid rows of every shard of ``X``, float32."""
    (s,) = all_sum(mesh, torch.matmul(mask, _f32(X)))
    return s


def _block_update(Xb, R, Wb, mu_b, mask, lam: float, n: int, *,
                  first_pass: bool, last_pass: bool, host_solve: bool = False,
                  mesh: Optional[mesh_lib.Mesh] = None):
    """One block's update on a float32 (padded_n, w) slab; returns the new
    block model and leaves the new residual in ``R``.

    ``first_pass``: the block's model is exactly zero (sweep 0 of a fresh
    fit, or a block a resumed fit never completed), so the matmul that
    undoes its contribution is skipped. ``last_pass``: the residual is
    never read again, so its update is skipped and ``R`` is left stale.
    ``mesh``: the rows are this process's shard; the Grams are summed over
    the shards before they are centered and solved."""
    if not first_pass:
        _add_contribution(R, Xb, Wb, mu_b, mask, 1.0)
    gram, rhs, r_sum = all_sum(
        mesh, torch.matmul(Xb.T, Xb), torch.matmul(Xb.T, R), torch.sum(R, dim=0))
    gram.addr_(mu_b, mu_b, alpha=-float(n))
    rhs.addr_(mu_b, r_sum, alpha=-1.0)
    if host_solve:
        W = torch.as_tensor(
            psd_solve_host(gram.cpu().numpy(), rhs.cpu().numpy(), lam),
            dtype=torch.float32, device=R.device,
        )
    else:
        W = _psd_solve_device(gram, rhs, lam)
    if not last_pass:
        _add_contribution(R, Xb, W, mu_b, mask, -1.0)
    return W


def _prep_labels(Y: torch.Tensor, mask: torch.Tensor, n: int, mesh=None):
    """Label mean over the valid rows (of every shard) and the centered
    residual (pad rows zero: upstream nodes such as ClassLabelIndicators
    may map zero pad rows to nonzero values)."""
    Y = _f32(Y)
    mu_y = _column_sums(Y, mask, mesh) / n
    return mu_y, (Y - mu_y) * mask[:, None]


def _checkpointer(path: str, every: int, fp: str, mesh) -> Tuple[LoopCheckpointer, bool]:
    """The fit's checkpointer and whether this process writes it: with
    sharded rows the fingerprint joins every shard's probe, every process
    reads the snapshot and the first shard alone writes it."""
    if mesh is None:
        return LoopCheckpointer(path, every, fingerprint=fp), True
    fp = "|".join(mesh_lib.all_gather_objects(fp, mesh))
    return LoopCheckpointer(path, every, fingerprint=fp), mesh_lib.shard_index(mesh) == 0


class _SlabStream:
    """Host slabs onto the device, at most ``SLABS_ON_CARD`` there at once.

    ``put(i)`` copies host block ``i`` into one of ``SLABS_ON_CARD`` pooled
    pinned buffers, then, on a copy stream, into the matching device
    buffer; ``acquire`` makes the current stream wait for that copy and
    returns the slab; ``release`` records that the current stream is done
    reading it. Events order the three: a copy into a device buffer waits
    for the compute that last read it, and the host rewrites a pinned
    buffer only once its last copy has completed. On the CPU a slab is
    the host block itself."""

    def __init__(self, blocks: Sequence[torch.Tensor], device: torch.device):
        self._blocks = blocks
        self._cuda = device.type == "cuda"
        if not self._cuda:
            return
        dtypes = {b.dtype for b in blocks}
        if len(dtypes) != 1:
            raise ValueError(f"host blocks disagree on dtype: {sorted(map(str, dtypes))}")
        size = blocks[0].shape[0] * max(b.shape[1] for b in blocks)
        dtype = blocks[0].dtype
        self._pinned = [torch.empty(size, dtype=dtype, pin_memory=True)
                        for _ in range(SLABS_ON_CARD)]
        self._slabs = [torch.empty(size, dtype=dtype, device=device)
                       for _ in range(SLABS_ON_CARD)]
        self._copied: List[Optional[torch.cuda.Event]] = [None] * SLABS_ON_CARD
        self._read: List[Optional[torch.cuda.Event]] = [None] * SLABS_ON_CARD
        self._stream = torch.cuda.Stream(device)
        self._turn = 0

    def put(self, i: int) -> Any:
        block = self._blocks[i]
        if not self._cuda:
            return block
        slot = self._turn % len(self._slabs)
        self._turn += 1
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()
        rows, w = block.shape
        host = self._pinned[slot][: rows * w].view(rows, w)
        host.copy_(block)
        slab = self._slabs[slot][: rows * w].view(rows, w)
        with torch.cuda.stream(self._stream):
            if self._read[slot] is not None:
                self._stream.wait_event(self._read[slot])
            slab.copy_(host, non_blocking=True)
            self._copied[slot] = torch.cuda.Event()
            self._copied[slot].record(self._stream)
        return slot, slab

    def acquire(self, handle: Any) -> torch.Tensor:
        if not self._cuda:
            return handle
        slot, slab = handle
        torch.cuda.current_stream().wait_event(self._copied[slot])
        return slab

    def release(self, handle: Any) -> None:
        if not self._cuda:
            return
        slot, _ = handle
        self._read[slot] = torch.cuda.Event()
        self._read[slot].record(torch.cuda.current_stream())


def _host_blocks_probe(blocks: Sequence[torch.Tensor], Y: torch.Tensor) -> str:
    """Cheap order-sensitive digest of a host-blocks dataset for checkpoint
    fingerprints: strided row and column samples of each block (a full
    ``data_probe`` of a host-RAM-scale X would read all of it to stamp a
    snapshot)."""
    parts = []
    for b in blocks:
        rows = [0, b.shape[0] // 3, (2 * b.shape[0]) // 3, b.shape[0] - 1]
        sample = b[rows, : min(8, b.shape[1])].to(torch.float64).reshape(-1)
        parts.append(
            f"{tuple(b.shape)}:{b.dtype}:"
            + ",".join(f"{v:.6e}" for v in sample.tolist())
        )
    ysum = float(torch.sum(Y, dtype=torch.float32))
    return ";".join(parts) + f"|Y={ysum:.6e}"


@dataclasses.dataclass(eq=False)
class BlockLinearMapper(Transformer):
    """Applies the block-solved linear model, stored as one (D, k) matrix
    (the concatenation of the reference's per-block models,
    BlockLinearMapper.scala:22), so apply is one matmul."""

    W: Any  # (D, k)
    block_size: int
    feature_mean: Optional[Any] = None  # (D,)
    label_mean: Optional[Any] = None  # (k,)
    explicit_intercept: Optional[Any] = None  # (k,)
    solver_info: Optional[dict] = None  # solver diagnostics (the weighted
    # solver's PCG exit residual and iteration count)

    @property
    def intercept(self):
        if self.explicit_intercept is not None:
            return self.explicit_intercept
        if self.label_mean is None:
            return None
        if self.feature_mean is None:
            return self.label_mean
        return self.label_mean - mm(self.feature_mean, self.W)

    def apply(self, x):
        out = mm(x, self.W)
        icpt = self.intercept
        return out if icpt is None else out + icpt

    def apply_batch(self, ds: Dataset) -> Dataset:
        """Predictions; sharded rows are predicted where they are."""
        if ds.is_host:
            return self._apply_host_blocks(ds)
        out = mm(ds.local(), self.W)
        icpt = self.intercept
        if icpt is not None:
            # keep pad rows zero
            out = (out + icpt) * ds.mask()[:, None]
        return Dataset.from_array(out, n=ds.n, mesh=ds.mesh)

    def _apply_host_blocks(self, ds: Dataset) -> Dataset:
        """Predict from host column blocks: each slab is uploaded
        (double-buffered, as in the fit) and X_b W_b accumulated on the
        device, which holds at most 3 slabs and the (n, k) output."""
        blocks = ds.host_blocks
        if sum(ds.block_widths) != self.W.shape[0]:
            raise ValueError(
                f"host blocks cover {sum(ds.block_widths)} features but the "
                f"model has {self.W.shape[0]}"
            )
        slabs = _SlabStream(blocks, ds.device)
        out = None
        s = 0
        nxt = slabs.put(0)
        for i, b in enumerate(blocks):
            cur = nxt
            if i + 1 < len(blocks):
                nxt = slabs.put(i + 1)
            w = b.shape[1]
            part = _f32_mm(slabs.acquire(cur), self.W[s : s + w])
            slabs.release(cur)
            out = part if out is None else out.add_(part)
            s += w
        icpt = self.intercept
        if icpt is not None:
            out = (out + icpt) * ds.mask()[:, None]
        return Dataset.from_array(out, n=ds.n, mesh=ds.mesh)

    def apply_and_evaluate(
        self, ds: Dataset, evaluator: Callable[[torch.Tensor], None]
    ) -> None:
        """Hand ``evaluator`` the predictions of the first 1, 2, ... blocks
        after each block (reference: BlockLinearMapper.applyAndEvaluate
        :95-137), so a caller can watch the error fall block by block
        (this process's rows when they are sharded)."""
        X = ds.local()
        D = X.shape[1]
        icpt = self.intercept
        mask = ds.mask()[:, None]
        acc = torch.zeros((X.shape[0], self.W.shape[1]), dtype=torch.float32,
                          device=X.device)
        for start in range(0, D, self.block_size):
            end = min(start + self.block_size, D)
            acc = acc + _f32_mm(X[:, start:end], self.W[start:end])
            evaluator(acc if icpt is None else (acc + icpt) * mask)

    @property
    def weight(self) -> int:
        return 2


@dataclasses.dataclass(eq=False)
class BlockLeastSquaresEstimator(LabelEstimator, CostModel):
    """Gauss-Seidel block coordinate descent for L2-regularized least
    squares (reference: BlockLinearMapper.scala:199-283). ``num_iter``
    sweeps over ``ceil(D / block_size)`` blocks; one sweep is the
    reference's single-pass path (solveOnePassL2)."""

    block_size: int
    num_iter: int = 1
    lam: float = 0.0
    num_features: Optional[int] = None  # pad/truncate hint, parity only
    solve: str = "device"  # "device" (float32 Cholesky + refinement on
    # the device, one host sync per block) | "host" (float64 LAPACK per
    # block, for badly conditioned systems: the Gram and right-hand side
    # go to the host and back each block)
    checkpoint_path: Optional[str] = None  # periodic loop-state snapshot;
    # a re-run with the same path resumes at the last completed block
    # (reference: lineage checkpoint every 25 blocks,
    # KernelRidgeRegression.scala:200-210 — see utils/checkpoint.py)
    checkpoint_every: int = 25
    block_callback: Optional[Callable[[int], None]] = None  # called with a
    # running count after each completed block update

    def fit(self, data: Dataset, labels: Dataset) -> BlockLinearMapper:
        if self.solve not in ("device", "host"):
            raise ValueError(f"solve must be 'device' or 'host', got {self.solve!r}")
        if data.is_host:
            return self._fit_host_blocks(data, labels)
        # Mean-centering of features and labels (the reference fits
        # StandardScaler(normalizeStdDev=false) per block + labels,
        # BlockLinearMapper.scala:209-215) happens in the Gram algebra:
        # X is never copied, only each bf16 block upcast
        data = data.to_array_mode()
        mesh = data.mesh
        X = data.local()
        Y = labels.local_like(data).to(X.device)
        n = data.n
        D = X.shape[1]
        k = Y.shape[1]
        mask = data.mask()
        blocks = [
            (s, min(s + self.block_size, D) - s)
            for s in range(0, D, self.block_size)
        ]
        (mu,) = all_sum(
            mesh, torch.cat([torch.matmul(mask, _f32(X[:, s : s + w])) for s, w in blocks]))
        mu = mu / n
        mu_y, R = _prep_labels(Y, mask, n, mesh)
        Wb: Dict[int, torch.Tensor] = {
            s: torch.zeros((w, k), dtype=torch.float32, device=X.device)
            for s, w in blocks
        }

        ckpt = None
        start_it, start_pos = 0, 0
        if self.checkpoint_path is not None:
            # stamp config + problem shape + a cheap data probe so a
            # snapshot from a different fit is discarded, not resumed
            fp = (
                f"bls bs={self.block_size} it={self.num_iter} "
                f"lam={self.lam} solve={self.solve} n={n} D={D} k={k} "
                f"probe={data_probe(X, Y)}"
            )
            ckpt, writes = _checkpointer(self.checkpoint_path, self.checkpoint_every, fp, mesh)
            state = ckpt.load()
            if state is not None:
                start_it = int(state["it"])
                start_pos = int(state["pos"])
                for s, w in blocks:
                    if not np.any(state[f"Wb_{s}"]):
                        continue  # untouched block: zero contribution
                    Wb[s] = torch.as_tensor(state[f"Wb_{s}"], dtype=torch.float32,
                                            device=X.device)
                    # rebuild the residual from the compact snapshot: the
                    # lineage-truncation analogue
                    _add_contribution(R, _f32(X[:, s : s + w]), Wb[s],
                                      mu[s : s + w], mask, -1.0)

        def snapshot(next_it: int, next_pos: int):
            st = {"it": next_it, "pos": next_pos}
            for s, _ in blocks:
                st[f"Wb_{s}"] = Wb[s].cpu().numpy()
            return st

        done = 0
        for it, pos, nxt in two_level_schedule(
            self.num_iter, len(blocks), (start_it, start_pos)
        ):
            s, w = blocks[pos]
            # on sweep 0 this block's model is zero in every path (a resumed
            # fit revisits only never-completed blocks in sweep 0)
            Wb[s] = _block_update(
                _f32(X[:, s : s + w]), R, Wb[s], mu[s : s + w], mask, self.lam, n,
                first_pass=(it == 0),
                last_pass=(it == self.num_iter - 1 and pos == len(blocks) - 1),
                host_solve=self.solve == "host", mesh=mesh,
            )
            done += 1
            if ckpt is not None and writes:
                ckpt.tick(lambda: snapshot(*nxt))
            if self.block_callback is not None:
                self.block_callback(done)
        if ckpt is not None and writes:
            ckpt.clear()  # fit completed; stale state must not leak into
            # a later fit at the same path
        W = torch.cat([Wb[s] for s, _ in blocks], dim=0)
        return BlockLinearMapper(W, self.block_size, feature_mean=mu, label_mean=mu_y)

    def _fit_host_blocks(self, data: Dataset, labels: Dataset
                         ) -> BlockLinearMapper:
        """A fit whose X lives in host RAM as column blocks
        (``Dataset.from_host_blocks``; the cluster-RAM feature cache of
        BlockLinearMapper.scala:50-73). Each (padded_n, w) slab is uploaded
        per pass, the next slab's upload double-buffered against the
        current block's Gram, solve and update; the device holds at most 3
        slabs, the residual and the solve's workspace, whatever D is. The
        solves stay on the device (``solve`` is not read, as in the JAX
        package).

        The dataset's own block layout is the coordinate-descent blocking
        (``block_size`` is not read), as the reference's Seq of feature
        RDDs defines its blocks. Each block's feature mean is taken on
        the slab's first visit."""
        if not data.is_sharded and torch.distributed.is_initialized():
            shards = mesh_lib.n_data_shards()
            if shards > 1 and data.padded_n % shards == 0:
                data = data.shard()
        mesh = data.mesh
        blocks = data.host_blocks
        widths = data.block_widths
        n = data.n
        dev = data.device
        mask = data.mask()
        Y = labels.local_like(data).to(dev)
        mu_y, R = _prep_labels(Y, mask, n, mesh)
        k = Y.shape[1]
        nb = len(blocks)
        Wb: List[torch.Tensor] = [
            torch.zeros((w, k), dtype=torch.float32, device=dev) for w in widths
        ]
        mu_bs: List[Optional[torch.Tensor]] = [None] * nb
        slabs = _SlabStream(blocks, dev)

        ckpt = None
        start_it, start_pos = 0, 0
        if self.checkpoint_path is not None:
            fp = (
                f"bls-host nb={nb} widths={widths} it={self.num_iter} "
                f"lam={self.lam} n={n} k={k} "
                f"probe={_host_blocks_probe(blocks, Y)}"
            )
            ckpt, writes = _checkpointer(self.checkpoint_path, self.checkpoint_every, fp, mesh)
            state = ckpt.load()
            if state is not None:
                start_it = int(state["it"])
                start_pos = int(state["pos"])
                for bi in range(nb):
                    if not np.any(state[f"Wb_{bi}"]):
                        continue
                    Wb[bi] = torch.as_tensor(state[f"Wb_{bi}"], dtype=torch.float32,
                                             device=dev)
                    handle = slabs.put(bi)
                    Xb = _f32(slabs.acquire(handle))
                    mu_bs[bi] = _column_sums(Xb, mask, mesh) / n
                    _add_contribution(R, Xb, Wb[bi], mu_bs[bi], mask, -1.0)
                    slabs.release(handle)

        def snapshot(next_it: int, next_pos: int):
            st = {"it": next_it, "pos": next_pos}
            for bi in range(nb):
                st[f"Wb_{bi}"] = Wb[bi].cpu().numpy()
            return st

        schedule = list(two_level_schedule(
            self.num_iter, nb, (start_it, start_pos)
        ))
        done = 0
        nxt = slabs.put(schedule[0][1]) if schedule else None
        for j, (it, bi, nxt_state) in enumerate(schedule):
            cur = nxt
            if j + 1 < len(schedule):
                nxt = slabs.put(schedule[j + 1][1])  # prefetch: double buffer
            Xb = _f32(slabs.acquire(cur))
            first = it == 0
            if first:
                mu_bs[bi] = _column_sums(Xb, mask, mesh) / n
            elif mu_bs[bi] is None:
                mu_bs[bi] = torch.zeros((widths[bi],), dtype=torch.float32, device=dev)
            Wb[bi] = _block_update(
                Xb, R, Wb[bi], mu_bs[bi], mask, self.lam, n, first_pass=first,
                last_pass=(it == self.num_iter - 1 and bi == nb - 1), mesh=mesh,
            )
            slabs.release(cur)
            done += 1
            if ckpt is not None and writes:
                ckpt.tick(lambda: snapshot(*nxt_state))
            if self.block_callback is not None:
                self.block_callback(done)
        if ckpt is not None and writes:
            ckpt.clear()
        W = torch.cat(Wb, dim=0)
        mu = torch.cat(mu_bs, dim=0)
        return BlockLinearMapper(W, max(widths), feature_mean=mu, label_mean=mu_y)

    @property
    def weight(self) -> int:
        # reference: BlockLinearMapper.scala:204
        return 3 * self.num_iter + 1

    def cost(self, n, d, k, sparsity, num_machines, cpu_weight=H100_CPU_WEIGHT,
             mem_weight=H100_MEM_WEIGHT, network_weight=H100_NETWORK_WEIGHT) -> float:
        """Analytic flops/mem/net cost (reference:
        BlockLinearMapper.scala:268-282)."""
        flops = n * float(d) * (self.block_size + k) / num_machines
        bytes_scanned = n * float(d) / num_machines + float(d) * k
        network = (
            2.0
            * (float(d) * (self.block_size + k))
            * max(math.log2(num_machines), 1.0)
        )
        return self.num_iter * (
            max(cpu_weight * flops, mem_weight * bytes_scanned)
            + network_weight * network
        )
