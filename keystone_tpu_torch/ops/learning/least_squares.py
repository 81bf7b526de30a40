"""Cost-model-driven least-squares solver selection (counterpart of
``keystone_tpu/ops/learning/least_squares.py``).

Reference: nodes/learning/LeastSquaresEstimator.scala:26-87 — an
OptimizableLabelEstimator whose physical options are Dense LBFGS,
Sparsify→Sparse LBFGS, Densify→BlockLS(1000, 3) and Densify→Exact
NormalEquations; it picks minBy(cost(n, d, k, sparsity, numMachines,
...)). The default weights are one H100's (``cost.py``); ``num_machines``
defaults to the data's shards (``Dataset.shard``; one when they are not
sharded), and the block path (Densify → BlockLS) fits sharded rows where
they are (``block_ls.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from keystone_tpu_torch.ops.learning.block_ls import BlockLeastSquaresEstimator
from keystone_tpu_torch.ops.learning.cost import (
    H100_CPU_WEIGHT,
    H100_MEM_WEIGHT,
    H100_NETWORK_WEIGHT,
)
from keystone_tpu_torch.ops.learning.lbfgs import DenseLBFGSwithL2, SparseLBFGSwithL2
from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator
from keystone_tpu_torch.ops.util.nodes import Densify, Sparsify
from keystone_tpu_torch.parallel import mesh as mesh_lib
from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.workflow.api import LabelEstimator
from keystone_tpu_torch.workflow.chain_utils import TransformerLabelEstimatorChain
from keystone_tpu_torch.workflow.node_optimization import Optimizable


@dataclasses.dataclass(eq=False)
class LeastSquaresEstimator(LabelEstimator, Optimizable):
    lam: float = 0.0
    num_machines: Optional[int] = None  # None: the data's shards
    cpu_weight: float = H100_CPU_WEIGHT
    mem_weight: float = H100_MEM_WEIGHT
    network_weight: float = H100_NETWORK_WEIGHT

    def _options(self):
        dense_lbfgs = DenseLBFGSwithL2(reg_param=self.lam, num_iterations=20)
        sparse_lbfgs = SparseLBFGSwithL2(reg_param=self.lam, num_iterations=20)
        block = BlockLeastSquaresEstimator(1000, 3, lam=self.lam)
        exact = LinearMapEstimator(lam=self.lam)
        return [
            (dense_lbfgs, dense_lbfgs),
            (sparse_lbfgs, TransformerLabelEstimatorChain(Sparsify(), sparse_lbfgs)),
            (block, TransformerLabelEstimatorChain(Densify(), block)),
            (exact, TransformerLabelEstimatorChain(Densify(), exact)),
        ]

    @property
    def default(self) -> LabelEstimator:
        return DenseLBFGSwithL2(reg_param=self.lam, num_iterations=20)

    def fit(self, data: Dataset, labels: Dataset):
        chosen = self.optimize([data, labels], data.n)
        return chosen.fit(data, labels)

    def fit_datasets(self, datasets):
        return self.fit(datasets[0], datasets[1])

    def optimize(self, samples, n_total: int) -> LabelEstimator:
        sample: Dataset = Dataset.of(samples[0])
        sample_labels: Dataset = Dataset.of(samples[1])
        first = sample.first()
        n = max(n_total, sample.n)
        if isinstance(first, torch.Tensor) and first.layout == torch.sparse_coo:
            d = int(np.prod(first.shape))
            sparsity = float(first.coalesce()._nnz()) / max(d, 1)
        else:
            arr = np.asarray(first.cpu() if isinstance(first, torch.Tensor) else first)
            d = int(arr.reshape(-1).shape[0])
            sparsity = float(np.count_nonzero(arr)) / max(d, 1)
        label = sample_labels.first()
        k = int(np.asarray(label.cpu() if isinstance(label, torch.Tensor) else label)
                .reshape(-1).shape[0])
        machines = self.num_machines or (
            mesh_lib.n_data_shards(sample.mesh) if sample.is_sharded else 1)
        return min(
            self._options(),
            key=lambda o: o[0].cost(
                n, d, k, sparsity, machines,
                self.cpu_weight, self.mem_weight, self.network_weight,
            ),
        )[1]

    @property
    def weight(self) -> int:
        return self.default.weight
