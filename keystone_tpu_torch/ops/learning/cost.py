"""Solver cost models (counterpart of ``keystone_tpu/ops/learning/cost.py``).

``cost(n, d, k, sparsity, numMachines, cpuWeight, memWeight,
networkWeight)``: each solver counts its FLOPs, the elements it scans and
the elements it sends; the weights turn the counts into seconds. The
weights here are one H100's, from NVIDIA's data sheet (SXM, 700 W): a
FLOP at the 67 TFLOP/s float32 rate of the CUDA cores, a float32 element
at 3.35 TB/s of HBM3. The network term keeps the JAX package's per-element
constant: the port runs on one device, so it only ranks options that
would gather data against those that would not. The formulas per solver
are the JAX package's.
"""

from __future__ import annotations

H100_CPU_WEIGHT = 1.0 / 67e12
H100_MEM_WEIGHT = 4.0 / 3.35e12
H100_NETWORK_WEIGHT = 1e-6


class CostModel:
    """Mix-in: analytic cost of running this operator."""

    def cost(
        self,
        n: int,
        d: int,
        k: int,
        sparsity: float,
        num_machines: int,
        cpu_weight: float = H100_CPU_WEIGHT,
        mem_weight: float = H100_MEM_WEIGHT,
        network_weight: float = H100_NETWORK_WEIGHT,
    ) -> float:
        raise NotImplementedError
