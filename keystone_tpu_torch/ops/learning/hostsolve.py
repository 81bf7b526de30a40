"""Host-side float64 solves for small regularized PSD systems (counterpart
of ``keystone_tpu/ops/learning/hostsolve.py``).

The reference's block solvers compute Gram matrices on executors but solve
the (b, b) systems on one node in double precision (mlmatrix
NormalEquations / BlockCoordinateDescent; nodes/learning/
BlockLinearMapper.scala:234-240). These systems can be ill-conditioned
(n < b blocks with tiny λ), beyond float32 Cholesky's eps. The
``solve="host"`` option of the block solver keeps the split: the O(n·b²)
Gram work stays on the device in float32; the O(b³) solve of a matrix
that fits on one host runs in numpy float64. Transfers are (b, b) + (b, k)
— small next to the Gram pass.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg


def psd_solve_host(gram, rhs, lam: float = 0.0) -> np.ndarray:
    """Solve (gram + lam·I) X = rhs in f64 on host; robust to indefiniteness
    from f32 rounding (falls back to eigh with eigenvalue clamping)."""
    G = np.asarray(gram, dtype=np.float64)
    R = np.asarray(rhs, dtype=np.float64)
    if lam:
        G = G + lam * np.eye(G.shape[0])
    try:
        c, low = scipy.linalg.cho_factor(G, check_finite=False)
        return scipy.linalg.cho_solve((c, low), R, check_finite=False)
    except np.linalg.LinAlgError:
        w, V = np.linalg.eigh(G)
        w = np.maximum(w, 1e-12 * max(w.max(), 1.0))
        return V @ ((V.T @ R) / w[:, None])
