"""Local Color Statistics (LCS) extractor, batched over images
(counterpart of ``keystone_tpu/ops/images/lcs.py``).

Per grid keypoint, the means and standard deviations of each channel over
a 4x4 neighborhood of sub-patches. Box-mean → sample is linear and
separable, so it is one sampling matrix per axis, applied to the image
and to its square in the ``plane_sandwich`` kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from keystone_tpu_torch.ops.images.kernels import plane_sandwich
from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.workflow.api import Transformer


def _box_filter_same(img: torch.Tensor, size: int) -> torch.Tensor:
    """(H, W, C) -> same-size box mean with the reference's asymmetric zero
    padding (floor((L-1)/2) low, the rest high)."""
    pad_low = (size - 1) // 2
    pad_high = size - 1 - pad_low
    k = torch.full((1, 1, size), 1.0 / size, dtype=torch.float32, device=img.device)

    def conv_axis(x, axis):
        moved = x.movedim(axis, -1)
        shape = moved.shape
        flat = F.pad(moved.reshape(-1, 1, shape[-1]), (pad_low, pad_high))
        return F.conv1d(flat, k).reshape(shape).movedim(-1, axis)

    return conv_axis(conv_axis(img, 0), 1)


def _lcs_sampling_matrix(
    n: int, keys: np.ndarray, offs: np.ndarray, s: int
) -> np.ndarray:
    """(n, n_keys·nb) one-axis operator: column k·nb + j holds the 1/s box
    window whose output position is keys[k] + offs[j] under the asymmetric
    zero padding (out-of-image taps drop)."""
    pad_low = (s - 1) // 2
    nb = len(offs)
    m = np.zeros((n, len(keys) * nb), np.float32)
    for k, x0 in enumerate(keys):
        for j, o in enumerate(offs):
            lo = x0 + o - pad_low
            for t in range(s):
                p = lo + t
                if 0 <= p < n:
                    m[p, k * nb + j] += 1.0 / s
    return m


@dataclasses.dataclass(eq=False)
class LCSExtractor(Transformer):
    """Image (X, Y, C) -> (numLCSValues, numKeypoints) descriptor matrix,
    column xKey·numPoolsY + yKey, row order: for each channel, for each
    (nx, ny) neighbor: [mean, std] interleaved."""

    stride: int
    stride_start: int
    sub_patch_size: int

    def operators(self, X: int, Y: int, device):
        """(x-axis operator transposed (M, X), y-axis operator (Y, N),
        keys along x, keys along y, neighbors per axis) for (X, Y) images
        on ``device``, built once per (X, Y, device)."""
        cache = self.__dict__.setdefault("_operator_cache", {})
        key = (X, Y, str(device))
        ops = cache.get(key)
        if ops is None:
            s = self.sub_patch_size
            xs = np.arange(self.stride_start, X - self.stride_start, self.stride)
            ys = np.arange(self.stride_start, Y - self.stride_start, self.stride)
            # neighborhood offsets: -2s + s/2 - 1 .. s + s/2 - 1 step s
            offs = np.arange(-2 * s + s // 2 - 1, s + s // 2, s)
            ax = _lcs_sampling_matrix(X, xs, offs, s)
            ay = _lcs_sampling_matrix(Y, ys, offs, s)
            ops = cache[key] = (
                torch.as_tensor(ax.T.copy(), device=device),
                torch.as_tensor(ay, device=device),
                len(xs), len(ys), len(offs),
            )
        return ops

    def extract(self, imgs: torch.Tensor) -> torch.Tensor:
        """(B, X, Y, C) images -> (B, numLCSValues, numKeypoints)."""
        img = imgs.to(torch.float32)
        B, X, Y, C = img.shape
        axt, ay, nxk, nyk, nb = self.operators(X, Y, img.device)
        # image and its square share the product chain as stacked planes
        z = torch.cat([img, img * img], dim=-1).permute(0, 3, 1, 2).contiguous()
        out = plane_sandwich(z, axt, ay)
        both = out.permute(0, 2, 3, 1)  # (B, nxk·nb, nyk·nb, 2C)
        m, sq = both[..., :C], both[..., C:]
        sd = torch.sqrt(torch.clamp(sq - m * m, min=0.0))

        def arrange(t):
            t = t.reshape(B, nxk, nb, nyk, nb, C)
            return t.permute(0, 5, 2, 4, 1, 3)  # (B, C, nbx, nby, xk, yk)

        inter = torch.stack([arrange(m), arrange(sd)], dim=4)
        return inter.reshape(B, -1, nxk * nyk)

    def apply(self, img):
        return self.extract(img[None])[0]

    def apply_batch(self, ds: Dataset) -> Dataset:
        return Dataset.from_array(self.extract(ds.padded()), n=ds.n)
