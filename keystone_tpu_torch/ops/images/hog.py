"""Histogram of Oriented Gradients, Felzenszwalb/voc-release variant
(counterpart of ``keystone_tpu/ops/images/hog.py``), batched over images
of one size.

Reference: nodes/images/HogExtractor.scala:33 (itself a translation of
Girshick's voc-dpm features.cc): per-pixel max-channel central-difference
gradient, snapping to 18 contrast-sensitive orientations via dot products
with 9 unit vectors, bilinear binning into binSize cells, 4-way block
normalization with 0.2 clamping, 27+4+1 features per interior cell.

The discrete steps follow the JAX package's: the highest channel wins a
tie of gradient magnitudes, the orientation is the first maximum of 18
interleaved candidates (+0, −0, +1, −1, ...) and only if it is above 0,
and the bilinear binning is four scatter-adds (``index_put_`` with
``accumulate``, whose order of additions is not fixed on CUDA). Images
of several sizes run one batch per size. Tensor work runs on ``device``
(``None`` means ``cuda``, raising without it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from keystone_tpu_torch._device import resolve_device
from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.workflow.api import Transformer

EPSILON = 0.0001
UU = np.array(
    [1.0, 0.9397, 0.766, 0.5, 0.1736, -0.1736, -0.5, -0.766, -0.9397]
)
VV = np.array(
    [0.0, 0.342, 0.6428, 0.866, 0.9848, 0.9848, 0.866, 0.6428, 0.342]
)


@dataclasses.dataclass(eq=False)
class HogExtractor(Transformer):
    """Image (X, Y, C) -> (numInteriorCells, 32) feature matrix."""

    bin_size: int
    device: Optional[str] = None

    def apply(self, img):
        return self.extract(torch.as_tensor(img)[None])[0]

    def apply_batch(self, ds: Dataset) -> Dataset:
        if not ds.is_array:  # images of several sizes: one batch per size
            return self._bucketed_batch(ds)
        return Dataset.from_array(self.extract(ds.padded()), n=ds.n)

    def extract(self, imgs: torch.Tensor) -> torch.Tensor:
        """(B, X, Y, C) images -> (B, numInteriorCells, 32)."""
        dev = resolve_device(self.device)
        img = torch.as_tensor(imgs).to(device=dev, dtype=torch.float32)
        b = self.bin_size
        B, X, Y, C = img.shape
        nx = int(round(X / b))
        ny = int(round(Y / b))
        vis_x = min(nx * b, X)
        vis_y = min(ny * b, Y)
        nxf = max(nx - 2, 0)
        nyf = max(ny - 2, 0)
        if nxf == 0 or nyf == 0:
            return torch.zeros((B, 0, 32), dtype=torch.float32, device=dev)

        # -- per-pixel gradient, max-magnitude channel ------------------
        sub = img[:, :vis_x, :vis_y]
        dx = sub[:, 2:, 1:-1, :] - sub[:, :-2, 1:-1, :]
        dy = sub[:, 1:-1, 2:, :] - sub[:, 1:-1, :-2, :]
        mag2 = dx * dx + dy * dy
        # the highest channel index wins ties: the first max of the
        # channels reversed
        ch = (C - 1 - torch.argmax(mag2.flip(-1), dim=-1))[..., None]
        gx = torch.gather(dx, -1, ch)[..., 0]
        gy = torch.gather(dy, -1, ch)[..., 0]
        mag = torch.sqrt(torch.gather(mag2, -1, ch)[..., 0])

        # -- orientation snapping ---------------------------------------
        uu = torch.as_tensor(UU, dtype=torch.float32, device=dev)
        vv = torch.as_tensor(VV, dtype=torch.float32, device=dev)
        dots = uu * gy[..., None] + vv * gx[..., None]  # (B, px, py, 9)
        cand = torch.stack([dots, -dots], dim=-1).reshape(dots.shape[:-1] + (18,))
        arg = torch.argmax(cand, dim=-1)
        orient = (arg // 2) + 9 * (arg % 2)
        orient = torch.where(torch.amax(cand, dim=-1) > 0.0, orient, 0)

        # -- bilinear binning into cells --------------------------------
        xs = torch.arange(1, vis_x - 1, device=dev)
        ys = torch.arange(1, vis_y - 1, device=dev)
        px = xs[:, None] * torch.ones_like(ys)[None, :]
        py = torch.ones_like(xs)[:, None] * ys[None, :]
        xp = (px + 0.5) / b - 0.5
        yp = (py + 0.5) / b - 0.5
        ixp = torch.floor(xp).to(torch.int64)
        iyp = torch.floor(yp).to(torch.int64)
        vx0 = xp - ixp
        vy0 = yp - iyp
        hist = torch.zeros((B, nx, ny, 18), dtype=torch.float32, device=dev)
        bi = torch.arange(B, device=dev)[:, None, None].expand(orient.shape)

        def scatter(cx, cy, w):
            ok = (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
            cxc = torch.clamp(cx, 0, nx - 1).expand(orient.shape)
            cyc = torch.clamp(cy, 0, ny - 1).expand(orient.shape)
            hist.index_put_((bi, cxc, cyc, orient),
                            torch.where(ok, w * mag, 0.0), accumulate=True)

        scatter(ixp, iyp, (1 - vx0) * (1 - vy0))
        scatter(ixp, iyp + 1, (1 - vx0) * vy0)
        scatter(ixp + 1, iyp, vx0 * (1 - vy0))
        scatter(ixp + 1, iyp + 1, vx0 * vy0)

        # -- block energies ---------------------------------------------
        combined = hist[..., :9] + hist[..., 9:]
        norm = torch.sum(combined * combined, dim=-1)  # (B, nx, ny)

        def block(nox, noy):
            return (
                norm[:, nox:nox + nxf, noy:noy + nyf]
                + norm[:, nox + 1:nox + 1 + nxf, noy:noy + nyf]
                + norm[:, nox:nox + nxf, noy + 1:noy + 1 + nyf]
                + norm[:, nox + 1:nox + 1 + nxf, noy + 1:noy + 1 + nyf]
            )

        ns = [1.0 / torch.sqrt(block(ox, oy) + EPSILON)[..., None]
              for ox, oy in ((1, 1), (0, 1), (1, 0), (0, 0))]

        h_cell = hist[:, 1:1 + nxf, 1:1 + nyf, :]  # (B, nxf, nyf, 18)
        hs = [torch.clamp(h_cell * n, max=0.2) for n in ns]
        sensitive = 0.5 * (hs[0] + hs[1] + hs[2] + hs[3])  # 18 features

        c_cell = combined[:, 1:1 + nxf, 1:1 + nyf, :]  # (B, nxf, nyf, 9)
        cs = [torch.clamp(c_cell * n, max=0.2) for n in ns]
        insensitive = 0.5 * (cs[0] + cs[1] + cs[2] + cs[3])  # 9 features

        texture = 0.2357 * torch.stack([torch.sum(h, -1) for h in hs], dim=-1)  # 4
        trunc = torch.zeros(texture.shape[:-1] + (1,), dtype=torch.float32, device=dev)

        feats = torch.cat([sensitive, insensitive, texture, trunc], dim=-1)
        # row index: y + x * numYCellsWithFeatures (reference layout)
        return feats.reshape(B, nxf * nyf, 32)
