"""The port's kernel wrappers on the CPU (keystone_tpu_torch/ops/images/
kernels.py, fv_kernel.py): their plain versions against the JAX package's
Pallas kernels (run in interpret mode, as the JAX tests run them),
batched against per-image, launch counters untouched by CPU calls, and
the loader's sources present. The CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.ops.images.fv_pallas import fisher_vector_stats_pallas
from keystone_tpu.ops.images.pallas_kernels import (
    plane_sandwich as jax_plane_sandwich,
    sift_bin_sample as jax_sift_bin_sample,
)
from keystone_tpu_torch import _cuda
from keystone_tpu_torch.ops.images import fv_kernel, kernels, lcs, sift

# the bars of tests/ops/test_pallas_kernels.py and tests/ops/test_fv_pallas.py
SANDWICH_TOL = dict(rtol=1e-4, atol=1e-4)
FV_TOL = dict(rtol=1e-3, atol=1e-4)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _sift_inputs(rng, B, H, W, M, N):
    mag = rng.random((B, H, W)).astype(np.float32)
    t = (rng.random((B, H, W)) * 8).astype(np.float32)
    ayt = rng.standard_normal((M, H)).astype(np.float32)
    ax = rng.standard_normal((W, N)).astype(np.float32)
    return mag, t, ayt, ax


def _gmm(rng, d, k):
    means = rng.standard_normal((d, k)).astype(np.float32)
    variances = (0.5 + rng.random((d, k))).astype(np.float32)
    weights = rng.random(k).astype(np.float32) + 0.1
    return means, variances, (weights / weights.sum()).astype(np.float32)


@pytest.mark.parametrize("H,W,M,N", [(24, 20, 12, 8), (48, 48, 40, 36)])
def test_sift_bin_sample_plain_matches_jax_kernel(H, W, M, N):
    rng = np.random.default_rng(0)
    mag, t, ayt, ax = _sift_inputs(rng, 2, H, W, M, N)
    got = kernels.sift_bin_sample(_t(mag), _t(t), _t(ayt), _t(ax)).numpy()
    assert got.shape == (2, 8, M, N)
    for b in range(2):
        want = np.asarray(jax_sift_bin_sample(
            jnp.asarray(mag[b]), jnp.asarray(t[b]), jnp.asarray(ayt),
            jnp.asarray(ax), interpret=True,
        ))
        np.testing.assert_allclose(got[b], want, **SANDWICH_TOL)


@pytest.mark.parametrize("P,H,W,M,N", [(6, 18, 22, 9, 7), (2, 40, 32, 16, 20)])
def test_plane_sandwich_plain_matches_jax_kernel(P, H, W, M, N):
    rng = np.random.default_rng(1)
    planes = rng.standard_normal((2, P, H, W)).astype(np.float32)
    at = rng.standard_normal((M, H)).astype(np.float32)
    b = rng.standard_normal((W, N)).astype(np.float32)
    got = kernels.plane_sandwich(_t(planes), _t(at), _t(b)).numpy()
    assert got.shape == (2, P, M, N)
    for i in range(2):
        want = np.asarray(jax_plane_sandwich(
            jnp.asarray(planes[i]), jnp.asarray(at), jnp.asarray(b),
            interpret=True,
        ))
        np.testing.assert_allclose(got[i], want, **SANDWICH_TOL)


@pytest.mark.parametrize("d,k,m", [(8, 8, 100), (16, 32, 700), (64, 32, 300)])
def test_fisher_vector_stats_plain_matches_jax_kernel(d, k, m):
    """m = 700 spans two of the TPU kernel's 512-row tiles (pad rows
    masked there; none here); (64, 32, 300) is the flagship's d and k with
    m ragged against any chunk size."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, d, m)).astype(np.float32)
    means, variances, weights = _gmm(rng, d, k)
    got = fv_kernel.fisher_vector_stats(
        _t(x), _t(means), _t(variances), _t(weights), 1e-4
    )
    assert [tuple(g.shape) for g in got] == [(2, k), (2, d, k), (2, d, k)]
    for b in range(2):
        want = fisher_vector_stats_pallas(
            jnp.asarray(x[b]), jnp.asarray(means), jnp.asarray(variances),
            jnp.asarray(weights), 1e-4, interpret=True,
        )
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(w), **FV_TOL)


def _numpy_extents(op, axis):
    """[lo, hi) of the nonzeros of each slice along ``axis``, by numpy."""
    nz = np.moveaxis(op != 0, axis, -1)
    lo = np.where(nz.any(-1), nz.argmax(-1), 0)
    hi = np.where(nz.any(-1), nz.shape[-1] - nz[..., ::-1].argmax(-1), 0)
    return np.stack([lo, hi])


def _serving_operators(name):
    """(ayt (M, H), ax (W, N)) of one SIFT scale or of LCS, at 256²."""
    if name == "lcs":
        axt, ay, *_ = lcs.LCSExtractor(4, 16, 6).operators(256, 256, "cpu")
        return axt, ay
    scale = int(name[-1])
    _, ayt, ax, _ = sift.scale_operators(256, 256, 3, 4, 4, 1, "cpu")[scale]
    return ayt, ax


@pytest.mark.parametrize("name", ["sift0", "sift1", "sift2", "sift3", "lcs"])
def test_band_extents_of_the_serving_operators(name):
    ayt, ax = _serving_operators(name)
    rows, cols = kernels.band_extents(ayt, 1), kernels.band_extents(ax, 0)
    assert rows.dtype == cols.dtype == torch.int32
    np.testing.assert_array_equal(rows.numpy(), _numpy_extents(ayt.numpy(), 1))
    np.testing.assert_array_equal(cols.numpy(), _numpy_extents(ax.numpy(), 0))
    # banded: a SIFT column holds 4 to 19 nonzeros, an LCS one 6
    assert int((rows[1] - rows[0]).max()) <= 19 and int((cols[1] - cols[0]).max()) <= 19


def test_band_extents_of_dense_and_zero_slices():
    rng = np.random.default_rng(5)
    op = torch.as_tensor(rng.standard_normal((6, 9)).astype(np.float32))
    assert kernels.band_extents(op, 1).tolist() == [[0] * 6, [9] * 6]
    assert kernels.band_extents(op, 0).tolist() == [[0] * 9, [6] * 9]
    op[2] = 0.0
    op[4, :3] = 0.0
    op[4, 7:] = 0.0
    rows = kernels.band_extents(op, 1)
    assert rows[:, 2].tolist() == [0, 0] and rows[:, 4].tolist() == [3, 7]


def test_sift_bin_sample_with_banded_operators_matches_jax_kernel():
    """The real SIFT operators of a 48² image, extents passed as the
    extractor passes them, against the JAX kernel in interpret mode."""
    rng = np.random.default_rng(6)
    mag = rng.random((2, 48, 48)).astype(np.float32)
    t = (rng.random((2, 48, 48)) * 8).astype(np.float32)
    ops = [o for o in sift.scale_operators(48, 48, 3, 4, 3, 1, "cpu") if o[1] is not None]
    assert len(ops) == 3
    for _, ayt, ax, bands in ops:
        got = kernels.sift_bin_sample(_t(mag), _t(t), ayt, ax, bands).numpy()
        for b in range(2):
            want = np.asarray(jax_sift_bin_sample(
                jnp.asarray(mag[b]), jnp.asarray(t[b]), jnp.asarray(ayt.numpy()),
                jnp.asarray(ax.numpy()), interpret=True,
            ))
            np.testing.assert_allclose(got[b], want, **SANDWICH_TOL)


def test_sift_bands_order_rows_by_band_start():
    ayt, ax = _serving_operators("sift2")
    rows, cols, order = kernels.sift_bands(ayt, ax)
    assert order.dtype == torch.int32 and sorted(order.tolist()) == list(range(ayt.shape[0]))
    assert torch.equal(rows, kernels.band_extents(ayt, 1))
    assert torch.equal(cols, kernels.band_extents(ax, 0))
    starts = rows[0][order.long()]
    assert bool((starts[1:] >= starts[:-1]).all())


def test_sift_bin_sample_rejects_bad_bands():
    x = torch.zeros((1, 8, 8))
    ayt, ax = torch.zeros((4, 8)), torch.zeros((8, 5))
    rows, cols, order = kernels.sift_bands(ayt, ax)
    with pytest.raises(ValueError, match="bands must be"):
        kernels.sift_bin_sample(x, x, ayt, ax, (rows, cols))
    with pytest.raises(ValueError, match=r"shape \(2, 5\)"):
        kernels.sift_bin_sample(x, x, ayt, ax, (rows, cols[:, :4].contiguous(), order))
    with pytest.raises(ValueError, match=r"shape \(4,\)"):
        kernels.sift_bin_sample(x, x, ayt, ax, (rows, cols, order[:3]))
    with pytest.raises(TypeError, match="int32"):
        kernels.sift_bin_sample(x, x, ayt, ax, (rows.long(), cols, order))
    with pytest.raises(TypeError, match="int32"):
        kernels.sift_bin_sample(x, x, ayt, ax, (rows, cols, order.long()))
    with pytest.raises(ValueError, match="device"):
        kernels.sift_bin_sample(x, x, ayt, ax, (rows.to("meta"), cols, order))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.sift_bin_sample(x, x, ayt, ax, (rows, torch.zeros((5, 2), dtype=torch.int32).T, order))


def test_batched_matches_per_image():
    rng = np.random.default_rng(3)
    mag, t, ayt, ax = (_t(a) for a in _sift_inputs(rng, 3, 16, 14, 6, 5))
    batched = kernels.sift_bin_sample(mag, t, ayt, ax)
    for i in range(3):
        one = kernels.sift_bin_sample(mag[i : i + 1], t[i : i + 1], ayt, ax)
        torch.testing.assert_close(batched[i : i + 1], one, rtol=1e-6, atol=1e-6)
    planes = torch.as_tensor(rng.standard_normal((3, 4, 10, 12)).astype(np.float32))
    at, b = ayt[:, :10].contiguous(), ax[:12].contiguous()
    batched = kernels.plane_sandwich(planes, at, b)
    for i in range(3):
        one = kernels.plane_sandwich(planes[i : i + 1], at, b)
        torch.testing.assert_close(batched[i : i + 1], one, rtol=1e-6, atol=1e-6)
    x = torch.as_tensor(rng.standard_normal((3, 8, 50)).astype(np.float32))
    gmm = [_t(a) for a in _gmm(rng, 8, 4)]
    batched = fv_kernel.fisher_vector_stats(x, *gmm)
    for i in range(3):
        one = fv_kernel.fisher_vector_stats(x[i : i + 1], *gmm)
        for bs, os_ in zip(batched, one):
            torch.testing.assert_close(bs[i : i + 1], os_, rtol=1e-6, atol=1e-7)


def test_cpu_calls_leave_launch_counters_at_zero():
    _cuda.reset_launches()
    rng = np.random.default_rng(4)
    mag, t, ayt, ax = (_t(a) for a in _sift_inputs(rng, 1, 8, 8, 4, 4))
    kernels.sift_bin_sample(mag, t, ayt, ax)
    kernels.plane_sandwich(mag[None], ayt, ax)
    fv_kernel.fisher_vector_stats(mag, *[_t(a) for a in _gmm(rng, 8, 2)])
    assert _cuda.LAUNCHES == {
        "sift_bin_sample": 0, "plane_sandwich": 0, "fisher_vector_stats": 0,
    }


def test_wrappers_reject_what_the_kernels_do_not_take():
    """No fallback: a device with neither kernel nor plain version, a
    wrong dtype, shape or layout all raise."""
    x = torch.zeros((1, 8, 8))
    a = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="device"):
        kernels.sift_bin_sample(x.to("meta"), x.to("meta"), a.to("meta"), a.T.contiguous().to("meta"))
    with pytest.raises(TypeError, match="float32"):
        kernels.plane_sandwich(x[None].double(), a, a.T.contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.plane_sandwich(x[None], a, a.T)
    with pytest.raises(ValueError, match="shapes disagree"):
        kernels.sift_bin_sample(x, x, torch.zeros((4, 7)), a.T.contiguous())
    with pytest.raises(ValueError, match="more than one device"):
        kernels.plane_sandwich(x[None], a.to("meta"), a.T.contiguous())


def test_every_loader_source_exists_and_exports_its_functions():
    for name, fns in _cuda.SIGNATURES.items():
        path = _cuda.source_path(name)
        assert os.path.isfile(path), path
        src = open(path).read()
        for fn in fns:
            assert re.search(rf"\bint {fn}\(", src), (fn, path)
    assert set(_cuda.SIGNATURES) == set(_cuda.SOURCES)
