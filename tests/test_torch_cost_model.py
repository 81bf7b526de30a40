"""The port's per-bucket cost model on the CPU, held against the JAX
package's (``observability/device.CostCounter`` against
``compiled_cost_model``): on the demo chain at the serve-bench defaults
(``build_pipeline(256, 512, 4)``, buckets 8 and 32, one seed) the
per-bucket ``flops`` and ``transcendentals`` equal JAX's exactly, and
``bytes_accessed`` is at least JAX's (the port does not fuse: 1.036x at
bucket 8 and 1.115x at bucket 32 when this was written); each kernel
wrapper reports its moved formula on the CPU route, at two shapes, and
the plain version under it counts nothing more; with both peaks set by
env, both packages' ``/metrics`` carry ``keystone_serving_mfu`` and
``keystone_device_roofline_bound`` with one roofline class per bucket;
and a shared zoo unit's ``split_cost_model`` sums to its cost model."""

import numpy as np
import pytest
import torch

from keystone_tpu.observability import device as jax_device
from keystone_tpu.observability import prometheus as jax_prom
from keystone_tpu.observability.registry import get_global_registry as jax_global_registry
from keystone_tpu.serving import bench as jbench
from keystone_tpu_torch.observability import device, prometheus
from keystone_tpu_torch.observability.registry import get_global_registry
from keystone_tpu_torch.ops.images import fv_kernel, kernels, lcs, sift
from keystone_tpu_torch.serving import bench as tbench
from keystone_tpu_torch.serving.featurize import build_featurize_pipeline as tdemo
from keystone_tpu_torch.serving.featurize import build_flagship_featurize_pipeline as tflagship
from keystone_tpu_torch.zoo import SharedPrefixEngine

D, HIDDEN, DEPTH, BUCKETS = 256, 512, 4, (8, 32)


@pytest.fixture(scope="module")
def engines():
    import jax.numpy as jnp

    jeng = jbench.build_pipeline(D, HIDDEN, DEPTH).compiled(buckets=BUCKETS)
    jeng.warmup(example=jnp.zeros((D,), jnp.float32))
    teng = tbench.build_pipeline(D, HIDDEN, DEPTH, device="cpu").compiled(BUCKETS, device="cpu")
    teng.warmup(example=np.zeros((D,), np.float32))
    return jeng, teng


def test_demo_chain_cost_model_matches_jax(engines):
    jeng, teng = engines
    for b in BUCKETS:
        want, got = jeng.metrics.cost_models[b], teng.metrics.cost_models[b]
        assert got["flops"] == want["flops"] == 2 * b * (D * HIDDEN + 2 * HIDDEN ** 2 + HIDDEN * D)
        assert got["transcendentals"] == want["transcendentals"] == b * (3 * HIDDEN + D)
        assert got["bytes_accessed"] >= want["bytes_accessed"]
        # the fields JAX takes from the memory analysis stay absent
        assert set(got) == {"flops", "bytes_accessed", "transcendentals"}
    assert teng.kernel_costs == {8: {}, 32: {}}


def test_cost_model_counts_once_per_bucket_and_not_on_replays():
    eng = tbench.build_pipeline(16, 16, 2, device="cpu").compiled((4, 8), device="cpu")
    x = np.ones((3, 16), np.float32)
    eng.apply(x)  # the first eager dispatch of bucket 4 counts it
    assert set(eng.metrics.cost_models) == {4}
    first = dict(eng.metrics.cost_models[4])
    eng.apply(x)
    eng.apply(np.ones((7, 16), np.float32))
    assert eng.metrics.cost_models[4] == first and set(eng.metrics.cost_models) == {4, 8}
    assert eng.metrics.device_flops.total == 2 * first["flops"] + eng.metrics.cost_models[8]["flops"]


def _extents(op: np.ndarray, axis: int) -> int:
    """Σ over the slices of ``op`` along ``axis`` of (last nonzero + 1 −
    first nonzero), 0 for an all-zero slice."""
    nz = op != 0 if axis == 1 else (op != 0).T
    total = 0
    for row in nz:
        idx = np.flatnonzero(row)
        total += int(idx[-1] + 1 - idx[0]) if idx.size else 0
    return total


@pytest.mark.parametrize("shape", [(2, 50, 70, 10, 17), (3, 64, 64, 14, 14)])
def test_sift_bin_sample_reports_its_formula(shape):
    B, H, W, nh, nw = shape
    g = torch.Generator().manual_seed(0)
    mag, t = torch.rand(B, H, W, generator=g), torch.rand(B, H, W, generator=g) * 8
    ayt = sift._sampling_matrix(H, nh, 4, 3, 9).T.copy()
    ax = sift._sampling_matrix(W, nw, 4, 3, 9).copy()
    M, N = ayt.shape[0], ax.shape[1]
    flops = 2 * B * 8 * (_extents(ayt, 1) * W + _extents(ax, 0) * M)
    nbytes = 4 * (2 * B * H * W + ayt.size + ax.size + B * 8 * M * N)
    ayt_t, ax_t = torch.as_tensor(ayt), torch.as_tensor(ax)
    for bands in (None, kernels.operator_bands(ayt_t, ax_t)):
        with device.CostCounter() as c:
            out = kernels.sift_bin_sample(mag, t, ayt_t, ax_t, bands)
        assert tuple(out.shape) == (B, 8, M, N)
        assert kernels.sift_bin_sample_work(mag, ayt_t, ax_t, bands) == (flops, nbytes)
        assert c.kernels == {"sift_bin_sample": {"flops": flops, "bytes_accessed": nbytes,
                                                 "transcendentals": 0.0, "calls": 1}}
        # paused inside: the plain version's dense matmuls add nothing
        assert c.model() == {"flops": flops, "bytes_accessed": nbytes, "transcendentals": 0.0}
    with device.CostCounter() as plain:
        kernels.sift_bin_sample_plain(mag, t, ayt_t, ax_t)
    assert plain.model()["flops"] == 2 * B * 8 * M * H * W + 2 * B * 8 * M * W * N > flops


@pytest.mark.parametrize("img", [48, 64])
def test_plane_sandwich_reports_its_formula(img):
    at, bm, bands, *_ = lcs.LCSExtractor(4, 16, 6).operators(img, img, "cpu")
    B, P = 2, 6
    planes = torch.rand(B, P, img, img, generator=torch.Generator().manual_seed(1))
    M, N = at.shape[0], bm.shape[1]
    flops = 2 * B * P * (_extents(at.numpy(), 1) * img + _extents(bm.numpy(), 0) * M)
    nbytes = 4 * (planes.numel() + at.numel() + bm.numel() + B * P * M * N)
    with device.CostCounter() as c:
        kernels.plane_sandwich(planes, at, bm, bands)
    assert c.kernels["plane_sandwich"]["flops"] == flops
    assert c.model() == {"flops": flops, "bytes_accessed": nbytes, "transcendentals": 0.0}


@pytest.mark.parametrize("shape", [(2, 16, 100, 8), (1, 64, 37, 32)])
def test_fisher_vector_stats_reports_its_formula(shape):
    B, d, m, k = shape
    g = torch.Generator().manual_seed(2)
    x = torch.randn(B, d, m, generator=g)
    means, variances = torch.randn(d, k, generator=g), torch.rand(d, k, generator=g) + 0.5
    weights = torch.full((k,), 1.0 / k)
    with device.CostCounter() as c:
        fv_kernel.fisher_vector_stats(x, means, variances, weights)
    want = {"flops": B * m * (8 * d * k + 12 * k),
            "bytes_accessed": 4 * (B * d * m + 2 * d * k + k + B * (1 + 2 * d) * k),
            "transcendentals": B * m * k}
    assert c.model() == want
    assert c.kernels["fisher_vector_stats"]["calls"] == 1


def test_flagship_engine_counts_all_three_kernels():
    # vocab 32: the Fisher vector takes B3 (FUSED_MIN_K)
    feat, d = tflagship(img=48, desc_dim=8, vocab=32, device="cpu")
    head = tbench.build_pipeline(d, 8, 2, device="cpu")
    eng = head.compiled((2,), featurize=feat, device="cpu")
    eng.warmup(example=np.zeros((48, 48, 3), np.uint8))
    kc = eng.kernel_costs[2]
    assert set(kc) == {"sift_bin_sample", "plane_sandwich", "fisher_vector_stats"}
    # two SIFT scales, one LCS sandwich, one FV statistics call a branch
    assert [kc[k]["calls"] for k in sorted(kc)] == [2, 1, 2]
    model = eng.metrics.cost_models[2]
    assert model["flops"] > sum(v["flops"] for v in kc.values()) > 0


def _family_lines(text, engine):
    return [ln for ln in text.splitlines()
            if not ln.startswith("#") and f'engine="{engine}"' in ln]


def test_mfu_and_roofline_on_metrics_with_peaks(monkeypatch):
    import jax.numpy as jnp

    # ridge 10 FLOP/byte: between bucket 8's intensity (3.6 port, 3.7
    # JAX) and bucket 32's (11.1 port, 12.4 JAX)
    monkeypatch.setenv("KEYSTONE_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("KEYSTONE_PEAK_MEMBW_GBPS", "100")
    jax_device.reset_device_table()
    try:
        jeng = jbench.build_pipeline(D, HIDDEN, DEPTH).compiled(buckets=BUCKETS, name="cm-jax")
        jeng.warmup(example=jnp.zeros((D,), jnp.float32))
        teng = tbench.build_pipeline(D, HIDDEN, DEPTH, device="cpu").compiled(
            BUCKETS, device="cpu", name="cm-port")
        teng.warmup(example=np.zeros((D,), np.float32))
        x = np.random.default_rng(0).standard_normal((20, D)).astype(np.float32)
        for eng in (jeng, teng):
            eng.apply(x, sync=True)
            eng.apply(x[:5], sync=True)
        jtext = jax_prom.render(jax_global_registry().collect())
        ttext = prometheus.render(get_global_registry().collect())
    finally:
        jax_device.reset_device_table()

    def classes(lines):
        return sorted(ln.split("{")[1].split("}")[0].replace("cm-jax", "e").replace("cm-port", "e")
                      for ln in lines if ln.startswith("keystone_device_roofline_bound")
                      and ln.endswith(" 1"))

    jl, tl = _family_lines(jtext, "cm-jax"), _family_lines(ttext, "cm-port")
    for lines in (jl, tl):
        assert any(ln.startswith("keystone_serving_mfu{") for ln in lines), lines
    assert classes(tl) == classes(jl) == [
        'engine="e",bucket="32",bound="compute"', 'engine="e",bucket="8",bound="bandwidth"']
    assert teng.metrics.mfu() > 0


def test_split_cost_model_sums_to_the_units_cost_model():
    feat, d = tdemo(img=8, device="cpu")
    heads = {m: tbench.build_pipeline(d=d, hidden=8, depth=2, seed=s, device="cpu")
             for m, s in (("m1", 1), ("m2", 2))}
    eng = SharedPrefixEngine(feat, heads, (4,), device="cpu")
    assert eng.split_cost_model(4) is None  # before the bucket's counted run
    images = np.random.default_rng(0).integers(0, 256, (3, 8, 8, 3), dtype=np.uint8)
    eng.apply(images)
    prefix, head_flops = eng.split_cost_model(4)
    assert prefix > 0 and set(head_flops) == {"m1", "m2"}
    assert head_flops["m1"] == head_flops["m2"] == 2 * 4 * (d * 8 + 8 * d)
    assert prefix + sum(head_flops.values()) == eng.metrics.cost_models[4]["flops"]
