"""The port's serving engine beyond the main path, on the CPU: metrics and
their scrape against the JAX package's, the host staging pool, the
micro-batcher serial and pipelined over the flagship chain (48² geometry)
against the JAX batcher, and the batcher's mechanics on a small
linear-head model. Every ``Future.result`` has a timeout and every
batcher is closed, so a hang fails one test."""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.observability import device as jax_device
from keystone_tpu.observability import prometheus as jax_prom
from keystone_tpu.observability.registry import MetricsRegistry as JaxRegistry
from keystone_tpu.ops.learning.block_ls import BlockLinearMapper
from keystone_tpu.ops.util.nodes import TopKClassifier
from keystone_tpu.serving import autoscale as jax_autoscale
from keystone_tpu.serving.batching import MicroBatcher as JaxBatcher
from keystone_tpu.serving.featurize import (
    build_flagship_featurize_pipeline as jax_build,
)
from keystone_tpu.serving.metrics import ServingMetrics as JaxMetrics
from keystone_tpu.serving.pipeline import HostBufferPool as JaxPool
from keystone_tpu.utils.profiling import LatencyRecorder as JaxRecorder
from keystone_tpu_torch import _cuda, convert
from keystone_tpu_torch.loadgen import faults
from keystone_tpu_torch.observability import device, prometheus
from keystone_tpu_torch.observability.registry import MetricsRegistry
from keystone_tpu_torch.serving import (
    CompiledPipeline,
    HostBufferPool,
    MicroBatcher,
    ServingMetrics,
    padding_waste,
    suggest_buckets,
)
from keystone_tpu_torch.serving import autoscale
from keystone_tpu_torch.serving import engine as engine_mod
from keystone_tpu_torch.serving.featurize import (
    build_flagship_featurize_pipeline as torch_build,
)
from keystone_tpu_torch.utils.profiling import LatencyRecorder
from keystone_tpu_torch.workflow.executor import PipelineEnv as TEnv

TIMEOUT = 60
IMG, DESC, VOCAB, CLASSES = 48, 8, 8, 10
GEOMETRY = dict(sift_step=4, sift_bin=4, sift_scales=2, sift_scale_step=1,
                lcs_stride=4, lcs_border=16, lcs_patch=6)
FEAT_TOL = dict(rtol=1e-4, atol=1e-5)
D = 6  # the small linear-head model's input width


@pytest.fixture(autouse=True)
def clean_state():
    TEnv.get_or_create().reset()
    faults.disarm_all()
    yield
    faults.disarm_all()
    TEnv.get_or_create().reset()


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


# -- metrics and scrape ------------------------------------------------------


def feed(metrics, clock):
    """One record_* sequence: dispatches at two buckets, latencies,
    pipeline stages and windows, queue depth, coalesce sizes."""
    rng = np.random.default_rng(0)
    for i in range(40):
        clock.t += 0.25
        bucket = 8 if i % 3 else 64
        rows = int(rng.integers(1, bucket + 1))
        metrics.record_dispatch(bucket, rows, h2d_bytes=bucket * 196_608)
        metrics.record_dispatch_enqueue(float(rng.uniform(1e-4, 1e-3)))
        metrics.record_dispatch_complete(float(rng.uniform(1e-3, 2e-2)))
        metrics.record_request(float(rng.uniform(1e-3, 5e-2)))
        metrics.record_coalesce(rows)
        for stage in ("host_prep", "upload", "compute", "deliver"):
            metrics.record_stage(stage, float(rng.uniform(1e-4, 1e-2)))
            metrics.set_stage_queue_depth(stage, int(rng.integers(0, 3)))
        metrics.record_window()
    metrics.record_trace(8)
    metrics.record_trace(64)
    metrics.set_queue_depth(3)
    metrics.set_staging_bytes(12_582_912)
    metrics.set_device_peaks(67e12, 3.35e12)


def test_serving_metrics_summary_matches_jax():
    jc, tc = FakeClock(), FakeClock()
    jm, tm = JaxMetrics(clock=jc), ServingMetrics(clock=tc)
    feed(jm, jc)
    feed(tm, tc)
    want, got = jm.summary(), tm.summary()
    assert got == want
    assert got["compiles_per_bucket"] == {"8": 1, "64": 1}
    assert got["pipeline"]["bottleneck"] in ("host_prep", "upload", "compute", "deliver")
    assert tm.bottleneck() == jm.bottleneck()
    assert tm.overlap_efficiency() == jm.overlap_efficiency()
    # no cost model: the MFU and roofline series stay absent
    assert got["mfu"] is None and tm.roofline_bound(8) is None


def test_serving_metrics_scrape_samples_match_jax():
    """The same record_* sequence, registered under one engine label,
    renders the same sample lines in both packages (help texts differ:
    the port's compiles are graph captures)."""
    jc, tc = FakeClock(), FakeClock()
    jm, tm = JaxMetrics(clock=jc), ServingMetrics(clock=tc)
    feed(jm, jc)
    feed(tm, tc)
    jreg, treg = JaxRegistry(), MetricsRegistry()
    jm.register(jreg, engine="e")
    tm.register(treg, engine="e")

    def samples(text):
        return [ln for ln in text.splitlines() if not ln.startswith("#")]

    got = samples(prometheus.render(treg.collect()))
    assert got == samples(jax_prom.render(jreg.collect()))
    assert 'keystone_serving_compiles_total{engine="e",bucket="64"} 1' in got


def fill_registry(reg):
    c = reg.counter("req_total", "requests\nby \\ code", ("code", "path"))
    c.inc(("200", 'a"b'), 3)
    c.inc(("500", "x\ny"))
    g = reg.gauge("temp", "a gauge")
    g.set(1.5)
    reg.gauge_func("live", lambda: {("q",): 2.0, ("r",): None}, "fn gauge", ("k",))
    s = reg.summary("lat_seconds", "latency", ("stage",))
    for v in (0.1, 0.2, 0.3, 0.4):
        s.observe(v, ("prep",))
    h = reg.histogram("wait_seconds", "wait", ("lane",), buckets=(0.001, 0.5, 2))
    for v in (0.0001, 0.25, 1.0, 7.0):
        h.observe(v, ("0",))
    h.observe(0.3, ("1",), trace_id="abc")
    # exemplar timestamps are wall-clock: pin them for the comparison
    for cell in h._cells.values():
        for ex in cell[2].values():
            ex.timestamp_s = 1700000000.0


@pytest.mark.parametrize("openmetrics", [False, True], ids=["text", "openmetrics"])
def test_prometheus_render_matches_jax(openmetrics):
    jreg, treg = JaxRegistry(), MetricsRegistry()
    fill_registry(jreg)
    fill_registry(treg)
    got = prometheus.render(treg.collect(), openmetrics=openmetrics)
    assert got == jax_prom.render(jreg.collect(), openmetrics=openmetrics)
    assert got.endswith("# EOF\n") == openmetrics


def test_latency_recorder_matches_jax():
    vals = np.random.default_rng(1).uniform(0, 1, 300)
    j, t = JaxRecorder(window=128), LatencyRecorder(window=128)
    for v in vals:
        j.record(float(v))
        t.record(float(v))
    assert t.snapshot() == j.snapshot()
    for p in (0.0, 12.5, 50.0, 99.0, 100.0):
        assert t.percentile(p) == j.percentile(p)


def test_device_peaks(monkeypatch):
    assert device.peaks_for("NVIDIA H100 80GB HBM3") == (67e12, 3.35e12)
    for kind in ("cpu", "NVIDIA L40S", None):
        assert device.peaks_for(kind) == jax_device.peaks_for(kind) == (None, None)
    monkeypatch.setenv("KEYSTONE_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("KEYSTONE_PEAK_MEMBW_GBPS", "100")
    assert device.peaks_for("anything") == jax_device.peaks_for("anything") == (1e12, 1e11)
    monkeypatch.delenv("KEYSTONE_PEAK_FLOPS")
    monkeypatch.delenv("KEYSTONE_PEAK_MEMBW_GBPS")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(device, "_table", None)
    (row,) = device.device_table()
    assert row["platform"] == "cpu" and row["peak_flops"] is None
    assert device.peaks_of(torch.device("cpu")) == (None, None)


def test_fault_injector_count_match_and_counter():
    reg = MetricsRegistry()
    inj = faults.FaultInjector(registry=reg)
    assert inj.fire("engine.dispatch.error") is None
    inj.arm("engine.dispatch.error", count=2, match={"engine": "a"})
    assert inj.fire("engine.dispatch.error", {"engine": "b"}) is None
    assert inj.fire("engine.dispatch.error", {"engine": "a"}) is not None
    assert inj.fire("engine.dispatch.error", {"engine": "a"}) is not None
    assert inj.fire("engine.dispatch.error", {"engine": "a"}) is None  # spent
    assert not inj.armed and inj.fired_count("engine.dispatch.error") == 2
    assert inj.status()["armed"] == {} and inj.status()["fired_total"] == {"engine.dispatch.error": 2}
    fam = next(f for f in reg.collect() if f.name == "keystone_fault_injections_total")
    assert [s.value for s in fam.samples] == [2]
    with pytest.raises(ValueError):
        inj.arm("x", count=0)


def test_launch_counts_inside_a_capture_go_to_its_tally():
    _cuda.reset_launches()
    with _cuda.capture_tally() as tally:
        _cuda.count("plane_sandwich")
        _cuda.count("plane_sandwich")
    assert tally == {"plane_sandwich": 2} and _cuda.LAUNCHES["plane_sandwich"] == 0
    _cuda.add_launches(tally)
    _cuda.add_launches(tally)
    _cuda.count("fisher_vector_stats")
    assert _cuda.LAUNCHES == {"sift_bin_sample": 0, "plane_sandwich": 4, "fisher_vector_stats": 1}
    _cuda.reset_launches()


# -- buffer pool ----------------------------------------------------------------


def pool_trace(pool):
    """tests/serving/test_lane_pipeline.py's pool scenarios, recording
    what each step leaves behind."""
    out = []

    def alloc():
        return np.zeros(4)

    gen, a = pool.acquire("k", alloc)
    out.append((pool.allocations, pool.staging_bytes))
    pool.release("k", gen, a)
    gen2, b = pool.acquire("k", alloc)
    out.append((b is a, pool.allocations, pool.staging_bytes))
    extras = [pool.acquire("k", alloc)[1] for _ in range(3)]
    out.append((pool.allocations, pool.staging_bytes))
    for buf in [b] + extras:
        pool.release("k", gen2, buf)
    out.append((len(pool._free["k"]), pool.staging_bytes))
    gen3, c = pool.acquire("k", alloc)
    pool.reset()
    pool.release("k", gen3, c)
    out.append((pool.generation, len(pool._free.get("k", [])), pool.staging_bytes))
    gen4, d = pool.acquire("k", alloc)
    out.append((gen4, d is c, pool.staging_bytes))
    pool.release("k", gen4, None)
    out.append((len(pool._free.get("k", [])), pool.allocations))
    return out


def test_host_buffer_pool_matches_jax():
    got = pool_trace(HostBufferPool(max_per_key=2))
    assert got == pool_trace(JaxPool(max_per_key=2))
    assert got[1][0] and got[3][0] == 2 and got[4][:2] == (1, 0)


def test_serial_apply_reuses_its_staging_buffer():
    model = small_model()
    eng = CompiledPipeline(model, (4, 8), device="cpu")
    for n in (3, 2, 4, 1):
        eng.apply(xs(n, seed=n))
    # one plain (CPU) buffer for bucket 4, reused
    assert eng._staging.allocations == 1
    free = eng._staging._free[eng.host_key(xs(1), 4)]
    assert not free[0].is_pinned() and tuple(free[0].shape) == (4, D)
    assert eng.metrics.h2d_bytes.get(4) == 4 * 4 * D * 4


def test_a_capture_holds_off_replays_and_runs_once_per_bucket():
    """A bucket's capture runs under ``_fn_lock`` and ``_replay_lock``:
    a capture records whatever is enqueued on the compute stream, which
    replays share, so no replay may start beside it; callers racing to
    one bucket's first dispatch capture it once."""
    eng = CompiledPipeline(small_model(), (4,), device="cpu")
    calls = []

    def capture(bucket, staged):
        calls.append((bucket, eng._fn_lock.locked(), eng._replay_lock.locked()))
        time.sleep(0.05)
        return ("graph", bucket)

    eng._capture = capture
    staged = torch.zeros(4, D)
    got = []
    threads = [threading.Thread(target=lambda: got.append(eng._graph(4, staged)))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    assert calls == [(4, True, True)]
    assert got == [("graph", 4)] * 4
    assert not eng._fn_lock.locked() and not eng._replay_lock.locked()


def test_a_graphs_pool_bytes_are_its_own_segments(monkeypatch):
    """``pool_bytes`` sums the allocator's segments tagged with the
    graph's pool id on the engine's device: segments of other pools, of
    the default pool and of other devices do not count, so what other
    threads free or allocate around a capture cannot move it."""
    segments = [
        {"device": 0, "segment_pool_id": (0, 3), "total_size": 2 << 20},
        {"device": 0, "segment_pool_id": [0, 3], "total_size": 20 << 20},
        {"device": 0, "segment_pool_id": (0, 0), "total_size": 4 << 30},
        {"device": 0, "segment_pool_id": (0, 4), "total_size": 8 << 20},
        {"device": 1, "segment_pool_id": (0, 3), "total_size": 64 << 20},
    ]
    monkeypatch.setattr(torch.cuda, "memory_snapshot", lambda: segments)

    class Graph:
        def pool(self):
            return (0, 3)

    assert engine_mod._pool_bytes(Graph(), torch.device("cuda", 0)) == 22 << 20
    assert engine_mod._pool_bytes(Graph(), torch.device("cuda", 1)) == 64 << 20


# -- the flagship chain behind both batchers ----------------------------------


def jax_head(feat_dim):
    rng = np.random.default_rng(3)
    W = rng.standard_normal((feat_dim, CLASSES)).astype(np.float32)
    b = rng.standard_normal(CLASSES).astype(np.float32)
    model = BlockLinearMapper(
        jnp.asarray(W), feat_dim, explicit_intercept=jnp.asarray(b)
    ).and_then(TopKClassifier(5)).fit()
    return (W, b), model


def serve(make_batcher, raw):
    mb = make_batcher()
    try:
        futures = [mb.submit(x) for x in raw]
        return [np.asarray(f.result(timeout=TIMEOUT)) for f in futures]
    finally:
        mb.close()


@pytest.fixture(scope="module")
def flagship_rows():
    """8 requests (two full windows of bucket 4) through the JAX
    batcher: features and top-5."""
    jfeat, feat_dim = jax_build(img=IMG, desc_dim=DESC, vocab=VOCAB, **GEOMETRY)
    (W, b), jmodel = jax_head(feat_dim)
    raw = np.random.default_rng(5).integers(0, 256, (8, IMG, IMG, 3), dtype=np.uint8)
    rows = {}
    for what, eng in (
        ("feat", jfeat.compiled(buckets=(4,), aot_store=False)),
        ("top5", jmodel.compiled(buckets=(4,), featurize=jfeat, aot_store=False)),
    ):
        eng.warmup(example=jnp.zeros((IMG, IMG, 3), jnp.uint8))
        rows[what] = serve(lambda: JaxBatcher(eng, max_delay_ms=5_000.0), raw)
    return (W, b), raw, rows


@pytest.mark.parametrize("depth", [0, 2], ids=["serial", "pipelined"])
def test_flagship_batcher_matches_jax(flagship_rows, depth):
    (W, b), raw, want = flagship_rows
    feat, _ = torch_build(img=IMG, desc_dim=DESC, vocab=VOCAB, device="cpu", **GEOMETRY)
    model = convert.model_head(W, b, 5, "cpu")
    got = {}
    for what, eng in (
        ("feat", feat.compiled((4,), device="cpu")),
        ("top5", model.compiled((4,), featurize=feat, device="cpu")),
    ):
        assert eng.warmup(example=np.zeros((IMG, IMG, 3), np.uint8)).keys() == {4}
        got[what] = serve(
            lambda: MicroBatcher(eng, max_delay_ms=5_000.0, pipeline_depth=depth), raw
        )
        assert eng.metrics.dispatches.snapshot() == {4: 2}
        assert eng.metrics.compile_count == 0  # no graphs on the CPU
    np.testing.assert_allclose(np.stack(got["feat"]), np.stack(want["feat"]), **FEAT_TOL)
    np.testing.assert_array_equal(np.stack(got["top5"]), np.stack(want["top5"]))
    assert all(isinstance(r, np.ndarray) for r in got["top5"])


def test_flagship_pipelined_equals_serial_bitwise():
    feat, feat_dim = torch_build(img=IMG, desc_dim=DESC, vocab=VOCAB, device="cpu", **GEOMETRY)
    raw = np.random.default_rng(9).integers(0, 256, (12, IMG, IMG, 3), dtype=np.uint8)
    eng = feat.compiled((4,), device="cpu")
    serial = serve(lambda: MicroBatcher(eng, max_delay_ms=5_000.0), raw)
    piped = serve(lambda: MicroBatcher(eng, max_delay_ms=5_000.0, pipeline_depth=2), raw)
    assert np.array_equal(np.stack(serial), np.stack(piped))
    direct = eng.apply(raw[:4]).numpy()
    assert np.array_equal(np.stack(serial[:4]), direct)
    assert serial[0].shape == (feat_dim,)
    rep = eng.metrics.pipeline_report()
    assert rep["windows"] == 3 and set(rep["stages"]) == {"host_prep", "upload", "compute", "deliver"}
    # whole uint8 staging buffers of bucket 4, at most depth + 1 of them
    one = 4 * IMG * IMG * 3
    assert eng.metrics.staging_bytes % one == 0 and 0 < eng.metrics.staging_bytes <= 3 * one


# -- mechanics on a small linear-head model ---------------------------------


def small_model():
    rng = np.random.default_rng(0)
    W = rng.standard_normal((D, 4)).astype(np.float32)
    return convert.model_head(W, np.zeros(4, np.float32), 2, "cpu")


def xs(n, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(dtype)


def expected(model, x):
    return model._batch_run(torch.as_tensor(np.asarray(x, np.float32))).numpy()


@pytest.fixture(scope="module")
def model():
    return small_model()


DEPTHS = pytest.mark.parametrize("depth", [0, 2], ids=["serial", "pipelined"])


@DEPTHS
def test_deadline_flushes_a_lone_request(model, depth):
    eng = CompiledPipeline(model, (4,), device="cpu")
    mb = MicroBatcher(eng, max_delay_ms=10.0, pipeline_depth=depth)
    try:
        t0 = time.perf_counter()
        out = mb.submit(xs(1)[0]).result(timeout=TIMEOUT)
        assert time.perf_counter() - t0 < 20.0
    finally:
        mb.close()
    np.testing.assert_array_equal(out, expected(model, xs(1))[0])
    assert eng.metrics.request_sizes.snapshot() == {1: 1}


@DEPTHS
def test_full_bucket_dispatches_before_deadline(model, depth):
    eng = CompiledPipeline(model, (4,), device="cpu")
    x = xs(4, seed=3)
    mb = MicroBatcher(eng, max_delay_ms=10_000.0, max_batch=4, pipeline_depth=depth)
    try:
        t0 = time.perf_counter()
        rows = [f.result(timeout=TIMEOUT) for f in [mb.submit(r) for r in x]]
        assert time.perf_counter() - t0 < 5.0  # not the 10 s deadline
    finally:
        mb.close()
    np.testing.assert_array_equal(np.stack(rows), expected(model, x))
    assert eng.metrics.max_coalesced == 4


@DEPTHS
def test_mixed_shape_streams_coalesce_separately(model, depth):
    """Interleaved float32 and float64 streams each coalesce into their
    own windows (a mixed window would stack to float64 and fail the
    float32 head)."""
    eng = CompiledPipeline(model, (4, 16), device="cpu")
    n = 8
    x32, x64 = xs(n, seed=11), xs(n, seed=12, dtype=np.float64)
    mb = MicroBatcher(eng, max_delay_ms=100.0, pipeline_depth=depth)
    try:
        futs = [(mb.submit(x32[i]), mb.submit(x64[i])) for i in range(n)]
        rows32 = [a.result(timeout=TIMEOUT) for a, _ in futs]
        rows64 = [b.result(timeout=TIMEOUT) for _, b in futs]
    finally:
        mb.close()
    np.testing.assert_array_equal(np.stack(rows32), expected(model, x32))
    np.testing.assert_array_equal(np.stack(rows64), expected(model, x64))
    assert eng.metrics.max_coalesced >= 2
    assert eng.metrics.request_latency.count == 2 * n


@DEPTHS
def test_swap_engine_mid_stream(model, depth):
    old = CompiledPipeline(model, (4,), device="cpu", name="swap-old")
    new = CompiledPipeline(model, (2, 8), device="cpu", name="swap-new")
    x = xs(8, seed=21)
    mb = MicroBatcher(old, max_delay_ms=5.0, pipeline_depth=depth)
    try:
        first = [mb.submit(r) for r in x[:4]]
        for f in first:
            f.result(timeout=TIMEOUT)
        assert mb.swap_engine(new) is old
        assert mb.max_batch == new.max_bucket
        second = [mb.submit(r) for r in x[4:]]
        rows = [f.result(timeout=TIMEOUT) for f in first + second]
    finally:
        mb.close()
    np.testing.assert_array_equal(np.stack(rows), expected(model, x))
    assert new.metrics.examples.total == 4 and old.metrics.examples.total == 4


@DEPTHS
def test_dispatch_error_propagates_to_futures(model, depth):
    """An armed ``engine.dispatch.error`` fails its whole window's
    futures; the next window succeeds."""
    eng = CompiledPipeline(model, (4,), device="cpu", name="chaos")
    mb = MicroBatcher(eng, max_delay_ms=5.0, pipeline_depth=depth)
    try:
        faults.arm("engine.dispatch.error", count=1, match={"engine": "chaos"})
        bad = mb.submit(xs(1)[0])
        with pytest.raises(faults.FaultInjected):
            bad.result(timeout=TIMEOUT)
        good = mb.submit(xs(1, seed=2)[0])
        np.testing.assert_array_equal(good.result(timeout=TIMEOUT), expected(model, xs(1, seed=2))[0])
    finally:
        mb.close()
    assert faults.get_injector().fired_count("engine.dispatch.error") >= 1
    assert eng.metrics.dispatches.total == 1


def test_host_prep_stall_delays_but_serves(model):
    eng = CompiledPipeline(model, (4,), device="cpu", name="stall")
    mb = MicroBatcher(eng, max_delay_ms=1.0, pipeline_depth=2)
    try:
        faults.arm("pipeline.host_prep.stall", count=1, delay_ms=200.0)
        t0 = time.perf_counter()
        out = mb.submit(xs(1)[0]).result(timeout=TIMEOUT)
        assert time.perf_counter() - t0 >= 0.2
    finally:
        mb.close()
    np.testing.assert_array_equal(out, expected(model, xs(1))[0])
    assert eng.metrics.stage_seconds["host_prep"].total >= 0.2


@DEPTHS
def test_close_drains_then_rejects(model, depth):
    eng = CompiledPipeline(model, (4,), device="cpu")
    mb = MicroBatcher(eng, max_delay_ms=5_000.0, pipeline_depth=depth)
    fut = mb.submit(xs(1, seed=9)[0])
    mb.close()
    np.testing.assert_array_equal(fut.result(timeout=5), expected(model, xs(1, seed=9))[0])
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(xs(1)[0])


@DEPTHS
def test_host_featurize_turns_raw_items_into_windows(model, depth):
    """Items mode: clients submit strings; the hook turns each window of
    them into the head's float32 input on the host-prep path."""
    table = {w: xs(1, seed=i)[0] for i, w in enumerate(("ab", "cd", "ef", "gh", "ij"))}
    seen = []

    def featurize(items):
        seen.append(len(items))
        return np.stack([table[w] for w in items])

    eng = CompiledPipeline(model, (4,), device="cpu")
    words = ["ab", "cd", "ef", "gh", "ij", "ab"]
    mb = MicroBatcher(eng, max_delay_ms=50.0, pipeline_depth=depth, host_featurize=featurize)
    try:
        rows = [f.result(timeout=TIMEOUT) for f in [mb.submit(w) for w in words]]
    finally:
        mb.close()
    want = expected(model, np.stack([table[w] for w in words]))
    np.testing.assert_array_equal(np.stack(rows), want)
    assert sum(seen) == len(words) and max(seen) <= 4


def test_max_batch_validation(model):
    with pytest.raises(ValueError, match="largest"):
        MicroBatcher(CompiledPipeline(model, (4,), device="cpu"), max_batch=8)


def test_concurrent_submits_and_staging_ledger(model):
    """Four client threads, a pipelined lane: every future gets its own
    row, windows coalesce, and the pool's byte ledger equals its pooled
    plain buffers once the lane is idle."""
    eng = CompiledPipeline(model, (4, 16), device="cpu")
    n = 32
    x = xs(n, seed=7)
    futures = [None] * n
    mb = MicroBatcher(eng, max_delay_ms=50.0, pipeline_depth=2)
    try:
        barrier = threading.Barrier(4)

        def client(tid):
            barrier.wait(timeout=TIMEOUT)
            for i in range(tid, n, 4):
                futures[i] = mb.submit(x[i])

        threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
            assert not t.is_alive()
        rows = [f.result(timeout=TIMEOUT) for f in futures]
        pool = mb._pipeline.pool
        pooled = sum(int(b.nbytes) for bufs in pool._free.values() for b in bufs)
        assert pool.staging_bytes == pooled == eng.metrics.staging_bytes > 0
    finally:
        mb.close()
    np.testing.assert_array_equal(np.stack(rows), expected(model, x))
    assert eng.metrics.max_coalesced >= 2
    assert eng.metrics.request_latency.count == n


def test_oversized_request_chunks_through_the_largest_bucket(model):
    eng = CompiledPipeline(model, (2, 4), device="cpu")
    x = xs(9, seed=4)
    np.testing.assert_array_equal(eng.apply(x, sync=True).numpy(), expected(model, x))
    assert eng.metrics.dispatches.snapshot() == {4: 2, 2: 1}
    assert eng.metrics.dispatch_latency.count == 1


HISTS = [
    {1: 50, 2: 30, 3: 10, 7: 5, 8: 5, 30: 2, 64: 1},
    {5: 3, 6: 3, 40: 1, 100: 2, 200: 1},
    {1: 1},
]


@pytest.mark.parametrize("hist", HISTS)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_autoscale_matches_jax(hist, k):
    assert suggest_buckets(hist, k) == jax_autoscale.suggest_buckets(hist, k)
    assert suggest_buckets(hist, k, max_bucket=64) == jax_autoscale.suggest_buckets(
        hist, k, max_bucket=64)
    for buckets in ((8, 64), (4, 16, 64), suggest_buckets(hist, k)):
        assert padding_waste(hist, buckets) == jax_autoscale.padding_waste(hist, buckets)
        assert autoscale.predicted_efficiency(hist, buckets) == \
            jax_autoscale.predicted_efficiency(hist, buckets)


def test_autoscale_reads_live_metrics(model):
    eng = CompiledPipeline(model, (8,), device="cpu")
    for n in (1, 1, 2, 7, 7, 7):
        eng.apply(xs(n))
    assert eng.metrics.request_sizes.snapshot() == {1: 2, 2: 1, 7: 3}
    assert suggest_buckets(eng.metrics, 2) == (2, 7)
    assert autoscale.predicted_efficiency(eng.metrics, (8,)) == 25 / 48
    assert eng.metrics.padding_efficiency() == 25 / 48
