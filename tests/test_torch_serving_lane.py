"""The port's pipelined lane against its serial lane and the JAX package's
batcher on the demo chain, the lane's backpressure, and the request
futures a lane hands out (``serving/pipeline.LaneFuture``): the
``concurrent.futures.Future`` contract, one object for the garbage
collector to track, a window resolved in one pass. Small shapes on the
CPU; every wait has a timeout and every batcher is closed."""

import concurrent.futures
import gc
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.serving import bench as jbench
from keystone_tpu.serving.batching import MicroBatcher as JaxBatcher
from keystone_tpu.serving.pipeline import LanePipeline as JaxLane
from keystone_tpu_torch import convert
from keystone_tpu_torch.serving import CompiledPipeline, MicroBatcher, ServingMetrics
from keystone_tpu_torch.serving import bench as tbench
from keystone_tpu_torch.serving import pipeline
from keystone_tpu_torch.serving.pipeline import LaneFuture, resolve_window_futures

TIMEOUT = 60
D, N = 16, 22  # the demo chain's width; requests: five full windows of 4 and a ragged 2


def serve(make, rows):
    with make() as mb:
        futures = [mb.submit(r) for r in rows]
        return np.stack([np.asarray(f.result(timeout=TIMEOUT)) for f in futures])


@pytest.fixture(scope="module")
def demo():
    """The demo chain in both packages from the same weights, and the
    seeded requests."""
    jfitted = jbench.build_pipeline(d=D, hidden=8, depth=2)
    tfitted = tbench.affine_chain(convert.affine_params(jfitted), device="cpu")
    rows = np.random.default_rng(3).standard_normal((N, D)).astype(np.float32)
    return jfitted, tfitted, rows


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipelined_lane_matches_serial_and_jax(demo, depth):
    jfitted, tfitted, rows = demo
    jeng = jfitted.compiled(buckets=(2, 4), aot_store=False)
    jeng.warmup(example=jnp.zeros((D,), jnp.float32))
    want = serve(lambda: JaxBatcher(jeng, max_delay_ms=50.0, pipeline_depth=depth), rows)
    serial_eng = CompiledPipeline(tfitted, (2, 4), device="cpu")
    serial = serve(lambda: MicroBatcher(serial_eng, max_delay_ms=50.0), rows)
    eng = CompiledPipeline(tfitted, (2, 4), device="cpu")
    piped = serve(lambda: MicroBatcher(eng, max_delay_ms=50.0, pipeline_depth=depth), rows)
    assert np.array_equal(piped, serial)
    np.testing.assert_allclose(piped, want, rtol=0, atol=1e-5)
    stages = set(JaxLane.STAGES)
    assert tuple(pipeline.LanePipeline.STAGES) == JaxLane.STAGES
    assert set(eng.metrics.stage_rates()) == stages == set(jeng.metrics.stage_rates())
    assert set(eng.metrics.pipeline_report()["stages"]) == stages
    assert set(jeng.metrics.pipeline_report()["stages"]) == stages


def test_submit_window_blocks_while_host_prep_is_full(demo, monkeypatch):
    _, tfitted, rows = demo
    entered, returned = [], []
    submit_window = pipeline.LanePipeline.submit_window

    def spy(self, *a, **k):
        entered.append(1)
        submit_window(self, *a, **k)
        returned.append(1)

    monkeypatch.setattr(pipeline.LanePipeline, "submit_window", spy)
    gate = threading.Event()

    def featurize(raw):
        gate.wait(TIMEOUT)  # the prep stage holds its first window
        return np.stack(raw)

    eng = CompiledPipeline(tfitted, (1,), device="cpu")
    mb = MicroBatcher(eng, max_delay_ms=1.0, max_batch=1, pipeline_depth=1,
                      host_featurize=featurize)
    try:
        futures = [mb.submit(r) for r in rows[:4]]
        deadline = time.monotonic() + TIMEOUT
        while len(entered) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        # window 1 is in the prep stage, window 2 fills its queue of one,
        # and the coalesce thread waits inside the third hand-off
        time.sleep(0.2)
        assert (len(entered), len(returned)) == (3, 2)
        assert mb._pipeline._queues["host_prep"].full()
        assert not any(f.done() for f in futures)
        gate.set()
        got = np.stack([f.result(timeout=TIMEOUT) for f in futures])
    finally:
        gate.set()
        mb.close()
    assert len(returned) == 4
    want = serve(lambda: MicroBatcher(CompiledPipeline(tfitted, (1,), device="cpu")), rows[:4])
    assert np.array_equal(got, want)


# -- the lane's request futures ----------------------------------------------


def _tracked_per_future(make, n=2000):
    gc.collect()
    gc.disable()
    try:
        before = len(gc.get_objects())
        futures = [make() for _ in range(n)]
        return (len(gc.get_objects()) - before) / len(futures)
    finally:
        gc.enable()


def test_a_lane_future_is_one_tracked_object():
    cond = threading.Condition()
    assert _tracked_per_future(lambda: LaneFuture(cond)) <= 1.01
    assert _tracked_per_future(concurrent.futures.Future) >= 5


def _window(n, cond=None):
    cond = cond or threading.Condition()
    futures = [LaneFuture(cond) for _ in range(n)]
    valid = torch.arange(n * 3, dtype=torch.float32).reshape(n, 3)
    return futures, valid


def test_a_window_resolves_its_futures_in_one_pass():
    futures, valid = _window(4)
    futures[1].cancel()
    seen = []
    futures[2].add_done_callback(lambda f: seen.append(f.result()))
    waited = concurrent.futures.wait(futures[:1], timeout=0)
    assert not waited.done
    metrics = ServingMetrics()
    resolve_window_futures(metrics, valid, futures, [time.perf_counter()] * 4)
    assert [f.done() for f in futures] == [True] * 4
    assert futures[1].cancelled()
    for i in (0, 2, 3):
        np.testing.assert_array_equal(futures[i].result(timeout=0), valid[i].numpy())
    np.testing.assert_array_equal(seen[0], valid[2].numpy())
    late = []
    futures[3].add_done_callback(lambda f: late.append(f.exception()))
    assert late == [None]
    # as for a stdlib future, a cancelled one counts as done for wait()
    # only once notified by an executor
    settled = [futures[i] for i in (0, 2, 3)]
    assert concurrent.futures.wait(settled, timeout=TIMEOUT).not_done == set()
    assert metrics.request_latency.count == 3  # not the cancelled one


def test_a_lane_future_waits_for_its_own_window():
    cond = threading.Condition()
    first, valid = _window(2, cond)
    second, _ = _window(2, cond)
    box = {}

    def wait_second():
        try:
            box["got"] = second[0].result(timeout=TIMEOUT)
        except BaseException as e:  # noqa: BLE001
            box["err"] = e

    waiter = threading.Thread(target=wait_second)
    waiter.start()
    time.sleep(0.05)
    # the first window's wake-up reaches the waiter of the second
    resolve_window_futures(ServingMetrics(), valid, first, [0.0, 0.0])
    time.sleep(0.05)
    assert waiter.is_alive() and not box
    resolve_window_futures(ServingMetrics(), valid + 10, second, [0.0, 0.0])
    waiter.join(TIMEOUT)
    np.testing.assert_array_equal(box["got"], (valid + 10)[0].numpy())
    with pytest.raises(concurrent.futures.TimeoutError):
        LaneFuture(cond).result(timeout=0.01)
    failed = LaneFuture(cond)
    failed.set_exception(ValueError("boom"))
    assert isinstance(failed.exception(timeout=0), ValueError)
    with pytest.raises(ValueError, match="boom"):
        failed.result(timeout=0)


def test_batcher_futures_are_lane_futures(demo):
    _, tfitted, rows = demo
    eng = CompiledPipeline(tfitted, (4,), device="cpu")
    with MicroBatcher(eng, max_delay_ms=1.0, pipeline_depth=2) as mb:
        fut = mb.submit(rows[0])
        assert isinstance(fut, LaneFuture) and isinstance(fut, concurrent.futures.Future)
        fut.result(timeout=TIMEOUT)
