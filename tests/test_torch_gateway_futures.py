"""What ``Gateway.predict`` returns, on the CPU, held against the JAX
package's ``Gateway``: the same scripted requests through both gateways
(the demo model, its weights carried across by ``convert``; each lane's
host prep held shut by a gate until the script opens it) give the same
futures, observation for observation: a ``concurrent.futures.Future``,
``result`` and ``exception`` timing out while pending, a wait that
times out, cancellation while queued in admission and after routing to a
lane, callbacks before and after completion, ``trace_id``,
``lane_index`` and ``latency_s`` on the future, a typed shed, a lane
failure retried on the other lane, and a request every lane fails; the
answers agree within the JAX gateway tests' tolerance. Routing, in both
packages: every request goes from admission to a lane on the admission's
router thread. On the port alone: one request is routed at a time under
concurrent admits, and a request waiting in its lane holds no more
gc-tracked objects than it did when this test was written (38.1, pinned
below one more stdlib future's eleven). Every
wait has a timeout of a few seconds."""

import concurrent.futures
import gc
import sys
import threading
import time
from concurrent.futures import Future

import jax.numpy as jnp
import numpy as np
import pytest

from keystone_tpu.gateway import Gateway as JGateway
from keystone_tpu.gateway.admission import Overloaded as JOverloaded
from keystone_tpu.loadgen import faults as jfaults
from keystone_tpu.serving import bench as jbench
from keystone_tpu_torch import convert
from keystone_tpu_torch.gateway import Gateway
from keystone_tpu_torch.gateway import admission as tadmission
from keystone_tpu_torch.gateway.admission import Overloaded
from keystone_tpu_torch.loadgen import faults
from keystone_tpu_torch.serving import bench as tbench

D = 8
TIMEOUT = 10
# the JAX gateway tests' tolerance (tests/gateway/test_pool.py)
RTOL, ATOL = 1e-5, 1e-6
TRACE = "0af7651916cd43dd8448eb211c80319c"
# gc-tracked objects a routed request holds while it waits in its lane:
# the caller's and the pool's stdlib futures (eleven each: a condition
# with its lock, waiter deque and bound methods), the lane's LaneFuture,
# the admission record, the callbacks that link them with their closures
# and lists, the batcher's entry: 38.1 alone, 39.1 once in a six-worker
# run of tests/ (objects other threads of the worker made meanwhile);
# one more stdlib future in the chain would add eleven
TRACKED_PER_REQUEST = 42
PACKAGES = {
    "jax": (JGateway, JOverloaded, jfaults),
    "torch": (Gateway, Overloaded, faults),
}


@pytest.fixture(scope="module")
def models():
    jfitted = jbench.build_pipeline(d=D, hidden=8, depth=2)
    tfitted = tbench.affine_chain(convert.affine_params(jfitted), device="cpu")
    return {"jax": jfitted, "torch": tfitted}


@pytest.fixture(autouse=True)
def no_faults():
    for mod in (faults, jfaults):
        mod.disarm_all()
    yield
    for mod in (faults, jfaults):
        mod.disarm_all()


def _inputs(n, width=D, seed=21):
    return list(np.random.default_rng(seed).standard_normal((n, width)).astype(np.float32))


def _until(cond, what):
    deadline = time.monotonic() + TIMEOUT
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.002)


def _gateway(pkg, models, name, gate=None, **kw):
    """A two-lane gateway over the demo model; with ``gate``, each lane's
    host prep waits until the gate opens."""
    gateway_cls = PACKAGES[pkg][0]
    if gate is not None:
        def hook(raw):
            gate.wait(TIMEOUT)
            return np.stack([np.asarray(r, np.float32) for r in raw])

        kw["host_featurize"] = hook
    if pkg == "jax":
        return gateway_cls(models["jax"], buckets=(4,), n_lanes=2, max_delay_ms=1.0,
                           warmup_example=jnp.zeros((D,), jnp.float32), name=f"{name}-jax", **kw)
    return gateway_cls(models["torch"], buckets=(4,), n_lanes=2, max_delay_ms=1.0, device="cpu",
                       warmup_example=np.zeros((D,), np.float32), name=f"{name}-torch", **kw)


def _future_script(pkg, models):
    """Two requests held in the lanes (one each, capacity 1), two queued
    in admission (max_pending 2), a fifth shed; then the waits, the
    cancels and the callbacks, the gate opened, and what every future
    shows. Returns (observations, answers)."""
    _, overloaded, _ = PACKAGES[pkg]
    gate = threading.Event()
    gw = _gateway(pkg, models, "futures", gate=gate, lane_capacity=1, max_pending=2)
    xs = _inputs(5)
    obs, called, late = {}, [], []
    try:
        f0 = gw.predict(xs[0], trace_id=TRACE)
        f1 = gw.predict(xs[1])
        _until(lambda: gw.admission.queue_depth == 0 and gw.pool.total_load() == 2, "two routed")
        f2, f3 = gw.predict(xs[2]), gw.predict(xs[3])
        with pytest.raises(overloaded) as shed:
            gw.predict(xs[4])
        obs["shed"] = (type(shed.value).__name__, shed.value.reason, shed.value.queue_depth)
        futures = (f0, f1, f2, f3)
        obs["is_future"] = [isinstance(f, Future) for f in futures]
        for wait in (f0.result, f0.exception):
            with pytest.raises(concurrent.futures.TimeoutError):
                wait(timeout=0.05)
        obs["pending_wait"] = len(concurrent.futures.wait([f0], timeout=0.05).not_done)
        f0.add_done_callback(called.append)
        obs["cancel_queued"] = f2.cancel()
        obs["cancel_routed"] = f1.cancel()
        obs["cancelled"] = [f.cancelled() for f in futures]
        gate.set()
        answers = np.stack([f0.result(timeout=TIMEOUT), f3.result(timeout=TIMEOUT)])
        # as for stdlib futures, the two cancelled ones are not done for
        # wait() (no executor notified them): a short timeout shows it
        done = concurrent.futures.wait(futures, timeout=0.05)
        obs["done_after"] = (len(done.done), len(done.not_done))
        for f in (f1, f2):
            with pytest.raises(concurrent.futures.CancelledError):
                f.result(timeout=0)
        obs["exceptions"] = [f0.exception(timeout=0), f3.exception(timeout=0)]
        obs["callback"] = [c is f0 for c in called]
        f3.add_done_callback(late.append)
        obs["late_callback"] = [c is f3 for c in late]
        obs["trace_id"] = f0.trace_id
        obs["lane_index"] = [f.lane_index in (0, 1) for f in (f0, f3)]
        obs["latency_s"] = [isinstance(f.latency_s, float) and f.latency_s > 0 for f in (f0, f3)]
        # the request cancelled after routing was still served (its outcome
        # counts); the one cancelled while queued never reached a lane
        _until(lambda: gw.metrics.outcome_count("ok") >= 3, "three served")
        obs["outcomes"] = {s: gw.metrics.outcome_count(s) for s in ("ok", "error", "shed")}
        obs["sheds"] = gw.metrics.shed_count("queue_full")
    finally:
        gate.set()
        gw.close(timeout=TIMEOUT)
    return obs, answers


def test_the_futures_predict_returns_behave_as_jax(models):
    want, want_rows = _future_script("jax", models)
    got, got_rows = _future_script("torch", models)
    assert got == want
    assert got["shed"] == ("Overloaded", "queue_full", 2)
    assert got["cancelled"] == [False, True, True, False]
    assert got["callback"] == [True] and got["late_callback"] == [True]
    assert got["done_after"] == (2, 2)
    assert got["outcomes"] == {"ok": 3.0, "error": 0.0, "shed": 1.0}
    np.testing.assert_allclose(got_rows, want_rows, rtol=RTOL, atol=ATOL)


def _failure_script(pkg, models):
    """One request whose first lane is killed at submit (retried on the
    other), then one every lane fails (a row of the wrong width)."""
    _, _, faults_mod = PACKAGES[pkg]
    gw = _gateway(pkg, models, "failures")
    x = _inputs(1)[0]
    try:
        faults_mod.arm("gateway.lane.kill", match={"lane": 0}, count=1)
        f = gw.predict(x)
        row = f.result(timeout=TIMEOUT)
        bad = gw.predict(np.ones((D + 1,), np.float32))
        err = bad.exception(timeout=TIMEOUT)
        with pytest.raises(Exception):
            bad.result(timeout=0)
        obs = {
            "retried_lane": f.lane_index,
            "error_raised": isinstance(err, Exception),
            "retries": gw.metrics.retry_count(),
            "outcomes": {s: gw.metrics.outcome_count(s) for s in ("ok", "error")},
            "done": [f.done(), bad.done()],
        }
    finally:
        gw.close(timeout=TIMEOUT)
    return obs, row


def test_a_lane_failure_is_retried_and_a_bad_request_fails_as_jax(models):
    want, want_row = _failure_script("jax", models)
    got, got_row = _failure_script("torch", models)
    assert got == want
    assert got["retried_lane"] == 1 and got["error_raised"] and got["retries"] == 2.0
    np.testing.assert_allclose(got_row, want_row, rtol=RTOL, atol=ATOL)


def _routing_threads(pkg, models):
    """The names of the threads that hand three sequential requests from
    admission to the pool."""
    gw = _gateway(pkg, models, "route")
    seen = []
    submit = gw.pool.submit

    def recording(example, parent_span_id=None):
        seen.append(threading.current_thread().name)
        return submit(example, parent_span_id=parent_span_id)

    gw.pool.submit = recording
    try:
        for x in _inputs(3):
            gw.predict(x).result(timeout=TIMEOUT)
        waits = gw.metrics.queue_wait.get_count((gw.name,))
    finally:
        gw.close(timeout=TIMEOUT)
    return seen, waits


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_every_request_is_routed_on_the_admission_router_thread(pkg, models):
    seen, waits = _routing_threads(pkg, models)
    assert seen == [f"keystone-route-{pkg}-router"] * 3
    assert waits == 3


class _CountingPool:
    """A pool of ``capacity`` slots that counts the requests it holds
    and the most it ever held; requests resolve after a short while."""

    def __init__(self, capacity):
        self.capacity = capacity
        self.held = 0
        self.most = 0
        self.submitted = 0
        self._lock = threading.Lock()
        self._listeners = []

    def add_free_listener(self, fn):
        self._listeners.append(fn)

    def free_capacity(self):
        with self._lock:
            return self.capacity - self.held

    def total_load(self):
        with self._lock:
            return self.held

    def submit(self, example, parent_span_id=None):
        with self._lock:
            self.held += 1
            self.most = max(self.most, self.held)
            self.submitted += 1
        fut = Future()
        threading.Timer(0.001, self._done, (fut,)).start()
        return fut

    def _done(self, fut):
        with self._lock:
            self.held -= 1
        fut.set_result(0)
        for fn in self._listeners:
            fn()


def test_concurrent_admits_never_overfill_the_pool():
    pool = _CountingPool(capacity=2)
    adm = tadmission.AdmissionController(pool, max_pending=10_000, name="stress")
    futures, lock = [], threading.Lock()

    def client():
        for _ in range(50):
            f = adm.submit(0)
            with lock:
                futures.append(f)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        for f in futures:
            f.result(timeout=TIMEOUT)
    finally:
        sys.setswitchinterval(old)
        adm.close(timeout=TIMEOUT)
    assert pool.submitted == 800 and pool.most <= 2


def test_a_request_in_flight_holds_few_tracked_objects(models):
    gate = threading.Event()
    n = 256
    gw = _gateway("torch", models, "tracked", gate=gate, lane_capacity=n)
    xs = _inputs(n)
    futures = []
    try:
        gc.collect()
        gc.disable()
        before = len(gc.get_objects())
        futures = [gw.predict(x) for x in xs]
        _until(lambda: gw.admission.queue_depth == 0 and gw.pool.total_load() == n, "all routed")
        # the lanes' coalesce threads may still be forming windows: read
        # the count once it holds still
        counts = [len(gc.get_objects())]
        while len(counts) < 50 and (len(counts) < 3 or len(set(counts[-3:])) > 1):
            time.sleep(0.02)
            counts.append(len(gc.get_objects()))
        per_request = (counts[-1] - before) / n
    finally:
        gc.enable()
        gate.set()
        for f in futures:
            f.result(timeout=TIMEOUT)
        gw.close(timeout=TIMEOUT)
    assert per_request <= TRACKED_PER_REQUEST, per_request
