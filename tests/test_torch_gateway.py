"""The request plane of ``keystone_tpu_torch`` on the CPU, held against the
JAX package's: the admission controller's shed and expiry decisions on
the same scripted traffic, the port's ``GatewayServer`` and JAX's on
ephemeral ports answering the same ``POST /predict`` bodies (the demo
model within 1e-5, its weights carried across by ``convert``; the
flagship chain's top-5 equal, the JAX side's Pallas kernels in interpret
mode), the typed errors and the routes JAX answers without a zoo or a
lifecycle, the lanes' retry and swap under load, and the entry in a
subprocess. Every HTTP call, future and join has its own timeout of a
few seconds."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.gateway import Gateway as JGateway
from keystone_tpu.gateway import GatewayServer as JGatewayServer
from keystone_tpu.gateway import admission as jadmission
from keystone_tpu.gateway.metrics import GatewayMetrics as JGatewayMetrics
from keystone_tpu.observability.registry import MetricsRegistry as JRegistry
from keystone_tpu.ops.learning.block_ls import BlockLinearMapper as JBlockLinearMapper
from keystone_tpu.ops.util.nodes import TopKClassifier as JTopK
from keystone_tpu.serving import bench as jbench
from keystone_tpu.serving.featurize import build_flagship_featurize_pipeline as jflagship
from keystone_tpu_torch import convert
from keystone_tpu_torch.gateway import Gateway, GatewayServer
from keystone_tpu_torch.gateway import admission as tadmission
from keystone_tpu_torch.gateway import http as thttp
from keystone_tpu_torch.gateway.lifecycle import MIN_REBUCKET_OBSERVATIONS
from keystone_tpu_torch.gateway.metrics import GatewayMetrics
from keystone_tpu_torch.loadgen import faults
from keystone_tpu_torch.observability.registry import MetricsRegistry
from keystone_tpu_torch.serving import bench as tbench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HTTP_TIMEOUT_S = 10
RESULT_TIMEOUT_S = 10
D = 8
# the flagship chain at a small image, just above 2 · lcs_border
IMG, DESC, VOCAB = 40, 8, 8
GEOMETRY = dict(sift_step=4, sift_bin=4, sift_scales=2, sift_scale_step=1,
                lcs_stride=4, lcs_border=16, lcs_patch=6)


@pytest.fixture(autouse=True)
def no_faults():
    faults.disarm_all()
    yield
    faults.disarm_all()


def _post(url, doc, timeout=HTTP_TIMEOUT_S):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        body = e.read()
        try:
            return e.code, json.loads(body)
        except ValueError:
            return e.code, body.decode()


def _get(url, timeout=HTTP_TIMEOUT_S):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


# -- admission: the same decisions on the same scripted traffic ---------------


class FakePool:
    """A pool whose capacity and completions the test controls."""

    def __init__(self):
        self.capacity = 0
        self.submitted = []
        self._listeners = []
        self._lock = threading.Lock()

    def add_free_listener(self, fn):
        self._listeners.append(fn)

    def free_capacity(self):
        return self.capacity

    def total_load(self):
        with self._lock:
            return len([f for _, f in self.submitted if not f.done()])

    def submit(self, example, parent_span_id=None):
        fut = Future()
        with self._lock:
            self.submitted.append((example, fut))
        return fut

    def open_capacity(self, n=1_000_000):
        self.capacity = n
        for fn in self._listeners:
            fn()

    def resolve_all(self, value="ok"):
        with self._lock:
            pending = [f for _, f in self.submitted if not f.done()]
        for f in pending:
            f.set_result(value)


ADMISSION = {
    "jax": (jadmission, JGatewayMetrics, JRegistry),
    "torch": (tadmission, GatewayMetrics, MetricsRegistry),
}


def _admission_script(pkg):
    """Queue bound, deadlines expiring in the queue, pressure and close,
    on a pool that drains only when told: every decision as
    (request, outcome)."""
    mod, metrics_cls, registry_cls = ADMISSION[pkg]
    pool = FakePool()
    metrics = metrics_cls(registry=registry_cls(), gateway="adm")
    adm = mod.AdmissionController(pool, max_pending=3, metrics=metrics)
    out, futs = [], {}

    def submit(name, **kw):
        try:
            futs[name] = adm.submit(name, **kw)
            out.append((name, "admitted"))
        except mod.Overloaded as e:
            out.append((name, e.reason))

    try:
        submit("a")
        submit("b", deadline_ms=20)
        submit("c")
        submit("d")  # queue full
        time.sleep(0.1)  # b's deadline passes in the queue
        pool.open_capacity()
        deadline = time.time() + RESULT_TIMEOUT_S
        while len(pool.submitted) < 2 and time.time() < deadline:
            time.sleep(0.005)
        pool.resolve_all("r")
        for name in ("a", "b", "c"):
            try:
                out.append((name, futs[name].result(timeout=RESULT_TIMEOUT_S)))
            except mod.Overloaded as e:
                out.append((name, e.reason))
        adm.set_pressure(0.9)
        pool.capacity = 0
        submit("e")
        submit("f")  # the pressure's bound: max(1, 3 · 0.1)
        adm.set_pressure(0.0)
    finally:
        pool.open_capacity()
        adm.close(timeout=RESULT_TIMEOUT_S)
        pool.resolve_all("late")
    submit("g")  # closed
    counts = {s: metrics.shed_count(s) for s in ("queue_full", "expired", "slo_pressure", "closed")}
    return out, counts, sorted(str(e) for e, _ in pool.submitted)


def test_admission_decisions_equal_jax():
    want, got = _admission_script("jax"), _admission_script("torch")
    assert got == want
    assert ("d", "queue_full") in got[0] and ("b", "expired") in got[0]
    assert ("f", "slo_pressure") in got[0] and ("g", "closed") in got[0]


def test_admission_validates_like_jax():
    for mod, *_ in ADMISSION.values():
        with pytest.raises(ValueError):
            mod.AdmissionController(FakePool(), max_pending=0)


# -- the demo model: the same bodies through both gateways --------------------


@pytest.fixture(scope="module")
def demo_pair():
    """JAX's gateway over ``build_pipeline(d=8, hidden=8, depth=2)`` and the
    port's over the same weights (``convert.affine_params``), both on
    ephemeral ports."""
    jfitted = jbench.build_pipeline(d=D, hidden=8, depth=2)
    tfitted = tbench.affine_chain(convert.affine_params(jfitted), device="cpu")
    jgw = JGateway(jfitted, buckets=(4,), n_lanes=2, warmup_example=jnp.zeros((D,), jnp.float32),
                   name="demo-jax")
    tgw = Gateway(tfitted, buckets=(4,), n_lanes=2, device="cpu",
                  warmup_example=torch.zeros((D,)), name="demo-torch")
    jsrv = JGatewayServer(jgw, port=0).start()
    tsrv = GatewayServer(tgw, port=0).start()
    yield jsrv, tsrv, tgw
    for gw, srv in ((jgw, jsrv), (tgw, tsrv)):
        gw.close(timeout=RESULT_TIMEOUT_S)
        srv.stop()


def test_demo_predictions_match_jax(demo_pair):
    jsrv, tsrv, _ = demo_pair
    rng = np.random.default_rng(3)
    for n in (1, 3, 6):
        doc = {"instances": rng.standard_normal((n, D)).astype(np.float32).tolist()}
        (jcode, jdoc), (tcode, tdoc) = _post(jsrv.url("/predict"), doc), _post(tsrv.url("/predict"), doc)
        assert jcode == tcode == 200
        np.testing.assert_allclose(np.asarray(tdoc["predictions"]), np.asarray(jdoc["predictions"]),
                                   rtol=0, atol=1e-5)


def test_the_same_seed_builds_the_same_demo_model():
    jfitted = jbench.build_pipeline(d=D, hidden=8, depth=3, seed=5)
    tfitted = tbench.build_pipeline(d=D, hidden=8, depth=3, seed=5, device="cpu")
    for (jw, jb), (tw, tb) in zip(convert.affine_params(jfitted), convert.affine_params(tfitted)):
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(tb, jb)
    base, w, b = tbench.build_split_pipeline(d=D, hidden=8, depth=3, seed=5, device="cpu")
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((4, D)).astype(np.float32))
    whole = tfitted._batch_run(x)
    split = base.and_then(tbench.affine_head(w, b, device="cpu"))._batch_run(x)
    assert torch.equal(whole, split)


@pytest.mark.parametrize("path,method", [
    ("/planz", "GET"), ("/attributionz", "GET"), ("/driftz", "GET"), ("/lifecyclez", "GET"),
    ("/predict/some-model", "POST"), ("/feedback", "POST"), ("/feedback/m", "POST"),
    ("/lifecyclez", "POST"), ("/nowhere", "GET"), ("/nowhere", "POST"),
])
def test_routes_without_zoo_or_lifecycle_answer_as_jax(demo_pair, path, method):
    jsrv, tsrv, _ = demo_pair
    call = (lambda srv: _get(srv.url(path))) if method == "GET" else (
        lambda srv: _post(srv.url(path), {"instances": [[0.0] * D]}))
    assert call(tsrv) == call(jsrv)


@pytest.mark.parametrize("body", [{"instances": []}, {"nope": 1}, {"instances": "x"},
                                  {"instances": [[0.0] * D], "deadline_ms": -1},
                                  {"instances": [[0.0] * D], "deadline_ms": True}])
def test_bad_requests_are_400_as_jax(demo_pair, body):
    jsrv, tsrv, _ = demo_pair
    (jcode, jdoc), (tcode, tdoc) = _post(jsrv.url("/predict"), body), _post(tsrv.url("/predict"), body)
    assert tcode == jcode == 400 and tdoc["error"] == jdoc["error"] == "bad_request"


def test_metrics_chaosz_and_readyz(demo_pair):
    _, tsrv, tgw = demo_pair
    _post(tsrv.url("/predict"), {"instances": [[0.5] * D]})
    code, text = _get(tsrv.url("/metrics"))
    assert code == 200
    for line in ('keystone_gateway_requests_total{gateway="demo-torch",status="ok"}',
                 'keystone_gateway_ready{gateway="demo-torch"} 1',
                 "# TYPE keystone_gateway_request_latency_seconds histogram",
                 "# TYPE keystone_device_info gauge", "keystone_device_memory_bytes",
                 'keystone_serving_examples_total{engine="demo-torch-lane0"}'):
        assert line in text, line
    code, doc = _post(tsrv.url("/chaosz"), {"arm": {"point": "gateway.lane.kill", "count": 1,
                                                    "match": {"lane": 0}}})
    assert code == 200 and "gateway.lane.kill" in doc["armed"]
    # a point outside the catalog (the port's is the JAX package's whole)
    assert _post(tsrv.url("/chaosz"), {"arm": {"point": "no.such.point"}})[0] == 400
    code, doc = _post(tsrv.url("/chaosz"), {"disarm": "*"})
    assert code == 200 and doc["armed"] == {}
    code, text = _get(tsrv.url("/readyz"))
    assert (code, text) == (200, "ok\n")
    for route in ("/slz", "/debugz", "/tracez", "/healthz"):
        assert _get(tsrv.url(route))[0] == 200, route


# -- typed errors, swap and drain on a gateway of its own -------------------


def _gateway(buckets=(4, 8), **kw):
    fitted = tbench.build_pipeline(d=D, hidden=8, depth=2, device="cpu")
    kw.setdefault("warmup_example", torch.zeros((D,)))
    return fitted, Gateway(fitted, buckets=buckets, n_lanes=2, device="cpu", **kw)


def test_queue_full_is_429_and_drain_is_503():
    _, gw = _gateway(max_pending=1, lane_capacity=1, name="shed-gw")
    srv = GatewayServer(gw, port=0).start()
    try:
        # one request a lane, whose host-prep stalls: the queue holds one
        # more, and the rest are shed
        faults.arm("pipeline.host_prep.stall", delay_ms=300.0)
        results = []

        def post():
            results.append(_post(srv.url("/predict"), {"instances": [[0.1] * D]}))

        threads = [threading.Thread(target=post) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(HTTP_TIMEOUT_S)
        faults.disarm_all()
        codes = sorted(code for code, _ in results)
        assert 429 in codes and 200 in codes, codes
        shed = next(doc for code, doc in results if code == 429)
        assert shed["error"] == "overloaded" and shed["reason"] == "queue_full"
        code, doc = _post(srv.url("/drain"), {})
        assert (code, doc) == (200, {"draining": True})
        deadline = time.time() + HTTP_TIMEOUT_S
        while _get(srv.url("/readyz"))[0] != 503 and time.time() < deadline:
            time.sleep(0.02)
        assert _get(srv.url("/readyz")) == (503, "draining\n")
        code, doc = _post(srv.url("/predict"), {"instances": [[0.1] * D]})
        assert code == 503 and doc["reason"] == "closed"
    finally:
        gw.close(timeout=RESULT_TIMEOUT_S)
        srv.stop()


def test_forced_swap_under_load_zero_failures_identical_outputs():
    fitted, gw = _gateway(name="swap-gw")
    xs = np.random.default_rng(42).standard_normal((16, D)).astype(np.float32)
    want = fitted._batch_run(torch.as_tensor(xs)).numpy()
    failures, mismatches = [], []
    stop = threading.Event()

    def client(tid):
        rng = np.random.default_rng(tid)
        while not stop.is_set():
            i = int(rng.integers(0, len(xs)))
            try:
                out = gw.predict(xs[i]).result(timeout=RESULT_TIMEOUT_S)
            except Exception as e:
                failures.append(e)
                continue
            if not np.allclose(out, want[i], rtol=1e-5, atol=1e-6):
                mismatches.append(i)

    try:
        threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.05)
        assert gw.rebucket(force=True) is True
        gw.swap_engines((2, 8))
        time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join(RESULT_TIMEOUT_S)
        assert not failures and not mismatches, (failures[:3], mismatches[:3])
        assert gw.metrics.swap_count() == 2 and gw.buckets == (2, 8)
        assert all(lane.engine.buckets == (2, 8) for lane in gw.pool.lanes)
    finally:
        stop.set()
        gw.close(timeout=RESULT_TIMEOUT_S)


def test_rebucket_needs_evidence_and_the_chaos_trigger_swaps():
    _, gw = _gateway(buckets=(8,), rebucket_k=2, max_delay_ms=0.5, name="rebucket-gw")
    try:
        assert gw.rebucket() is False
        for i in range(MIN_REBUCKET_OBSERVATIONS):
            gw.predict(np.full(D, i / 100, np.float32)).result(timeout=RESULT_TIMEOUT_S)
        assert gw.rebucket() is True
        assert gw.buckets[-1] == 8 and gw.buckets[0] < 8
        assert gw.rebucket() is False
        swaps = gw.metrics.swap_count()
        faults.arm("gateway.swap.force", match={"gateway": "rebucket-gw"})
        deadline = time.time() + RESULT_TIMEOUT_S
        while gw.metrics.swap_count() == swaps and time.time() < deadline:
            time.sleep(0.02)
        assert gw.metrics.swap_count() == swaps + 1
    finally:
        gw.close(timeout=RESULT_TIMEOUT_S)


def test_lane_kill_is_absorbed_by_the_pool_retry():
    fitted, gw = _gateway(name="kill-gw")
    xs = np.random.default_rng(7).standard_normal((12, D)).astype(np.float32)
    want = fitted._batch_run(torch.as_tensor(xs)).numpy()
    try:
        faults.arm("gateway.lane.kill", match={"lane": 0}, count=4)
        rows = np.stack([gw.predict(x).result(timeout=RESULT_TIMEOUT_S) for x in xs])
        np.testing.assert_allclose(rows, want, rtol=1e-5, atol=1e-6)
        assert gw.metrics.retry_count() >= 1
    finally:
        gw.close(timeout=RESULT_TIMEOUT_S)


def test_unported_gateway_options_raise(tmp_path):
    """``param_sharding`` and ``aot_store`` are ported (they raised
    before): a sharded gateway answers as the plain one, ``aot_store=None``
    keeps the store off, and a gateway on a store saves every bucket of
    every lane's engine, the second lane hitting what the first saved."""
    from keystone_tpu_torch.serving.aot import AotStore

    fitted = tbench.build_pipeline(d=D, hidden=8, depth=2, device="cpu")
    x = np.linspace(-1, 1, D).astype(np.float32)
    want = fitted._batch_run(torch.as_tensor(np.stack([x] * 4)))[0].numpy()
    store = AotStore(str(tmp_path / "aot"), registry=MetricsRegistry())
    for kw in (dict(param_sharding=True), dict(aot_store=None), dict(aot_store=store)):
        gw = Gateway(fitted, buckets=(4,), n_lanes=2, device="cpu", warmup_example=torch.zeros(D),
                     registry=MetricsRegistry(), **kw)
        with gw:
            assert np.array_equal(gw.predict(x).result(timeout=RESULT_TIMEOUT_S), want)
            engines = [lane.engine for lane in gw.pool.lanes]
        if "param_sharding" in kw:
            assert all(e.model_sharded for e in engines)
        elif kw["aot_store"] is None:
            assert [e.aot_report() for e in engines] == [{}, {}]
        else:
            assert [e.aot_report()[4]["status"] for e in engines] == ["saved", "hit"]
            assert store.hits == 1 and store.saves == 1


# -- the flagship chain: top-5 equal through both gateways ------------------


def test_flagship_top5_match_jax():
    jfeat, feat_dim = jflagship(img=IMG, desc_dim=DESC, vocab=VOCAB, **GEOMETRY)
    rng = np.random.default_rng(13)
    W = (rng.standard_normal((feat_dim, 20)) / np.sqrt(feat_dim)).astype(np.float32)
    b = (rng.standard_normal(20) * 0.01).astype(np.float32)
    jmodel = JBlockLinearMapper(jnp.asarray(W), feat_dim, explicit_intercept=jnp.asarray(b)).and_then(
        JTopK(5)).fit()
    tfeat, _ = convert.flagship_from_numpy(
        {**_jax_flagship_params(jfeat)}, device="cpu", **GEOMETRY)
    tmodel = convert.model_head(W, b, 5, "cpu")
    jgw = JGateway(jmodel, buckets=(4,), n_lanes=1, device_featurize=jfeat, name="flag-jax")
    tgw = Gateway(tmodel, buckets=(4,), n_lanes=1, device_featurize=tfeat, device="cpu",
                  warmup_example=np.zeros((IMG, IMG, 3), np.uint8), name="flag-torch")
    jsrv = JGatewayServer(jgw, port=0, input_dtype=np.uint8).start()
    tsrv = GatewayServer(tgw, port=0, input_dtype=np.uint8).start()
    try:
        images = rng.integers(0, 256, (3, IMG, IMG, 3), dtype=np.uint8)
        doc = {"instances": images.tolist()}
        (jcode, jdoc) = _post(jsrv.url("/predict"), doc, timeout=120)
        (tcode, tdoc) = _post(tsrv.url("/predict"), doc)
        assert jcode == tcode == 200
        assert tdoc["predictions"] == jdoc["predictions"]
        assert np.asarray(tdoc["predictions"]).shape == (3, 5)
        code, err = _post(tsrv.url("/predict"), {"instances": [[[[256, 0, 0]] * IMG] * IMG]})
        assert code == 400 and err["error"] == "bad_request"  # 256 overflows uint8
    finally:
        for gw, srv in ((jgw, jsrv), (tgw, tsrv)):
            gw.close(timeout=RESULT_TIMEOUT_S)
            srv.stop()


def _jax_flagship_params(jfeat):
    """numpy parameters of the JAX package's flagship chain, by branch."""
    from keystone_tpu.ops.images.fisher_vector import FisherVector, FisherVectorFused
    from keystone_tpu.ops.learning import BatchPCATransformer

    g, out = jfeat.graph, {}
    for nid, op in g.operators.items():
        if isinstance(op, BatchPCATransformer):
            fv = next(o for n, o in g.operators.items()
                      if isinstance(o, (FisherVector, FisherVectorFused)) and g.dependencies[n] == (nid,))
            pca = np.asarray(op.pca_mat)
            out["sift" if pca.shape[0] == 128 else "lcs"] = {
                "pca": pca, "means": np.asarray(fv.gmm.means),
                "variances": np.asarray(fv.gmm.variances), "weights": np.asarray(fv.gmm.weights),
                "threshold": fv.gmm.weight_threshold}
    return out


# -- the entry ---------------------------------------------------------------


def test_entry_in_a_subprocess_serves_and_exits_0_on_sigterm():
    code = ("from keystone_tpu_torch.gateway.http import main; import sys; "
            "sys.exit(main(['--gateway-port', '0', '--d', '8', '--hidden', '8', '--depth', '2', "
            "'--buckets', '4'], device='cpu'))")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    try:
        line = [None]
        reader = threading.Thread(target=lambda: line.__setitem__(0, proc.stdout.readline()))
        reader.start()
        reader.join(60)
        first = json.loads(line[0])
        assert first["role"] == "gateway"
        code_, doc = _post(first["listening"] + "/predict", {"instances": [[0.25] * D]})
        assert code_ == 200 and len(doc["predictions"][0]) == D
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)


def test_entry_without_a_card_raises():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        thttp.main(["--gateway-port", "0", "--d", "8", "--hidden", "8", "--depth", "2"])


LIFECYCLE_FLAGS = ("--refit", "--refit-interval-s", "--refit-min-samples", "--canary-fraction")
# serve-gateway's sharding and AOT flags (they exited 2 before the port
# had serving/sharding.py and serving/aot.py)
PLANE_FLAGS = ("--shard-model", "--mesh-model", "--aot-cache")


def _entry(argv, timeout=60):
    """``serve-gateway argv`` on the CPU in a subprocess: (process, its
    ``{"listening": ...}`` line)."""
    code = ("from keystone_tpu_torch.gateway.http import main; import sys; "
            "sys.exit(main(sys.argv[1:], device='cpu'))")
    proc = subprocess.Popen([sys.executable, "-c", code, "--gateway-port", "0", *argv],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            text=True)
    line = [None]
    reader = threading.Thread(target=lambda: line.__setitem__(0, proc.stdout.readline()))
    reader.start()
    reader.join(timeout)
    if not line[0]:
        proc.kill()
        raise AssertionError(f"no listening line from {argv}")
    return proc, json.loads(line[0])


def _stop(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        out, _ = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    return proc.returncode, out


@pytest.mark.parametrize("flag", LIFECYCLE_FLAGS + PLANE_FLAGS)
def test_unported_flags_exit_2(flag, capsys, tmp_path):
    """The sharding and AOT flags run (they exited 2 before): under
    ``--shard-model`` the listening line names every param's spec over
    a (1, 1) mesh and the answers equal the plain model's, ``--mesh-model``
    past the host's devices exits 1 with its reason, and a second start on
    one ``--aot-cache`` hits every bucket the first saved (its /metrics
    counts the hits). The lifecycle's flags parse, and --refit over the
    flagship chain exits 2 as JAX's entry does (its message, before any
    model is built)."""
    model = ["--d", str(D), "--hidden", "8", "--depth", "2", "--buckets", "2,4", "--lanes", "1"]
    if flag == "--mesh-model":
        assert thttp.main(["--shard-model", "--mesh-model", "2", *model], device="cpu") == 1
        assert "needs 2 devices" in capsys.readouterr().out
        from keystone_tpu_torch.serving import sharding

        sharding.set_mesh(None)
        return
    if flag == "--shard-model":
        proc, first = _entry(["--shard-model", "--mesh-model", "1", *model])
        try:
            assert first["mesh"] == {"data": 1, "model": 1}
            assert first["sharding"]["0/_Affine/W"] == "PartitionSpec(None, 'model')"
            assert first["sharding"]["0/_Affine/b"] == "PartitionSpec()"
            x = np.linspace(-1, 1, D).astype(np.float32)
            fitted = tbench.build_pipeline(d=D, hidden=8, depth=2, device="cpu")
            want = fitted._batch_run(torch.as_tensor(np.stack([x, 0 * x])))[0].numpy()
            code_, doc = _post(first["listening"] + "/predict", {"instances": [x.tolist()]})
            assert code_ == 200 and np.array_equal(np.float32(doc["predictions"][0]), want)
        finally:
            rc, out = _stop(proc)
        assert rc == 0 and json.loads(out.strip().splitlines()[-1])["drained"] is True
        return
    if flag == "--aot-cache":
        hits = []
        for _ in range(2):
            proc, first = _entry(["--aot-cache", str(tmp_path / "aot"), *model])
            try:
                assert set(first["start_s"]) >= {"model", "gateway", "warmup", "total"}
                _, text = _get(first["listening"] + "/metrics")
                hits.append(sum(float(ln.split()[-1]) for ln in text.splitlines()
                                if ln.startswith("keystone_aot_cache_hits_total")))
            finally:
                assert _stop(proc)[0] == 0
        assert hits == [0.0, 2.0]
        return
    argv = ["--refit", "--device-featurize"] + ([] if flag == "--refit" else [flag, "1"])
    assert thttp.main(argv, device="cpu") == 2
    assert "--refit wants the plain demo model" in capsys.readouterr().out
