"""The fleet tier of ``keystone_tpu_torch`` on the CPU: the port's
``RouterServer`` in-process over port gateways on ephemeral ports —
least-loaded routing, the retry on a dead replica, typed 429/503/504
passed through verbatim, ``/registerz``/``/deregisterz``, ``/fleetz``,
the federated ``/metrics`` count against the replicas' own, the three
``router.*`` chaos points and the stitched ``/debugz`` of a routed
request; one mixed drill (the port's router over a JAX replica and the
JAX package's router over a port replica answer alike: the wire format
is shared); and the ``serve-router`` and ``serve-gateway --register``
entries in subprocesses. Every HTTP call, future and join has its own
timeout of a few seconds."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.fleet import RouterServer as JRouterServer
from keystone_tpu.gateway import Gateway as JGateway
from keystone_tpu.gateway import GatewayServer as JGatewayServer
from keystone_tpu.observability.registry import MetricsRegistry as JRegistry
from keystone_tpu.serving import bench as jbench
from keystone_tpu_torch import convert
from keystone_tpu_torch.fleet import RouterServer
from keystone_tpu_torch.fleet import client as fclient
from keystone_tpu_torch.gateway import Gateway, GatewayServer
from keystone_tpu_torch.loadgen import faults
from keystone_tpu_torch.observability import prometheus, tracing
from keystone_tpu_torch.observability.registry import MetricsRegistry
from keystone_tpu_torch.serving import bench as tbench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HTTP_TIMEOUT_S = 10
WAIT_S = 10
D = 8


@pytest.fixture(autouse=True)
def no_faults():
    faults.disarm_all()
    yield
    faults.disarm_all()


@pytest.fixture
def traced():
    """The process-global tracer on for one test (the router traces by
    default; the in-process replicas share its tracer)."""
    tracing.enable_tracing()
    yield
    tracing.disable_tracing()


def _post(url, doc, timeout=HTTP_TIMEOUT_S, headers=None):
    """POST JSON; returns (status, parsed body, response headers)."""
    data = doc if isinstance(doc, bytes) else json.dumps(doc).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json",
                                                         **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        body = e.read()
        try:
            return e.code, json.loads(body), dict(e.headers)
        except ValueError:
            return e.code, body.decode(), dict(e.headers)


def _get(url, timeout=HTTP_TIMEOUT_S):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _wait(cond, what, timeout=WAIT_S):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


class Replica:
    """A port gateway over the demo model (``build_pipeline(d=8, hidden=8,
    depth=2)``) on an ephemeral port, with a registry of its own."""

    def __init__(self, name, **kw):
        self.registry = MetricsRegistry()
        self.fitted = tbench.build_pipeline(d=D, hidden=8, depth=2, device="cpu")
        kw.setdefault("buckets", (4,))
        self.gateway = Gateway(self.fitted, n_lanes=1, device="cpu",
                               warmup_example=torch.zeros((D,)), name=name,
                               registry=self.registry, **kw)
        self.server = GatewayServer(self.gateway, port=0, registry=self.registry).start()
        self.url = self.server.url().rstrip("/")
        self.name = self.url.split("//")[1]

    def ok_count(self):
        _, text = _get(self.url + "/metrics")
        return _requests_ok(text)

    def close(self):
        self.gateway.close(timeout=WAIT_S)
        self.server.stop()


def _requests_ok(text):
    return sum(v for n, labels, v in prometheus.parse_samples(text)
               if n == "keystone_gateway_requests_total" and labels.get("status") == "ok")


@pytest.fixture
def fleet():
    """The port's router over two port replicas that registered
    themselves through ``fleet/client.post_roster``, probed once by hand
    (no background probe moves the loads the picks read)."""
    router = RouterServer(registry=MetricsRegistry(), probe_interval_s=60.0).start()
    url = router.url().rstrip("/")
    replicas = [Replica("rep-a"), Replica("rep-b")]
    try:
        for r in replicas:
            fclient.post_roster(url, fclient.REGISTER_ROUTE, r.url, timeout_s=HTTP_TIMEOUT_S)
        assert sorted(r.url for r in router.fleet.replicas()) == sorted(r.url for r in replicas)
        router.fleet.probe_once()
        assert all(r.ready for r in router.fleet.replicas())
        yield router, url, replicas
    finally:
        router.stop()
        for r in replicas:
            r.close()


def _steer(router, busy, n=5):
    """Make ``busy`` look loaded: the picks go to the other replica first."""
    replica = router.fleet.find_by_name(busy.name)
    for _ in range(n):
        replica.begin_request()
    return lambda: [replica.end_request() for _ in range(n)]


def _xs(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)


def test_router_routes_least_loaded_and_answers_as_the_replica(fleet):
    router, url, (a, b) = fleet
    xs = _xs(24)
    want = a.fitted._batch_run(torch.as_tensor(xs)).numpy()
    results = {}

    def client(i):
        results[i] = _post(url + "/predict", {"instances": [xs[i].tolist()]})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(HTTP_TIMEOUT_S)
    for i, (code, doc, _) in results.items():
        assert code == 200
        np.testing.assert_allclose(np.asarray(doc["predictions"][0]), want[i], rtol=1e-5, atol=1e-6)
    assert len(results) == len(xs)
    assert a.ok_count() + b.ok_count() == len(xs)
    # least-loaded: requests this router holds open against a replica
    # count as its load until the next probe
    router.fleet.probe_once()  # the idle replicas report load 0
    for busy, idle in ((a, b), (b, a)):
        release = _steer(router, busy, n=3)
        try:
            assert router.fleet.pick().name == idle.name
            assert router.fleet.pick(exclude=[router.fleet.find_by_name(idle.name)]).name == busy.name
            before = idle.ok_count()
            assert _post(url + "/predict", {"instances": [xs[0].tolist()]})[0] == 200
            assert idle.ok_count() == before + 1
        finally:
            release()


def test_router_retries_on_a_dead_replica_and_fleetz_shows_it():
    # probes by hand: the dead replica stays in the pick until the
    # request path itself charges it
    router = RouterServer(registry=MetricsRegistry(), probe_interval_s=60.0).start()
    url = router.url().rstrip("/")
    a, b = Replica("dead-a"), Replica("dead-b")
    try:
        for r in (a, b):
            fclient.post_roster(url, fclient.REGISTER_ROUTE, r.url, timeout_s=HTTP_TIMEOUT_S)
        router.fleet.probe_once()
        b.server.stop()
        ra = router.fleet.find_by_name(a.name)
        for _ in range(5):
            ra.begin_request()  # a looks busy: the pick goes to b first
        try:
            for i in range(3):
                code, doc, _ = _post(url + "/predict", {"instances": [_xs(1, i)[0].tolist()]})
                assert code == 200, doc
        finally:
            for _ in range(5):
                ra.end_request()
        assert router.metrics.retry_count() == 3
        states = {r["name"]: r["state"] for r in json.loads(_get(url + "/fleetz")[1])["replicas"]}
        assert states == {a.name: "healthy", b.name: "unhealthy"}
        router.fleet.probe_once()
        doc = json.loads(_get(url + "/fleetz")[1])
        states = {r["name"]: r["state"] for r in doc["replicas"]}
        assert states == {a.name: "healthy", b.name: "unreachable"}
        assert doc["router"]["max_retries"] == 1 and doc["counts"] == {"healthy": 1, "unreachable": 1}
        code, text = _get(url + "/readyz")
        assert code == 200 and text.startswith("ok (1/2 replicas ready")
    finally:
        router.stop()
        a.close()
        b.gateway.close(timeout=WAIT_S)


def test_router_retries_a_replica_that_dies_mid_response():
    """A replica that sends its headers and then closes the connection
    before its body (a ``kill -9`` mid-response) is retried on another
    replica, as a refused connection is."""
    import http.server

    class Dying(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"ok")

        def do_POST(self):
            self.rfile.read(int(self.headers["Content-Length"]))
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", "1000")
            self.end_headers()
            self.wfile.write(b'{"predictions"')
            self.close_connection = True

        def log_message(self, *args):
            pass

    dying = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Dying)
    threading.Thread(target=dying.serve_forever, daemon=True).start()
    router = RouterServer(registry=MetricsRegistry(), probe_interval_s=60.0).start()
    url = router.url().rstrip("/")
    a = Replica("mid-a")
    try:
        for r in (a.url, f"http://127.0.0.1:{dying.server_port}"):
            fclient.post_roster(url, fclient.REGISTER_ROUTE, r, timeout_s=HTTP_TIMEOUT_S)
        router.fleet.probe_once()
        release = _steer(router, a)  # the pick goes to the dying replica first
        try:
            code, doc, _ = _post(url + "/predict", {"instances": [_xs(1)[0].tolist()]})
        finally:
            release()
        assert code == 200 and len(doc["predictions"]) == 1, doc
        assert router.metrics.retry_count() == 1
    finally:
        router.stop()
        a.close()
        dying.shutdown()
        dying.server_close()


def test_typed_sheds_pass_through_the_router_verbatim():
    router = RouterServer(registry=MetricsRegistry(), probe_interval_s=0.1).start()
    url = router.url().rstrip("/")
    rep = Replica("shed-rep", max_pending=1, lane_capacity=1)
    try:
        fclient.post_roster(url, fclient.REGISTER_ROUTE, rep.url, timeout_s=HTTP_TIMEOUT_S)
        faults.arm("pipeline.host_prep.stall", delay_ms=300.0)
        results = []
        body = {"instances": [[0.1] * D]}

        def post(doc):
            results.append(_post(url + "/predict", doc))

        threads = [threading.Thread(target=post, args=(body,)) for _ in range(6)]
        threads.append(threading.Thread(target=post, args=({**body, "deadline_ms": 5},)))
        for t in threads:
            t.start()
        for t in threads:
            t.join(HTTP_TIMEOUT_S)
        faults.disarm_all()
        by_code = {}
        for code, doc, headers in results:
            by_code.setdefault(code, []).append(doc)
        assert 200 in by_code and 429 in by_code, sorted(by_code)
        assert all(d == {"error": "overloaded", "reason": "queue_full", "detail": d["detail"]}
                   for d in by_code[429])
        # a direct POST to the replica sheds with the same body shape
        expired = [d for d in by_code.get(504, [])] + [d for d in by_code.get(429, [])
                                                       if d["reason"] == "expired"]
        assert all(d["error"] == "overloaded" for d in expired)
        code, doc, _ = _post(rep.url + "/predict", {**body, "deadline_ms": 0.001})
        rcode, rdoc, _ = _post(url + "/predict", {**body, "deadline_ms": 0.001})
        assert (rcode, rdoc["error"], rdoc["reason"]) == (code, doc["error"], doc["reason"])
        # the only replica drains: its typed 503 closed is the answer
        rep.gateway.close(timeout=WAIT_S)
        code, doc, _ = _post(url + "/predict", body)
        assert code == 503 and doc["error"] == "overloaded" and doc["reason"] == "closed"
        assert router.metrics.outcome_count("shed") >= 2
    finally:
        faults.disarm_all()
        router.stop()
        rep.close()


def test_registerz_and_deregisterz():
    router = RouterServer(registry=MetricsRegistry(), probe_interval_s=0.1).start()
    url = router.url().rstrip("/")
    rep = Replica("roster-rep")
    try:
        for bad in ({}, {"url": 5}, {"url": "ftp://x"}, {"url": rep.url, "models": "m"}):
            code, doc, _ = _post(url + "/registerz", bad)
            assert code == 400 and doc["error"] == "bad_request", bad
        code, doc, _ = _post(url + "/registerz", {"url": rep.url, "models": ["m1"]})
        assert code == 200 and doc["created"] is True and doc["models"] == ["m1"]
        code, doc, _ = _post(url + "/registerz", {"url": rep.url + "/", "models": ["m2", "m1"]})
        assert code == 200 and doc["created"] is False and doc["models"] == ["m1", "m2"]
        assert doc["replicas"] == 1
        fleetz = json.loads(_get(url + "/fleetz")[1])
        assert [r["url"] for r in fleetz["replicas"]] == [rep.url]
        # a model nobody advertises is a routing fact, not overload
        code, doc, _ = _post(url + "/predict/nope", {"instances": [[0.0] * D]})
        assert code == 503 and doc["error"] == "no_replica_for_model" and doc["model"] == "nope"
        assert fclient.try_deregister(url, rep.url, timeout_s=HTTP_TIMEOUT_S) is True
        code, doc, _ = _post(url + "/deregisterz", {"url": rep.url})
        assert code == 200 and doc == {"deregistered": False, "replicas": 0}
        code, doc, _ = _post(url + "/predict", {"instances": [[0.0] * D]})
        assert code == 503 and doc["reason"] == "closed"
        assert _post(url + "/deregisterz", {"nope": 1})[0] == 400
    finally:
        router.stop()
        rep.close()


def test_federated_metrics_count_equals_the_replicas_sum(fleet):
    router, url, (a, b) = fleet
    for i in range(10):
        assert _post(url + "/predict", {"instances": [_xs(1, i)[0].tolist()]})[0] == 200
    code, text = _get(url + "/metrics")
    assert code == 200
    fleet_ok = _requests_ok(text)
    assert fleet_ok == a.ok_count() + b.ok_count() == 10
    assert "keystone_router_requests_total" in text


def test_router_chaos_points(fleet, traced):
    router, url, (a, b) = fleet
    body = {"instances": [[0.5] * D]}
    code, doc, _ = _post(url + "/chaosz", {"arm": {"point": "router.replica.partition",
                                                   "match": {"replica": a.name}, "count": 2}})
    assert code == 200 and "router.replica.partition" in doc["armed"]
    assert _post(url + "/chaosz", {"arm": {"point": "no.such.point"}})[0] == 400
    retries = router.metrics.retry_count()
    release = _steer(router, b)
    try:
        for _ in range(4):
            assert _post(url + "/predict", body)[0] == 200
    finally:
        release()
    assert router.metrics.retry_count() == retries + 2
    assert faults.get_injector().fired_count("router.replica.partition") == 2
    faults.disarm_all()
    router.fleet.find_by_name(a.name).mark_ok()
    faults.arm("router.replica.blackhole", match={"replica": b.name}, count=2)
    release = _steer(router, a)
    try:
        for _ in range(4):
            assert _post(url + "/predict", body)[0] == 200
    finally:
        release()
    assert faults.get_injector().fired_count("router.replica.blackhole") == 2
    assert router.metrics.retry_count() == retries + 4
    faults.disarm_all()
    # the trace context stripped off the forward: served all the same,
    # and the stitch degrades to the router's partial tree
    faults.arm("router.trace.drop", count=1)
    code, _, headers = _post(url + "/predict", body)
    assert code == 200
    tid = headers["X-Keystone-Trace"]
    code, text = _get(url + f"/debugz?trace_id={tid}")
    doc = json.loads(text)
    assert code == 200 and doc["partial"] is True and doc["processes"] == ["router"]
    assert "no spans for this trace" in doc["partial_detail"][0]


def test_stitched_debugz_spans_both_tiers(fleet, traced):
    router, url, (a, b) = fleet
    tid = "4bf92f3577b34da6a3ce929d0e0e4736"
    code, _, headers = _post(url + "/predict", {"instances": [[0.25] * D, [0.5] * D]},
                             headers={"traceparent": f"00-{tid}-00f067aa0ba902b7-01"})
    assert code == 200 and headers["X-Keystone-Trace"] == tid
    code, text = _get(url + f"/debugz?trace_id={tid}")
    doc = json.loads(text)
    assert code == 200 and doc["partial"] is False, doc.get("partial_detail")
    assert doc["processes"][0] == "router" and doc["processes"][1].startswith("replica:")
    names = {s["name"] for s in doc["spans"]}
    assert {"router.forward", "gateway.admit", "microbatch.coalesce"} <= names
    assert names & {"pipeline.compute", "serving.dispatch"}
    phases = doc["phases_ms"]
    assert set(phases) == {"router_hop", "queue_wait", "coalesce", "device", "deliver"}
    assert abs(sum(phases.values()) - doc["total_ms"]) <= 1.0
    assert phases["device"] > 0
    chrome = json.loads(_get(url + f"/debugz?trace_id={tid}&format=chrome")[1])
    assert {e["pid"] for e in chrome["traceEvents"]} == {0, 1}
    assert _get(url + "/debugz")[0] == 400
    assert _get(url + "/debugz?trace_id=" + "0" * 31 + "1")[0] == 404
    tz = json.loads(_get(url + "/tracez?n=50")[1])
    assert any(s["name"] == "router.forward" for s in tz["spans"])


# -- the mixed drill: each package's router over the other's replica ------------


def _wait_replicas_ready(url, timeout_s=WAIT_S):
    """Wait, at most ``timeout_s``, until the router at ``url`` lists
    every replica as ready on ``/fleetz``."""
    deadline = time.monotonic() + timeout_s
    while True:
        rows = json.loads(_get(url + "/fleetz")[1])["replicas"]
        if rows and all(r["ready"] for r in rows):
            return
        assert time.monotonic() < deadline, rows
        time.sleep(0.05)


def test_each_router_serves_the_other_packages_replica_alike():
    jfitted = jbench.build_pipeline(d=D, hidden=8, depth=2)
    tfitted = tbench.affine_chain(convert.affine_params(jfitted), device="cpu")
    jreg, treg = JRegistry(), MetricsRegistry()
    jgw = JGateway(jfitted, buckets=(4,), n_lanes=1, warmup_example=jnp.zeros((D,), jnp.float32),
                   name="mixed-jax", registry=jreg)
    tgw = Gateway(tfitted, buckets=(4,), n_lanes=1, device="cpu", warmup_example=torch.zeros((D,)),
                  name="mixed-torch", registry=treg)
    jsrv = JGatewayServer(jgw, port=0, registry=jreg).start()
    tsrv = GatewayServer(tgw, port=0, registry=treg).start()
    trouter = RouterServer(registry=MetricsRegistry(), probe_interval_s=0.1).start()
    jrouter = JRouterServer(registry=JRegistry(), probe_interval_s=0.1).start()
    try:
        turl, jurl = trouter.url().rstrip("/"), jrouter.url().rstrip("/")
        # each router's registration client against the other package's router
        fclient.post_roster(jurl, fclient.REGISTER_ROUTE, tsrv.url().rstrip("/"),
                            timeout_s=HTTP_TIMEOUT_S)
        from keystone_tpu.fleet import client as jclient

        jclient.post_roster(turl, jclient.REGISTER_ROUTE, jsrv.url().rstrip("/"),
                            timeout_s=HTTP_TIMEOUT_S)
        xs = _xs(5, 9)
        doc = {"instances": xs.tolist()}
        tcode, tdoc, _ = _post(turl + "/predict", doc)  # port router -> JAX replica
        jcode, jdoc, _ = _post(jurl + "/predict", doc)  # JAX router -> port replica
        assert tcode == jcode == 200
        np.testing.assert_allclose(np.asarray(tdoc["predictions"]), np.asarray(jdoc["predictions"]),
                                   rtol=0, atol=1e-5)
        for path, body in (("/predict/some-model", doc), ("/predict", {"instances": []}),
                           ("/predict", b"")):
            (tc, td, _), (jc, jd, _) = _post(turl + path, body), _post(jurl + path, body)
            assert tc == jc and td == jd, path
        # a registration is not probed at once: /readyz answers 503 until
        # the first probe sweep has read the replica's /readyz, which a
        # loaded host may not have finished yet
        for url in (turl, jurl):
            _wait_replicas_ready(url)
        for route in ("/fleetz", "/readyz", "/driftz", "/attributionz", "/chaosz"):
            (tc, tt), (jc, jt) = _get(turl + route), _get(jurl + route)
            assert tc == jc, route
        tz, jz = json.loads(_get(turl + "/fleetz")[1]), json.loads(_get(jurl + "/fleetz")[1])
        assert sorted(tz) == sorted(jz) and sorted(tz["replicas"][0]) == sorted(jz["replicas"][0])
        assert json.loads(_get(turl + "/driftz")[1]) == json.loads(_get(jurl + "/driftz")[1])
        assert fclient.try_deregister(jurl, tsrv.url().rstrip("/"), timeout_s=HTTP_TIMEOUT_S)
        assert jclient.try_deregister(turl, jsrv.url().rstrip("/"), timeout_s=HTTP_TIMEOUT_S)
    finally:
        trouter.stop()
        jrouter.stop()
        for gw, srv in ((jgw, jsrv), (tgw, tsrv)):
            gw.close(timeout=WAIT_S)
            srv.stop()


# -- the entries --------------------------------------------------------------


def _start(argv, code=None):
    """A subprocess whose first JSON stdout line is ``{"listening": ...}``:
    returns (process, that line)."""
    cmd = [sys.executable] + (["-c", code] if code else ["-m", "keystone_tpu_torch"] + argv)
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            text=True)
    first = [None]

    def read():
        for line in proc.stdout:
            if line.startswith("{") and "listening" in line:
                first[0] = json.loads(line)
                return

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    reader.join(60)
    if first[0] is None:
        proc.kill()
        proc.wait(10)
        raise AssertionError("no listening line within 60 s")
    return proc, first[0]


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
        proc.wait(10)


def test_serve_router_and_a_registering_replica_in_subprocesses():
    router, line = _start(["serve-router", "--router-port", "0", "--probe-interval", "0.2"])
    replica = None
    try:
        assert line["role"] == "router" and line["replicas"] == []
        url = line["listening"]
        code = ("from keystone_tpu_torch.gateway.http import main; import sys; "
                "sys.exit(main(['--gateway-port', '0', '--d', '8', '--hidden', '8', '--depth', "
                f"'2', '--buckets', '4', '--lanes', '1', '--register', '{url}'], device='cpu'))")
        replica, rline = _start(None, code=code)
        rurl = rline["listening"]
        _wait(lambda: [r["url"] for r in json.loads(_get(url + "/fleetz")[1])["replicas"]] == [rurl],
              "the replica's registration", timeout=30)
        c, doc, headers = _post(url + "/predict", {"instances": [[0.25] * D]})
        assert c == 200 and len(doc["predictions"][0]) == D and headers.get("X-Keystone-Trace")
        # SIGTERM: the replica leaves the roster, drains, exits 0
        replica.send_signal(signal.SIGTERM)
        assert replica.wait(timeout=30) == 0
        assert json.loads(_get(url + "/fleetz")[1])["replicas"] == []
        router.send_signal(signal.SIGTERM)
        assert router.wait(timeout=30) == 0
    finally:
        for p in (replica, router):
            if p is not None:
                _stop(p)


def test_the_router_starts_no_cuda_and_loads_no_jax():
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
import torch
from keystone_tpu_torch.fleet.router import RouterServer
from keystone_tpu_torch.observability import enable_tracing
enable_tracing()
srv = RouterServer(probe_interval_s=0.1).start()
srv.stop()
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "keystone_tpu"))
print("BAD", bad, "CUDA", torch.cuda.is_initialized())
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert "BAD [] CUDA False" in out.stdout, out.stdout
