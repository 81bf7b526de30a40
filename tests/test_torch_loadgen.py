"""The load generator of ``keystone_tpu_torch`` on the CPU, held against
the JAX package's: request logs written by both gateways parse and
collapse to equal replay events in both packages; synthetic workloads
(every arrival law, step ramps, size mixtures, deadline jitter) and
their summaries are equal per seed; one hand-built report gets equal
verdicts from both checkers, green and red; the open-loop runner drives
the port's ``Gateway`` in-process (with and without a lane killed
mid-run) and over HTTP, and JAX's runner drives the port's server with
the same verdict; ``serve-loadgen --self-gateway`` prints a green
verdict. Every HTTP call, future and join has its own timeout."""

import dataclasses
import json
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.gateway import Gateway as JGateway
from keystone_tpu.gateway import GatewayServer as JGatewayServer
from keystone_tpu.loadgen import faults as jfaults
from keystone_tpu.loadgen import invariants as jinv
from keystone_tpu.loadgen import runner as jrunner
from keystone_tpu.loadgen import trace as jtrace
from keystone_tpu.serving import bench as jbench
from keystone_tpu_torch.gateway import Gateway, GatewayServer
from keystone_tpu_torch.loadgen import cli as tcli
from keystone_tpu_torch.loadgen import faults
from keystone_tpu_torch.loadgen import invariants as tinv
from keystone_tpu_torch.loadgen import runner as trunner
from keystone_tpu_torch.loadgen import trace as ttrace
from keystone_tpu_torch.serving import bench as tbench

D = 8
HTTP_TIMEOUT_S = 10


@pytest.fixture(autouse=True)
def no_faults():
    faults.disarm_all()
    jfaults.disarm_all()
    yield
    faults.disarm_all()
    jfaults.disarm_all()


def _events(evs):
    """Replay-relevant view of a trace: what the replayer reissues."""
    return [(e.n_rows, e.shape, e.deadline_ms, e.status, e.model) for e in evs]


def _post(url, doc):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


@pytest.fixture(scope="module")
def tgateway():
    gw = Gateway(tbench.build_pipeline(d=D, hidden=D, depth=2, device="cpu"), buckets=(4, 16),
                 n_lanes=2, warmup_example=torch.zeros(D), device="cpu", name="t-loadgen")
    yield gw
    gw.close()


@pytest.fixture(scope="module")
def jgateway():
    gw = JGateway(jbench.build_pipeline(d=D, hidden=D, depth=2), buckets=(4, 16), n_lanes=2,
                  warmup_example=jnp.zeros((D,), jnp.float32), name="j-loadgen")
    yield gw
    gw.close()


# -- traces ----------------------------------------------------------------------


def test_request_logs_of_both_gateways_parse_alike(tgateway, jgateway, tmp_path):
    """The same POSTs (several instances, deadlines, a malformed one)
    through the port's and JAX's servers write request logs that both
    packages parse, collapse and load into equal replay events."""
    logs = {"port": str(tmp_path / "port.jsonl"), "jax": str(tmp_path / "jax.jsonl")}
    rng = np.random.default_rng(0)
    posts = [{"instances": rng.standard_normal((n, D)).tolist(), **({"deadline_ms": dl} if dl else {})}
             for n, dl in ((1, None), (3, 500.0), (2, None), (1, 250.0))]
    servers = {"port": GatewayServer(tgateway, request_log=logs["port"]).start(),
               "jax": JGatewayServer(jgateway, request_log=logs["jax"]).start()}
    try:
        for side, srv in servers.items():
            for doc in posts:
                assert _post(srv.url().rstrip("/") + "/predict", doc) == 200
            assert _post(srv.url().rstrip("/") + "/predict",
                         {"instances": [[1.0] * D], "deadline_ms": -1}) == 400
    finally:
        for srv in servers.values():
            srv.stop()
    parsed = {}
    for side, path in logs.items():
        lines = open(path).read().splitlines()
        assert len(lines) == 7, lines  # one line per served instance
        for pkg, mod in (("port", ttrace), ("jax", jtrace)):
            events = mod.parse_request_log(lines)
            parsed[side, pkg] = (
                _events(events), _events(mod.collapse_posts(events)),
                _events(mod.load_trace(path)), _events(mod.load_trace(path, collapse=False)),
                [e.ts for e in mod.load_trace(path)],
            )
        assert parsed[side, "port"] == parsed[side, "jax"], side
    assert parsed["port", "port"][:4] == parsed["jax", "port"][:4]
    assert parsed["port", "port"][1] == [(n, (D,), p.get("deadline_ms"), 200, None)
                                         for n, p in zip((1, 3, 2, 1), posts)]


@pytest.mark.parametrize("arrivals", ttrace.ARRIVALS)
def test_synthetic_workloads_equal_jax(arrivals):
    assert ttrace.ARRIVALS == jtrace.ARRIVALS
    kw = dict(arrivals=arrivals, rate=250.0, size_mix=((1, 0.7), (4, 0.2), (16, 0.1)), shape=(3, 5),
              deadline_ms=80.0, deadline_sigma=0.4, sigma=1.2, alpha=1.7, seed=11)
    got, want = ttrace.synthesize(300, **kw), jtrace.synthesize(300, **kw)
    assert [dataclasses.asdict(e) for e in got] == [dataclasses.asdict(e) for e in want]
    assert ttrace.summarize(got) == jtrace.summarize(want)
    kw.pop("rate")
    steps = ttrace.parse_steps("5:4,40:2,0:1,8:3")
    assert steps == jtrace.parse_steps("5:4,40:2,0:1,8:3")
    got, want = ttrace.synthesize_steps(steps, **kw), jtrace.synthesize_steps(steps, **kw)
    assert [dataclasses.asdict(e) for e in got] == [dataclasses.asdict(e) for e in want]
    assert ttrace.summarize(got) == jtrace.summarize(want)
    assert ttrace.summarize([]) == jtrace.summarize([]) == {"requests": 0}
    assert ttrace.parse_size_mix("1:0.8,4:0.2") == jtrace.parse_size_mix("1:0.8,4:0.2")
    for bad in (lambda m: m.synthesize(0), lambda m: m.synthesize(5, rate=0),
                lambda m: m.synthesize(5, arrivals="pareto", alpha=1.0),
                lambda m: m.synthesize_steps([(1e9, 10.0)]), lambda m: m.parse_steps("5")):
        with pytest.raises(ValueError):
            bad(ttrace)
        with pytest.raises(ValueError):
            bad(jtrace)


# -- invariants ------------------------------------------------------------------


def _report(mod, scenario):
    """One hand-built report in ``mod``'s classes: steady traffic with
    a fault window, dressed per scenario."""
    rep = mod.LoadReport()
    recs = [mod.RequestRecord(i, 0.1 * i, 0.1 * i, "ok", latency_s=0.01 + 0.0001 * (i % 7),
                              trace_id=f"t{i}") for i in range(80)]
    fault = mod.FaultWindow(point="gateway.lane.kill", t_arm=2.0, t_clear=3.0)
    rep.ready_recovery_s = 0.4
    if scenario == "shed":
        for r in recs[20:60]:
            r.status, r.reason, r.code = "shed", "queue_full", 429
    elif scenario == "failed":
        recs[30].status, recs[30].untyped, recs[30].code, recs[30].reason = "error", True, 500, "boom"
        recs[31].status, recs[31].latency_s, recs[31].reason = "lost", None, "timeout"
    elif scenario == "unrecovered":
        for r in recs[30:]:
            r.latency_s = 2.0
        rep.ready_recovery_s = None
    for r in recs:
        rep.add(r)
    rep.issued = len(recs) + (1 if scenario == "failed" else 0)
    rep.duration_s = 9.0
    rep.fault_windows.append(fault)
    rep.ready_probed = True
    return rep


@pytest.mark.parametrize("scenario", ["green", "shed", "failed", "unrecovered"])
def test_checkers_give_equal_verdicts(scenario):
    kw = dict(p99_factor=2.0, recovery_within_s=4.0, max_shed_rate=0.2, max_p99_s=1.0)
    got = tinv.InvariantChecker(**kw).check(_report(trunner, scenario))
    want = jinv.InvariantChecker(**kw).check(_report(jrunner, scenario))
    assert got.as_dict() == want.as_dict()
    assert got.passed == (scenario == "green"), got.to_json()
    assert got.to_json() == want.to_json()


# -- the runner --------------------------------------------------------------------


# the verdict's invariants that do not read the clock
UNTIMED = ("every_admitted_request_resolves", "failures_are_typed_sheds_only",
           "readiness_recovers_after_fault")


def _synthetic(n, rate, seed=0):
    return ttrace.synthesize(n, rate=rate, shape=(D,), seed=seed)


@pytest.mark.parametrize("killed", [False, True])
def test_inproc_runner_over_the_port_gateway(tgateway, killed):
    """Open loop into the port's ``Gateway``; a lane killed mid-run is
    absorbed by the pool's retry: every request resolves, no untyped
    failure, readiness recovers and the fault fired (the p99 invariant,
    which times a loaded CPU, is held on the card by chip_smoke.py's phase 16a)."""
    target = trunner.InprocTarget(tgateway, default_shape=(D,))
    plans = [trunner.FaultPlan({"point": "gateway.lane.kill", "match": {"lane": 0}}, at_s=0.3, for_s=0.4)] if (
        killed) else []
    fired0 = target.fired_count("gateway.lane.kill")
    report = trunner.LoadGenerator(target, max_outstanding=32).run(
        _synthetic(120, 150.0), faults=plans, recovery_probe_s=2.0, settle_s=0.5 if killed else 0.0)
    verdict = tinv.InvariantChecker().check(report)
    held = {r.name: r.passed for r in verdict.invariants if r.name in UNTIMED}
    assert held == dict.fromkeys(UNTIMED[: 3 if killed else 2], True), verdict.to_json()
    assert report.by_status() == {"ok": 120} and report.issued == 120
    if killed:
        assert target.fired_count("gateway.lane.kill") > fired0
        assert [w.point for w in report.fault_windows] == ["gateway.lane.kill"]
        assert report.ready_recovery_s is not None


def test_http_runner_and_jax_runner_against_the_port_server():
    """The port's ``HttpTarget`` and JAX's against one port server: the
    wire format is shared, so records and verdicts agree; a lane kill
    armed over ``POST /chaosz`` fires in the server (each run kills the
    lane the other left healthy: a killed lane sits out its cool-down)."""
    gw = Gateway(tbench.build_pipeline(d=D, hidden=D, depth=2, device="cpu"), buckets=(4, 16),
                 n_lanes=2, warmup_example=torch.zeros(D), device="cpu", name="t-loadgen-http")
    srv = GatewayServer(gw).start()
    url = srv.url().rstrip("/")
    try:
        out = {}
        for side, mod, inv, lane in (("port", trunner, tinv, 0), ("jax", jrunner, jinv, 1)):
            target = mod.HttpTarget(url, default_shape=(D,))
            assert target.ready()
            events = [jtrace.TraceEvent(**dataclasses.asdict(e)) for e in _synthetic(60, 120.0)] if (
                side == "jax") else _synthetic(60, 120.0)
            plan = mod.FaultPlan({"point": "gateway.lane.kill", "match": {"lane": lane}}, at_s=0.2,
                                 for_s=0.2)
            before = target.fired_count("gateway.lane.kill")
            report = mod.LoadGenerator(target, max_outstanding=16).run(
                events, faults=[plan], recovery_probe_s=2.0, settle_s=0.3)
            assert target.fired_count("gateway.lane.kill") > before, side
            verdict = inv.InvariantChecker().check(report)
            out[side] = ({r.name: r.passed for r in verdict.invariants if r.name in UNTIMED},
                         len(report.records), report.by_status(),
                         [i.name for i in verdict.invariants])
        assert out["port"] == out["jax"] == (
            dict.fromkeys(UNTIMED, True), 60, {"ok": 60},
            ["every_admitted_request_resolves", "failures_are_typed_sheds_only",
             "readiness_recovers_after_fault", "p99_recovers_after_fault"])
        # a typed shed and an untyped failure classify alike
        target = trunner.HttpTarget(url + "/nope", default_shape=(D,))
        rec = target.send(ttrace.TraceEvent(ts=0.0))
        assert (rec.status, rec.code, rec.untyped) == ("error", 404, True)
    finally:
        srv.stop()
        gw.close()


def test_feedback_sender_samples_evenly_and_drops_newest():
    """The label side channel: ``fraction`` of offers, evenly spaced,
    through a bounded queue (a server that is not there only counts
    errors)."""
    got = {}
    for side, mod in (("port", trunner), ("jax", jrunner)):
        fb = mod.FeedbackSender("http://127.0.0.1:9", lambda xs: xs, fraction=0.25, max_queue=2,
                                timeout_s=0.5)
        for i in range(16):
            fb.offer(np.full((1, D), i, np.float32))
        got[side] = fb.close(timeout=10.0)
    assert got["port"]["sent"] == 0 and sum(got["port"].values()) == 4
    with pytest.raises(ValueError):
        trunner.FeedbackSender("http://x", None, fraction=1.5)


def test_feedback_sender_posts_what_is_queued_as_one_batch():
    """Rows queued while the thread labels are labeled and POSTed
    together on its next wake, each row once, with its own label."""
    import http.server
    import threading

    posts, gate = [], threading.Event()

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            posts.append(json.loads(self.rfile.read(int(self.headers["Content-Length"]))))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *args):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()

    def labeler(xs):
        gate.wait(HTTP_TIMEOUT_S)  # the first batch holds the thread
        return xs * 2.0

    try:
        fb = trunner.FeedbackSender(f"http://127.0.0.1:{srv.server_port}", labeler,
                                    fraction=1.0, timeout_s=HTTP_TIMEOUT_S)
        fb.offer(np.full((1, D), 0, np.float32))
        deadline = time.perf_counter() + HTTP_TIMEOUT_S
        while fb._q.qsize() and time.perf_counter() < deadline:
            time.sleep(0.01)  # the thread took the first row
        for i in range(1, 8):
            fb.offer(np.full((1, D), i, np.float32))
        gate.set()
        assert fb.close(timeout=HTTP_TIMEOUT_S) == {"sent": 8, "dropped": 0, "errors": 0}
    finally:
        srv.shutdown()
        srv.server_close()
    assert [len(p["instances"]) for p in posts] == [1, 7]
    rows = np.concatenate([np.asarray(p["instances"]) for p in posts])
    labels = np.concatenate([np.asarray(p["labels"]) for p in posts])
    assert np.array_equal(rows[:, 0], np.arange(8)) and np.array_equal(labels, rows * 2.0)


def test_serve_loadgen_self_gateway_prints_a_green_verdict(capsys):
    assert tcli.main(["--self-gateway", "--synthetic", "50", "--d", "16", "--rate", "200",
                      "--buckets", "4,16"], device="cpu") == 0
    out = capsys.readouterr().out
    first = json.loads(out.splitlines()[0])
    assert first["workload"]["requests"] == 50
    verdict = json.loads(out[out.index("\n") + 1:])
    assert verdict["passed"] is True and verdict["stats"]["by_status"] == {"ok": 50}
    with pytest.raises(SystemExit):
        tcli.main(["--synthetic", "5"], device="cpu")  # no target
    with pytest.raises(SystemExit):
        tcli.main(["--self-gateway", "--synthetic", "5", "--feedback-fraction", "0.5"], device="cpu")
    assert tcli._parse_teacher("hidden=8,depth=2,head_seed=7") == {"hidden": 8, "depth": 2,
                                                                  "head_seed": 7}


def test_loadgen_cli_parser_takes_every_jax_flag():
    """Every flag of JAX's ``serve-loadgen``, and the port's two payload
    flags (uint8 raw images for a ``--device-featurize`` gateway): the
    instances' dtype and shape, which synthesized events carry."""
    from keystone_tpu.loadgen import cli as jcli

    def flags(parser):
        return sorted(s for a in parser._actions for s in a.option_strings)

    port_only = ["--payload-dtype", "--payload-shape"]
    assert flags(tcli.build_parser()) == sorted(flags(jcli.build_parser()) + port_only)
    args = tcli.build_parser().parse_args(["--ramp", "4:1", "--payload-shape", "5,5,3",
                                           "--payload-dtype", "uint8"])
    events = tcli.build_workload(args)
    assert events and all(tuple(e.shape) == (5, 5, 3) for e in events)
    from keystone_tpu_torch.loadgen.runner import _payload_for

    xs = _payload_for(events[0], (9,), np.uint8)
    assert xs.dtype == np.uint8 and xs.shape == (events[0].n_rows, 5, 5, 3) and xs.max() > 0
    assert _payload_for(events[0], (9,)).dtype == np.float32
