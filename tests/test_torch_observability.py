"""The observability plane and the fault injector of ``keystone_tpu_torch``
on the CPU, held against the JAX package's modules on the same inputs:
Prometheus rendering, content negotiation, parsing, merging and quantiles
(equal strings and values), SLO burn rates under one scripted clock,
flight-recorder captures, ``parse_fault_spec``/``arm_from_env`` and the
trigger points, the device-info gauge and the memory sampler (host RAM on
the CPU), ``/profilez`` and the admin endpoint; the fleet's and the
zoo's observability — OTLP span encoding and export, the stitcher's
phase decomposition and stitched documents, the attribution ledger and
drift detection — on the same span records, charges, claims and
histograms. Every HTTP call has its own timeout of a few seconds."""

import json
import re
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import http.server
import threading

from keystone_tpu.loadgen import faults as jfaults
from keystone_tpu.observability import attribution as jattr
from keystone_tpu.observability import drift as jdrift
from keystone_tpu.observability import otlp as jotlp
from keystone_tpu.observability import stitch as jstitch
from keystone_tpu.observability import device as jdevice
from keystone_tpu.observability import flight as jflight
from keystone_tpu.observability import profilez as jprofilez
from keystone_tpu.observability import prometheus as jprom
from keystone_tpu.observability import registry as jregistry
from keystone_tpu.observability import slo as jslo
from keystone_tpu.observability import tracing as jtracing
from keystone_tpu_torch.loadgen import faults as tfaults
from keystone_tpu_torch.observability import admin as tadmin
from keystone_tpu_torch.observability import attribution as tattr
from keystone_tpu_torch.observability import drift as tdrift
from keystone_tpu_torch.observability import otlp as totlp
from keystone_tpu_torch.observability import stitch as tstitch
from keystone_tpu_torch.observability import device as tdevice
from keystone_tpu_torch.observability import flight as tflight
from keystone_tpu_torch.observability import profilez as tprofilez
from keystone_tpu_torch.observability import prometheus as tprom
from keystone_tpu_torch.observability import registry as tregistry
from keystone_tpu_torch.observability import slo as tslo
from keystone_tpu_torch.observability import tracing as ttracing

HTTP_TIMEOUT_S = 5

PKGS = {
    "jax": dict(prom=jprom, registry=jregistry, slo=jslo, flight=jflight, tracing=jtracing,
                faults=jfaults, device=jdevice, otlp=jotlp, stitch=jstitch, attr=jattr,
                drift=jdrift),
    "torch": dict(prom=tprom, registry=tregistry, slo=tslo, flight=tflight, tracing=ttracing,
                  faults=tfaults, device=tdevice, otlp=totlp, stitch=tstitch, attr=tattr,
                  drift=tdrift),
}


def both(fn):
    """``fn(modules)`` run on the JAX package's modules and the port's;
    returns (jax result, torch result)."""
    return fn(PKGS["jax"]), fn(PKGS["torch"])


def _no_exemplar_times(text):
    """An exposition with its exemplars' wall-clock timestamps taken out."""
    return re.sub(r"(# \{[^}]*\} \S+) \S+", r"\1", text)


def _populated_registry(m):
    """One registry of every family kind, filled the same way."""
    reg = m["registry"].MetricsRegistry()
    c = reg.counter("keystone_req_total", "requests by status", ("gateway", "status"))
    c.inc(("g", "ok"), 3)
    c.inc(("g", 'e"r\\r\nx'))
    reg.gauge("keystone_depth", "queue depth").set(7.5)
    h = reg.histogram("keystone_latency_seconds", "latency", ("gateway",),
                      buckets=(0.005, 0.05, 0.5, 5.0))
    for i, v in enumerate((0.001, 0.004, 0.03, 0.2, 0.7, 9.0)):
        h.observe(v, ("g",), trace_id=f"{i:032x}")
    reg.gauge_func("keystone_info", lambda: {("a", "b"): 1.0}, "info", ("k1", "k2"))
    return reg


# -- prometheus --------------------------------------------------------------


@pytest.mark.parametrize("openmetrics", [False, True])
def test_render_equals_jax(openmetrics):
    want, got = both(lambda m: _no_exemplar_times(
        m["prom"].render(_populated_registry(m).collect(), openmetrics=openmetrics)))
    assert got == want
    assert got.endswith("# EOF\n") == openmetrics
    assert ('# {trace_id="' in got) == openmetrics


@pytest.mark.parametrize("accept", [None, "text/plain",
                                    "application/openmetrics-text; version=1.0.0"])
def test_negotiate_render_equals_jax(accept):
    def run(m):
        body, ctype = m["prom"].negotiate_render(_populated_registry(m).collect(), accept)
        return _no_exemplar_times(body), ctype

    want, got = both(run)
    assert got == want
    assert got[1] == (tprom.OPENMETRICS_CONTENT_TYPE if accept and "openmetrics" in accept
                      else tprom.CONTENT_TYPE)


def test_parse_histogram_buckets_and_quantiles_equal_jax():
    def run(m):
        text = m["prom"].render(_populated_registry(m).collect(), openmetrics=True)
        samples = m["prom"].parse_samples(text)
        buckets = m["prom"].histogram_buckets(text, "keystone_latency_seconds", {"gateway": "g"})
        qs = [m["prom"].quantile_from_buckets(q, buckets) for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0)]
        return samples, buckets, qs

    want, got = both(run)
    assert got == want
    assert got[1][-1] == (float("inf"), 6.0)
    assert tprom.quantile_from_buckets(0.5, []) is None


def test_merge_histograms_and_expositions_equal_jax():
    def run(m):
        texts = []
        for k in range(3):
            reg = m["registry"].MetricsRegistry()
            h = reg.histogram("keystone_latency_seconds", "latency", ("gateway",),
                              buckets=(0.01, 0.1, 1.0))
            for v in np.random.default_rng(k).exponential(0.2, 40):
                h.observe(float(v), ("g",))
            reg.counter("keystone_req_total", "requests", ("status",)).inc(("ok",), k + 1)
            reg.gauge("keystone_depth", "queue depth").set(float(k))
            texts.append(m["prom"].render(reg.collect()))
        merged = m["prom"].merge_histograms(
            [m["prom"].histogram_buckets(t, "keystone_latency_seconds") for t in texts])
        return merged, m["prom"].merge_expositions(texts)

    want, got = both(run)
    assert got == want
    assert got[0][-1][1] == 120.0


# -- SLO burn rates under a scripted clock -----------------------------------


def _burn_script(m):
    """Two SLOs over hand-cranked counters and a histogram, sampled at
    scripted times: the burn rates, breach verdicts and /slz rows."""
    reg = m["registry"].MetricsRegistry()
    state = {"total": 0.0, "bad": 0.0}
    counting = m["slo"].Slo("api", 0.99, lambda: (state["total"], state["bad"]))
    hist = reg.histogram("keystone_lat_seconds", "latency", ("gateway",),
                         buckets=(0.01, 0.1, 1.0))
    latency = m["slo"].Slo.latency("lat", hist, threshold_s=0.1, target=0.9, labels=("g",))
    mon = m["slo"].SloMonitor(fast_window_s=10, slow_window_s=100, registry=reg)
    mon.add(counting)
    mon.add(latency)
    out = []
    script = [(0.0, 0, 0, ()), (10.0, 100, 2, (0.05, 0.5)), (20.0, 200, 2, (0.05,) * 8),
              (60.0, 300, 40, (2.0,) * 3), (130.0, 400, 40, ())]
    for now, total, bad, lats in script:
        state["total"], state["bad"] = float(total), float(bad)
        for v in lats:
            hist.observe(v, ("g",))
        mon.sample(now=now)
        out.append({name: (mon.burn_rates(name), mon.breaching(name)) for name in ("api", "lat")})
    status = mon.status()
    return out, [{k: v for k, v in row.items() if k != "monitor"} for row in status["slos"]]


def test_slo_burn_rates_equal_jax_under_a_scripted_clock():
    want, got = both(_burn_script)
    assert got == want
    assert got[0][1]["api"][0]["fast"] == pytest.approx(2.0)


# -- flight recorder -----------------------------------------------------------


def _flight_script(m):
    tr = m["tracing"].Tracer()
    rec = m["flight"].FlightRecorder(capacity=2, latency_threshold_s=0.1, tracer=tr,
                                     registry=m["registry"].MetricsRegistry())
    out = []
    for dur, err in ((0.5, None), (0.01, None), (0.001, RuntimeError("lane exploded")), (0.2, None)):
        with tr.span("gateway.admit", gateway="t") as admit:
            with tr.span("microbatch.coalesce", window=1):
                with tr.span("serving.dispatch", bucket=4):
                    pass
        r = rec.maybe_capture(admit.trace_id, duration_s=dur, error=err)
        out.append(None if r is None else (r.reason, sorted(s.name for s in r.spans),
                                           {k: v for k, v in r.attrs.items() if k != "error"},
                                           "error" in r.attrs))
    return out, [r.reason for r in rec.records()]


def test_flight_captures_equal_jax():
    want, got = both(_flight_script)
    assert got == want
    assert got[1] == ["error", "slo_breach"]  # the ring keeps the newest two


# -- faults ------------------------------------------------------------------


@pytest.mark.parametrize("clause", [
    "pipeline.host_prep.stall=delay_ms:50",
    "gateway.lane.kill=lane:0,count:8",
    "engine.dispatch.error=engine:lane-a,for_s:2.5",
    "gateway.swap.force",
    " gateway.lane.kill=lane:x ",
])
def test_parse_fault_spec_equals_jax(clause):
    assert tfaults.parse_fault_spec(clause) == jfaults.parse_fault_spec(clause)


@pytest.mark.parametrize("bad", ["", "a=count", "a=:1", "a=count:x"])
def test_parse_fault_spec_rejects_what_jax_rejects(bad):
    for mod in (jfaults, tfaults):
        with pytest.raises(ValueError):
            mod.parse_fault_spec(bad)


def test_arm_from_env_arms_each_clause_as_jax():
    env = {"KEYSTONE_FAULTS": "pipeline.host_prep.stall=delay_ms:50 "
                              "gateway.lane.kill=lane:0,count:8"}
    try:
        want, got = both(lambda m: [dataclass_fields(s) for s in m["faults"].arm_from_env(env)])
        assert got == want and [s["point"] for s in got] == [
            "pipeline.host_prep.stall", "gateway.lane.kill"]
        assert sorted(tfaults.get_injector().status()["armed"]) == [
            "gateway.lane.kill", "pipeline.host_prep.stall"]
        assert tfaults.arm_from_env({}) == [] == jfaults.arm_from_env({})
    finally:
        tfaults.disarm_all()
        jfaults.disarm_all()


def dataclass_fields(spec):
    """A FaultSpec's fields but its arming time."""
    return {k: v for k, v in vars(spec).items() if k not in ("armed_t", "fired")}


def test_trigger_runs_on_arm_and_unregister_stops_it():
    inj = tfaults.FaultInjector(registry=tregistry.MetricsRegistry())
    fired = []
    unregister = inj.register_trigger("gateway.swap.force", fired.append, ctx={"gateway": "a"})
    inj.arm("gateway.swap.force", match={"gateway": "b"})  # matches no registration
    assert not inj.armed
    inj.arm("gateway.swap.force", match={"gateway": "a"})
    deadline = time.time() + 5
    while not fired and time.time() < deadline:
        time.sleep(0.01)
    assert len(fired) == 1 and fired[0].point == "gateway.swap.force"
    deadline = time.time() + 5
    while inj.armed and time.time() < deadline:  # one-shot: disarms itself
        time.sleep(0.01)
    assert not inj.armed
    unregister()
    inj.arm("gateway.swap.force")
    assert not inj.armed and len(fired) == 1


def test_fault_catalog_is_the_wired_points():
    assert set(tfaults.FAULT_POINTS) == {
        "gateway.lane.kill", "pipeline.host_prep.stall", "engine.dispatch.error",
        "gateway.swap.force", "otlp.export.blackhole", "router.replica.blackhole",
        "router.replica.partition", "router.trace.drop", "lifecycle.refit.poison"}
    assert set(tfaults.FAULT_POINTS) == set(jfaults.FAULT_POINTS)
    for point in ("otlp.export.blackhole", "router.replica.blackhole",
                  "router.replica.partition", "router.trace.drop", "lifecycle.refit.poison"):
        assert tfaults.FAULT_POINTS[point] == jfaults.FAULT_POINTS[point]


# -- device ------------------------------------------------------------------


def test_device_info_gauge_and_host_memory_sampler_on_the_cpu():
    reg = tregistry.MetricsRegistry()
    tdevice.register_device_metrics(reg)
    sampler = tdevice.DeviceMemorySampler(registry=reg)
    assert sampler.sample_once() == 0  # the CPU reports no device stats
    text = tprom.render(reg.collect())
    assert 'keystone_device_info{kind="cpu",platform="cpu",count="1",peak_flops="unknown"} 1' in text
    for stat in ("in_use", "peak", "limit"):
        assert f'keystone_device_memory_bytes{{device="host",kind="host-ram",stat="{stat}"}}' in text
    assert tdevice.DeviceMemorySampler(registry=tregistry.MetricsRegistry(),
                                       devices=[]).sample_once() == 0


def test_memory_sampler_refcounts_and_tightest_interval():
    reg = tregistry.MetricsRegistry()
    a = tdevice.acquire_memory_sampler(reg, interval_s=10.0)
    b = tdevice.acquire_memory_sampler(reg, interval_s=2.0)
    try:
        assert a is b and a.interval_s == 2.0 and a._thread is not None
        tdevice.release_memory_sampler(a)
        assert b._thread is not None
    finally:
        tdevice.release_memory_sampler(b)
    assert b._thread is None


def test_chip_hbm_bytes_env_and_cpu(monkeypatch):
    monkeypatch.setenv("KEYSTONE_CHIP_HBM_BYTES", "8e9")
    assert tdevice.chip_hbm_bytes() == jdevice.chip_hbm_bytes() == 8_000_000_000
    monkeypatch.delenv("KEYSTONE_CHIP_HBM_BYTES")
    tdevice.reset_device_table()
    assert tdevice.chip_hbm_bytes() is None


# -- profilez ----------------------------------------------------------------


@pytest.mark.parametrize("seconds", ["abc", "0", "-1", "61"])
def test_profilez_bad_seconds_is_400_as_jax(seconds, tmp_path):
    want = jprofilez.profilez_document(seconds, base_dir=str(tmp_path / "j"))
    got = tprofilez.profilez_document(seconds, base_dir=str(tmp_path / "t"))
    assert got[0] == want[0] == 400 and got[1]["error"] == want[1]["error"]


def test_profilez_capture_writes_a_chrome_trace_and_is_409_while_busy(tmp_path):
    assert tprofilez._capture_lock.acquire(blocking=False)
    try:
        code, doc = tprofilez.profilez_document("0.05", base_dir=str(tmp_path))
        assert code == 409 and doc["error"] == "capture_in_progress"
    finally:
        tprofilez._capture_lock.release()
    code, doc = tprofilez.profilez_document("0.05", base_dir=str(tmp_path))
    assert code == 200 and doc["file_count"] == 1
    with open(f"{doc['trace_dir']}/{doc['files'][0]}") as f:
        assert "traceEvents" in json.load(f)


# -- the admin endpoint --------------------------------------------------------


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=HTTP_TIMEOUT_S) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def test_admin_endpoint_routes():
    reg = tregistry.MetricsRegistry()
    reg.counter("keystone_x_total", "x").inc(by=2)
    server = tadmin.AdminServer(port=0, registry=reg).start()
    try:
        assert _get(server.url("/healthz"))[::2] == (200, b"ok\n")
        code, ctype, body = _get(server.url("/metrics"))
        assert code == 200 and ctype == tprom.CONTENT_TYPE
        text = body.decode()
        for family in ("keystone_x_total", "keystone_build_info", "keystone_device_info",
                       "keystone_device_memory_bytes", "keystone_process_start_time_seconds"):
            assert f"# TYPE {family} " in text, family
        code, _, body = _get(server.url("/varz"))
        build = json.loads(body)["build"]
        assert code == 200 and build["torch_version"] and build["device_kind"] is None
        assert build["devices"][0]["platform"] == "cpu"
        for route in ("/tracez", "/slz", "/debugz"):
            assert _get(server.url(route))[0] == 200, route
        assert _get(server.url("/profilez?seconds=x"))[0] == 400
        assert _get(server.url("/attributionz"))[0] == 404
    finally:
        server.stop()


# -- OTLP: the same span records encode to the same wire documents ------------


def _span_records(m):
    """Finished spans of every attribute kind, with and without a parent
    and a trace id, as the package's own ``Span``."""
    Span = m["tracing"].Span
    return [
        Span("gateway.admit", 7, None, 1_700_000_000.125, 0.0031, 11,
             {"gateway": "g", "rows": 3, "ok": True, "share": 0.25},
             trace_id="0af7651916cd43dd8448eb211c80319c"),
        Span("serving.dispatch", 9, 7, 1_700_000_000.2, 0.012, 12,
             {"bucket": 64}, trace_id="0af7651916cd43dd8448eb211c80319c"),
        Span("orphan", 2**64 + 5, None, 1_699_999_999.5, 0.5, 13, {}),
    ]


def test_span_to_otlp_and_encode_spans_equal_jax():
    def run(m):
        spans = _span_records(m)
        body = m["otlp"].encode_spans(spans, "keystone-gateway",
                                      resource_attrs={"replica": "127.0.0.1:8001"})
        scope = body["resourceSpans"][0]["scopeSpans"][0].pop("scope")
        return [m["otlp"].span_to_otlp(s) for s in spans], body, scope

    (jspans, jbody, jscope), (tspans, tbody, tscope) = both(run)
    assert tspans == jspans and tbody == jbody
    # the instrumentation scope names each package
    assert jscope == {"name": "keystone_tpu.observability"}
    assert tscope == {"name": "keystone_tpu_torch.observability"}
    assert tspans[0]["startTimeUnixNano"] == str(int(1_700_000_000.125 * 1e9))
    assert tspans[2]["traceId"] == "f" * 32 and tspans[2]["spanId"] == "0000000000000005"


class _Collector:
    """A stdlib OTLP/HTTP collector on an ephemeral port: every POST body
    to ``/v1/traces`` is kept."""

    def __init__(self):
        bodies = self.bodies = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802
                n = int(self.headers.get("Content-Length", 0))
                bodies.append((self.path, json.loads(self.rfile.read(n))))
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_otlp_exporter_batches_spans_to_a_collector_and_counts_a_blackhole():
    collector = _Collector()
    reg = tregistry.MetricsRegistry()
    tracer = ttracing.Tracer()
    exporter = totlp.OtlpSpanExporter(collector.url, service_name="keystone-router",
                                      resource_attrs={"replica": "r1"}, batch_size=2,
                                      flush_interval_s=0.05, registry=reg).install(tracer)
    try:
        for i in range(5):
            with tracer.span("router.forward", attempt=i):
                pass
        assert exporter.flush(timeout_s=HTTP_TIMEOUT_S)
        paths = {p for p, _ in collector.bodies}
        assert paths == {"/v1/traces"}
        names = [s["name"] for _, b in collector.bodies
                 for s in b["resourceSpans"][0]["scopeSpans"][0]["spans"]]
        assert names == ["router.forward"] * 5
        attrs = collector.bodies[0][1]["resourceSpans"][0]["resource"]["attributes"]
        assert {"key": "service.name", "value": {"stringValue": "keystone-router"}} in attrs
        assert {"key": "replica", "value": {"stringValue": "r1"}} in attrs
        tfaults.arm("otlp.export.blackhole", count=1)
        with tracer.span("dropped"):
            pass
        assert exporter.flush(timeout_s=HTTP_TIMEOUT_S)
        text = tprom.render(reg.collect())
        assert 'keystone_otlp_spans_total{result="exported"} 5' in text
        assert 'keystone_otlp_posts_total{result="blackhole"} 1' in text
    finally:
        tfaults.disarm_all()
        exporter.shutdown()
        collector.close()


# -- the stitcher: phase decomposition and stitched documents -------------------


def _stitch_spans(staged):
    """One routed request's span dicts: the router's two forward attempts
    (the first failed over) and the winning replica's admit → coalesce →
    dispatch chain (serial lanes) or stage spans (staged lanes)."""
    t = 1_700_000_000.0

    def sp(name, sid, parent, start, ms, process, **attrs):
        return {"name": name, "span_id": sid, "parent_id": parent, "trace_id": "ab" * 16,
                "start_s": t + start, "duration_ms": ms, "thread_id": 1, "attrs": attrs,
                "process": process}

    spans = [sp("router.forward", "router:1", None, 0.0, 3.0, "router", replica="a:1", attempt=0),
             sp("router.forward", "router:2", None, 0.004, 40.0, "router", replica="b:2", attempt=1),
             sp("gateway.admit", "replica:a:1:5", None, 0.0005, 1.0, "replica:a:1"),
             sp("gateway.admit", "replica:b:2:5", None, 0.005, 0.5, "replica:b:2")]
    if staged:
        spans += [sp("microbatch.coalesce", "replica:b:2:6", None, 0.007, 5.0, "replica:b:2"),
                  sp("pipeline.host_prep", "replica:b:2:7", None, 0.012, 2.0, "replica:b:2"),
                  sp("pipeline.upload", "replica:b:2:8", None, 0.014, 1.5, "replica:b:2"),
                  sp("pipeline.compute", "replica:b:2:9", None, 0.016, 9.5, "replica:b:2"),
                  sp("pipeline.deliver", "replica:b:2:10", None, 0.026, 2.0, "replica:b:2")]
    else:
        spans += [sp("microbatch.coalesce", "replica:b:2:6", None, 0.007, 16.0, "replica:b:2"),
                  sp("serving.dispatch", "replica:b:2:7", "replica:b:2:6", 0.012, 10.0,
                     "replica:b:2")]
    return spans


@pytest.mark.parametrize("case", ["serial", "staged", "router_only", "no_router"])
def test_phase_decomposition_equals_jax(case):
    spans = _stitch_spans(staged=case == "staged")
    if case == "router_only":
        spans = [s for s in spans if s["process"] == "router"]
    elif case == "no_router":
        spans = [s for s in spans if s["process"] != "router"]
    want, got = both(lambda m: m["stitch"].phase_decomposition(spans, "router"))
    assert got == want
    if case in ("serial", "staged"):
        assert sum(got["phases_ms"].values()) == pytest.approx(got["total_ms"], abs=1e-2)
        assert got["phases_ms"]["device"] > 0 and got["phases_ms"]["queue_wait"] > 0


def test_qualify_spans_and_stitched_trace_documents_equal_jax():
    raw = [{"name": "gateway.admit", "span_id": 5, "parent_id": 99, "start_s": 1.0,
            "duration_ms": 2.0, "thread_id": 3, "attrs": {"gateway": "g"}},
           {"name": "serving.dispatch", "span_id": 6, "parent_id": 5, "start_s": 1.001,
            "duration_ms": 1.0, "thread_id": 3, "attrs": {}}]
    spans = _stitch_spans(staged=False)

    def run(m):
        q = m["stitch"].qualify_spans(raw, "replica:h:1")
        st = m["stitch"].StitchedTrace(
            trace_id="ab" * 16, spans=spans, processes=["router", "replica:a:1", "replica:b:2"],
            partial=True, partial_detail=["a:1: no spans"],
            phases=m["stitch"].phase_decomposition(spans, "router"))
        return q, st.to_dict(), st.to_chrome_trace()

    want, got = both(run)
    assert got == want
    assert got[0][0]["parent_id"] is None and got[0][1]["parent_id"] == "replica:h:1:5"


# -- attribution: the same charges and claims give the same documents ----------


def _attribution_script(m):
    """A solo engine's and a shared engine's dispatch facts into one
    ledger, with row claims, completion seconds and staging bytes."""
    reg = m["registry"].MetricsRegistry()
    ledger = m["attr"].AttributionLedger()
    ledger.register(reg)
    solo = m["attr"].EngineAttribution(ledger, ("solo",))
    claims = m["attr"].RowClaimQueue()
    shared = m["attr"].EngineAttribution(ledger, ("a", "b"), shares_fn=claims.drain,
                                         split_cost_fn=lambda b: None)
    split = m["attr"].EngineAttribution(
        ledger, ("a", "b"), shares_fn=claims.drain,
        split_cost_fn=lambda b: (1e9, {"a": 2e8, "b": 5e8}))
    solo.on_dispatch(8, 5, 3, 1e6, None, 4096)
    solo.on_complete(0.002)
    for mid, rows in (("a", 3), ("b", 1), ("a", 0.5), ("b", 0.5), ("b", 6)):
        claims.claim(mid, rows)
    shared.on_dispatch(8, 4, 4, 0.0, None, 8192)
    shared.on_dispatch(8, 1, 7, 0.0, 0.004, 8192)
    shared.on_complete(0.01)
    split.on_dispatch(64, 6, 58, 3e9, 0.02, 65536)
    shared.on_dispatch(8, 3, 5, 0.0, None, None)  # unclaimed: an even split
    shared.on_complete(0.003)
    ledger.set_staging_bytes("a", 1024.0)
    ledger.set_staging_bytes("solo", None)
    text = m["prom"].render(reg.collect())
    return (m["attr"].attribution_document(ledger, top_k=2), text,
            m["attr"].attribution_from_samples(m["prom"].parse_samples(text), top_k=2),
            ledger.totals(), len(claims))


def test_attribution_documents_equal_jax():
    want, got = both(_attribution_script)
    assert got[0] == want[0] and got[2] == want[2] and got[3] == want[3] and got[4] == want[4]
    assert got[1] == want[1]
    doc = got[0]
    shares = [e["device_seconds_share"] for e in doc["models"].values()]
    assert sum(shares) == pytest.approx(1.0, abs=1e-12)
    assert doc["totals"]["device_seconds"] == pytest.approx(0.002 + 0.004 + 0.01 + 0.02 + 0.003)


def test_row_claim_queue_drains_as_jax():
    def run(m):
        q = m["attr"].RowClaimQueue()
        out = []
        for op in (("claim", "a", 2), ("claim", "b", 3), ("drain", 1), ("claim", "a", 0),
                   ("drain", 3.5), ("drain", 4), ("claim", "c", 1), ("drain", 0)):
            if op[0] == "claim":
                q.claim(op[1], op[2])
            else:
                out.append(q.drain(op[1]))
        return out, len(q)

    want, got = both(run)
    assert got == want


# -- drift: psi and the detector's flags ----------------------------------------


def test_psi_agrees_within_1e12():
    rng = np.random.default_rng(17)
    for _ in range(50):
        sizes = rng.choice(np.arange(1, 65), size=rng.integers(1, 12), replace=False)
        base = {int(k): float(v) for k, v in zip(sizes, rng.integers(0, 500, len(sizes)))}
        sizes = rng.choice(np.arange(1, 65), size=rng.integers(1, 12), replace=False)
        live = {int(k): float(v) for k, v in zip(sizes, rng.integers(0, 500, len(sizes)))}
        want, got = jdrift.psi(base, live), tdrift.psi(base, live)
        if want is None:
            assert got is None
        else:
            assert abs(got - want) <= 1e-12
    assert tdrift.psi({}, {1: 2.0}) is None


def _drift_script(m):
    now = [0.0]
    reg = m["registry"].MetricsRegistry()
    det = m["drift"].DriftDetector(min_rows=8, window_s=10.0, clock=lambda: now[0])
    det.register(reg)
    det.set_baseline("alpha", {1: 90, 8: 10})
    det.set_baseline("beta", {1: 50, 64: 50})
    out = []
    for t, model, sizes in ((1.0, "alpha", [1] * 9 + [8]), (2.0, "beta", [1, 64] * 5),
                            (3.0, "alpha", [64] * 12), (20.0, "beta", [64] * 4),
                            (21.0, "alpha", [1] * 10)):
        now[0] = t
        for size in sizes:
            det.observe(model, size)
        out.append((det.drifted(), {k: round(v, 12) for k, v in det.scores().items()}))
    doc = det.document()
    text = m["prom"].render(reg.collect())
    det.set_baseline("alpha", {})
    return out, doc, text, det.drifted()


def test_drift_flags_and_documents_equal_jax():
    want, got = both(_drift_script)
    assert got == want
    assert got[0][2][0] == ["alpha"]  # 64-row requests against a plan of 1s and 8s
