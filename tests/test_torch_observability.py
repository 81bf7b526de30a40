"""The observability plane and the fault injector of ``keystone_tpu_torch``
on the CPU, held against the JAX package's modules on the same inputs:
Prometheus rendering, content negotiation, parsing, merging and quantiles
(equal strings and values), SLO burn rates under one scripted clock,
flight-recorder captures, ``parse_fault_spec``/``arm_from_env`` and the
trigger points, the device-info gauge and the memory sampler (host RAM on
the CPU), ``/profilez`` and the admin endpoint. Every HTTP call has its
own timeout of a few seconds."""

import json
import re
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from keystone_tpu.loadgen import faults as jfaults
from keystone_tpu.observability import device as jdevice
from keystone_tpu.observability import flight as jflight
from keystone_tpu.observability import profilez as jprofilez
from keystone_tpu.observability import prometheus as jprom
from keystone_tpu.observability import registry as jregistry
from keystone_tpu.observability import slo as jslo
from keystone_tpu.observability import tracing as jtracing
from keystone_tpu_torch.loadgen import faults as tfaults
from keystone_tpu_torch.observability import admin as tadmin
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
                faults=jfaults, device=jdevice),
    "torch": dict(prom=tprom, registry=tregistry, slo=tslo, flight=tflight, tracing=ttracing,
                  faults=tfaults, device=tdevice),
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
        "gateway.swap.force"}
    assert set(tfaults.FAULT_POINTS) <= set(jfaults.FAULT_POINTS)


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
