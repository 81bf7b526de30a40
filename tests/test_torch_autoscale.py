"""``keystone_tpu_torch/autoscale`` on the CPU, held against the JAX
package's ``keystone_tpu/autoscale``: ``PolicyEngine.decide`` makes the
same decisions over the same seeded sequences of synthetic
``FleetObservation``s; ``fleet_latency_buckets``, ``windowed_p99``,
``observation_from``, ``fit_capacity``, ``derive_policy`` and
``build_artifact`` give the same values; the supervisor's retirement
deregisters once (by the replica itself when it deregisters on SIGTERM,
else before the drain); an ``InprocLauncher`` supervisor scales 1 → 2 →
1 over CPU replicas behind the port's router; the controller's tick
converges the fleet; and ``serve-capacity-plan --mode inproc`` writes an
artifact that ``PolicyConfig.from_plan`` loads. Every HTTP call and join
has its own timeout."""

import contextlib
import io
import json
import time
import urllib.request
from typing import List

import numpy as np
import pytest
import torch

from keystone_tpu.autoscale import controller as jcontroller
from keystone_tpu.autoscale import planner as jplanner
from keystone_tpu.autoscale import policy as jpolicy
from keystone_tpu_torch.autoscale import controller as tcontroller
from keystone_tpu_torch.autoscale import planner as tplanner
from keystone_tpu_torch.autoscale import policy as tpolicy
from keystone_tpu_torch.autoscale.supervisor import InprocLauncher, Supervisor
from keystone_tpu_torch.fleet import RouterServer
from keystone_tpu_torch.gateway import Gateway, GatewayServer
from keystone_tpu_torch.observability.registry import MetricsRegistry
from keystone_tpu_torch.serving.bench import build_pipeline

INF = float("inf")
HTTP_TIMEOUT_S = 10
D = 8


# -- the policy: the same decisions on the same observations -----------------


def _observations(mod, seed, n=120):
    """A seeded walk of fleet observations: p99 around the 100 ms
    objective, burn rates, offered load, half-open replicas, phase
    shares — each field sometimes absent, as a real scrape degrades."""
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    for _ in range(n):
        t += float(rng.uniform(0.5, 3.0))
        level = rng.choice([0.005, 0.04, 0.09, 0.2, 0.6])
        shares = {}
        if rng.random() < 0.6:
            q, dev = rng.uniform(0, 1, 2)
            shares = {"queue_wait": float(q), "device": float(dev)}
        out.append(mod.FleetObservation(
            t=t,
            replicas_total=int(rng.integers(1, 5)),
            replicas_ready=int(rng.integers(0, 5)),
            replicas_half_open=int(rng.random() < 0.1),
            replicas_unhealthy=int(rng.random() < 0.05),
            fleet_p99_s=None if rng.random() < 0.15 else float(level * rng.uniform(0.5, 1.5)),
            burn_fast=None if rng.random() < 0.3 else float(rng.uniform(0, 4)),
            metrics_ok=bool(rng.random() < 0.9),
            offered_rps=None if rng.random() < 0.3 else float(rng.uniform(1, 200)),
            phase_shares=shares,
        ))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("plan", [None, 25.0])
def test_policy_decides_as_jax(seed, plan):
    kw = dict(min_replicas=1, max_replicas=5, slo_latency_s=0.1, up_burn=1.5, down_burn=0.5,
              up_consecutive=2, down_consecutive=3, up_cooldown_s=5.0, down_cooldown_s=8.0,
              per_replica_rps=plan)
    jeng, teng = jpolicy.PolicyEngine(jpolicy.PolicyConfig(**kw)), tpolicy.PolicyEngine(
        tpolicy.PolicyConfig(**kw))
    jn = tn = 1
    actions = set()
    for jo, to in zip(_observations(jpolicy, seed), _observations(tpolicy, seed)):
        jd, td = jeng.decide(jn, jo), teng.decide(tn, to)
        assert (td.action, td.target, td.reason, td.hot_streak, td.cold_streak) == (
            jd.action, jd.target, jd.reason, jd.hot_streak, jd.cold_streak)
        assert td.as_dict() == jd.as_dict()
        jn, tn = jd.target, td.target
        actions.add(td.action)
    assert "hold" in actions and len(actions) >= 2


def test_policy_config_and_phase_shares_as_jax(tmp_path):
    samples = [{"queue_wait": 30.0, "device": 10.0}, {"device": 5.0, "host": 1.0}, {}]
    assert tpolicy.phase_shares(samples) == jpolicy.phase_shares(samples)
    assert tpolicy.phase_shares([]) == jpolicy.phase_shares([])
    plan = {"slo": {"latency_s": 0.5}, "fit": {"per_replica_rps": 10.0},
            "policy": {"target_utilization": 0.9}}
    for kw in ({}, dict(slo_latency_s=0.2, per_replica_rps=33.0)):
        assert (tpolicy.PolicyConfig.from_plan(plan, **kw).__dict__
                == jpolicy.PolicyConfig.from_plan(plan, **kw).__dict__)
    for bad in ([1, 2], {"policy": {"warp_factor": 9}}):
        with pytest.raises(ValueError) as te:
            tpolicy.PolicyConfig.from_plan(bad)
        with pytest.raises(ValueError) as je:
            jpolicy.PolicyConfig.from_plan(bad)
        assert str(te.value) == str(je.value)
    for kw in (dict(min_replicas=0), dict(min_replicas=3, max_replicas=2), dict(up_burn=0.1)):
        with pytest.raises(ValueError):
            tpolicy.PolicyConfig(slo_latency_s=0.1, **kw)
        with pytest.raises(ValueError):
            jpolicy.PolicyConfig(slo_latency_s=0.1, **kw)


# -- the controller's arithmetic ------------------------------------------------

METRICS = """\
# TYPE keystone_gateway_request_latency_seconds histogram
keystone_gateway_request_latency_seconds_bucket{gateway="r0",le="0.01"} 80
keystone_gateway_request_latency_seconds_bucket{gateway="r0",le="0.1"} 95
keystone_gateway_request_latency_seconds_bucket{gateway="r0",le="+Inf"} 100
keystone_gateway_request_latency_seconds_bucket{gateway="r1",le="0.01"} 40
keystone_gateway_request_latency_seconds_bucket{gateway="r1",le="0.1"} 50
keystone_gateway_request_latency_seconds_bucket{gateway="r1",le="+Inf"} 50
keystone_router_requests_total{router="r",status="ok"} 140
keystone_router_requests_total{router="r",status="shed"} 10
keystone_gateway_queue_depth{gateway="r0"} 3
keystone_gateway_inflight{gateway="r0"} 2
"""
FLEETZ = {"counts": {"healthy": 2, "half-open": 1},
          "replicas": [{"ready": True, "healthy": True}, {"ready": True, "healthy": True},
                       {"ready": False, "healthy": False}]}
SLZ = {"slos": [{"name": "other:latency", "burn_rate": {"fast": 9.0, "slow": 9.0}},
                {"name": "autoscaler:fleet_latency", "burn_rate": {"fast": 2.5, "slow": 0.8}}]}


def test_fleet_buckets_windowed_p99_and_observations_as_jax():
    assert tcontroller.fleet_latency_buckets(METRICS) == jcontroller.fleet_latency_buckets(METRICS)
    rng = np.random.default_rng(0)
    bounds = (0.005, 0.01, 0.05, 0.1, 0.5, INF)
    for _ in range(200):
        base = np.cumsum(rng.integers(0, 50, len(bounds))).astype(float)
        curr = base + np.cumsum(rng.integers(-5, 40, len(bounds)))
        b, c = dict(zip(bounds, base)), dict(zip(bounds, curr))
        assert tcontroller.windowed_p99(c, b) == jcontroller.windowed_p99(c, b)
        assert tcontroller.windowed_p99(c, None) == jcontroller.windowed_p99(c, None)
    assert tcontroller.windowed_p99({}, None) is None
    for args in ((METRICS, SLZ, FLEETZ, [{"queue_wait": 30.0, "device": 10.0}]),
                 (None, None, None, []), (METRICS, None, None, [])):
        for prev in (None, 100.0):
            t = tcontroller.observation_from(*args, t=10.0, prev_requests=prev, prev_t=4.0)
            j = jcontroller.observation_from(*args, t=10.0, prev_requests=prev, prev_t=4.0)
            assert t.as_dict() == j.as_dict()


def test_planner_arithmetic_as_jax(tmp_path):
    for caps in ({1: 50.0, 2: 100.0, 3: 150.0}, {1: 50.0, 2: 80.0}, {1: 50.0, 2: 0.0},
                 {1: 0.0}, {}):
        assert tplanner.fit_capacity(caps) == jplanner.fit_capacity(caps)
    for args in ((42.0, 0.25, 0.6), (None, 0.25, 0.7), (13.3333, 0.1, 0.5)):
        assert tplanner.derive_policy(*args) == jplanner.derive_policy(*args)
    rows = [{"replicas": 1, "speed": 1.0, "offered_rps": 20.0, "p99_ms": 30.0, "shed_rate": 0.0,
             "lost": 0, "errors": 0, "slo_held": True},
            {"replicas": 1, "speed": 2.0, "offered_rps": 40.0, "p99_ms": 900.0, "shed_rate": 0.2,
             "lost": 0, "errors": 0, "slo_held": False},
            {"replicas": 2, "speed": 2.0, "offered_rps": 40.0, "p99_ms": 35.0, "shed_rate": 0.0,
             "lost": 0, "errors": 0, "slo_held": True}]
    t, j = tplanner.build_artifact(rows, 0.25, 0.99), jplanner.build_artifact(rows, 0.25, 0.99)
    t.pop("generated_at", None), j.pop("generated_at", None)
    assert t == j


# -- the supervisor -------------------------------------------------------------------


class FakeHandle:
    def __init__(self, index):
        self.index, self.name, self.pid = index, f"replica-{index}", 1000 + index
        self.url = f"http://127.0.0.1:{9000 + index}"
        self._alive, self.drains_ok = True, True
        self.calls: List[str] = []

    def wait_listening(self, timeout_s):
        return self.url

    def alive(self):
        return self._alive

    def drain(self):
        self.calls.append("drain")
        self._alive = not self.drains_ok

    def kill(self):
        self.calls.append("kill")
        self._alive = False

    def wait(self, timeout_s):
        return not self._alive

    def status(self):
        return {"name": self.name, "url": self.url, "alive": self._alive}


class FakeLauncher:
    self_registering = True

    def __init__(self, self_deregistering):
        self.self_deregistering = self_deregistering
        self.launched: List[FakeHandle] = []

    def launch(self, index):
        self.launched.append(FakeHandle(index))
        return self.launched[-1]


class RecordingSupervisor(Supervisor):
    def __init__(self, launcher, **kw):
        super().__init__(launcher, "http://router:1", **kw)
        self.deregistered: List[str] = []

    def _deregister(self, url):
        self.deregistered.append(url)
        for h in self.launcher.launched:
            if h.url == url:
                h.calls.append("deregister")


def _wait_until(pred, timeout_s=10.0):
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


@pytest.mark.parametrize("self_deregistering", [False, True])
def test_retirement_deregisters_once(self_deregistering):
    """A replica that deregisters itself on SIGTERM (the port's
    serve-gateway) is retired by the drain alone; any other is
    deregistered by the supervisor before its drain, as in JAX. A
    replica killed after its drain timed out is deregistered either
    way."""
    launcher = FakeLauncher(self_deregistering)
    sup = RecordingSupervisor(launcher, drain_timeout_s=0.01)
    events = []
    sup._on_event = events.append
    sup.scale_to(2)
    assert all("start_s" in e for e in events if e["event"] == "replica_started")
    sup.scale_to(1)
    (retired,) = [h for h in launcher.launched if h not in set(sup.replicas())]
    assert _wait_until(lambda: any(e["event"] == "replica_retired" for e in events))
    if self_deregistering:
        assert retired.calls == ["drain"] and sup.deregistered == []
    else:
        assert retired.calls == ["deregister", "drain"] and sup.deregistered == [retired.url]
    # a drain that never ends: killed, and then deregistered exactly once
    (last,) = sup.replicas()
    last.drains_ok = False
    sup.stop()
    assert last.calls.count("deregister") == 1 and "kill" in last.calls
    assert last.calls.index("kill") < last.calls.index("deregister") or not self_deregistering


def _factory(fitted):
    def factory(index):
        reg = MetricsRegistry()
        gw = Gateway(fitted, buckets=(2, 4), n_lanes=1, warmup_example=torch.zeros(D),
                     device="cpu", name=f"as-r{index}", registry=reg)
        return gw, GatewayServer(gw, port=0, registry=reg).start()
    return factory


def _post(url, doc):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as r:
        return r.status, json.loads(r.read())


def test_inproc_supervisor_scales_1_2_1_behind_the_router():
    fitted = build_pipeline(d=D, hidden=8, depth=2, device="cpu")
    router = RouterServer([], port=0, name="as-test", registry=MetricsRegistry(),
                          probe_interval_s=0.2).start()
    events = []
    sup = Supervisor(InprocLauncher(_factory(fitted)), router.url(), on_event=events.append,
                     drain_timeout_s=10)
    try:
        def ready():
            router.fleet.probe_once()
            return sum(1 for r in router.fleet.replicas() if r.healthy and r.ready)

        x = np.linspace(-1, 1, D).astype(np.float32)
        want = fitted._batch_run(torch.as_tensor(np.stack([x, 0 * x])))[0].numpy()
        for n in (1, 2, 1):
            sup.scale_to(n)
            assert _wait_until(lambda: ready() == n), (n, ready())
            assert len(sup.replicas()) == n and sup.status()["running"] == n
            for _ in range(2 * n):
                code, doc = _post(router.url() + "/predict", {"instances": [x.tolist()]})
                assert code == 200 and np.allclose(doc["predictions"][0], want, atol=1e-6)
        assert _wait_until(lambda: any(e["event"] == "replica_retired" for e in events))
        retired = [e for e in events if e["event"] == "replica_retired"]
        assert len(retired) == 1 and retired[0]["drained"] is True
        assert len(router.fleet.replicas()) == 1
    finally:
        sup.stop()
        router.stop()
    assert sup.replicas() == [] and sup.target == 0


class FakeScraper:
    def __init__(self, script):
        self.script = list(script)

    def observe(self):
        return self.script.pop(0) if self.script else None


def test_autoscaler_tick_converges_the_fleet():
    launcher = FakeLauncher(True)
    sup = RecordingSupervisor(launcher)
    sup.scale_to(1)
    config = tpolicy.PolicyConfig(min_replicas=1, max_replicas=3, slo_latency_s=0.1,
                                  up_consecutive=2, down_consecutive=2, up_cooldown_s=0.0,
                                  down_cooldown_s=0.0)
    hot = [tpolicy.FleetObservation(t=float(i), fleet_p99_s=0.5, metrics_ok=True)
           for i in range(2)]
    cold = [tpolicy.FleetObservation(t=float(10 + i), fleet_p99_s=0.001, burn_fast=0.0,
                                     metrics_ok=True, replicas_total=2, replicas_ready=2)
            for i in range(2)]
    events = []
    scaler = tcontroller.Autoscaler(sup, FakeScraper(hot + cold), tpolicy.PolicyEngine(config),
                                    interval_s=60, name="as-tick", registry=MetricsRegistry(),
                                    on_event=events.append)
    decisions = [scaler.tick() for _ in range(4)]
    assert [d.action for d in decisions] == ["hold", "scale_up", "hold", "scale_down"]
    assert sup.target == 1 and len(launcher.launched) == 2
    assert scaler.metrics.decision_count("scale_up") == 1
    assert scaler.metrics.decision_count("scale_down") == 1
    assert scaler.tick() is None  # a failed scrape decides nothing
    sup.stop()


def _scripted_scraper(mod, states):
    """A ``RouterScraper`` of ``mod`` whose router answers from
    ``states``, one (roster, {replica: (fast, slow) requests}) a tick:
    fast ones under 10 ms, slow ones between 0.5 and 5 s."""
    class Scripted(mod.RouterScraper):
        def observe(self):
            self.state = states.pop(0)
            return super().observe()

        def _get(self, path):
            roster, counts = self.state
            if path == "/fleetz":
                return json.dumps({"counts": {"healthy": len(roster)},
                                   "replicas": [{"url": u, "ready": True, "healthy": True}
                                                for u in roster]}).encode()
            if path == "/metrics":
                lines = []
                for u, (fast, slow) in counts.items():
                    for le, n in (("0.01", fast), ("0.5", fast), ("5.0", fast + slow),
                                  ("+Inf", fast + slow)):
                        lines.append(f'keystone_gateway_request_latency_seconds_bucket'
                                     f'{{gateway="{u}",le="{le}"}} {n}')
                return ("\n".join(lines) + "\n").encode()
            return json.dumps({"spans": []} if path == "/tracez" else {"slos": []}).encode()

    return Scripted("http://127.0.0.1:9")


def test_scraper_rebases_on_roster_change_without_the_lifetime_p99():
    """After a replica leaves (or joins) the roster, the port's scraper
    starts a new window from that tick's snapshot: the tick reads no
    p99, the next one windows against it. JAX's reads the lifetime
    quantile of the remaining replicas on that tick: after a scale-down
    their drained surge, a hot tick with no traffic at all, and two
    such ticks scaled a fleet straight back up. Every other tick reads
    as JAX's."""
    a, b = "http://127.0.0.1:1", "http://127.0.0.1:2"
    states = [([a, b], {a: (200, 100), b: (300, 0)}),  # first tick: the lifetime
              ([a, b], {a: (260, 100), b: (360, 0)}),  # a window of fast ones
              ([a], {a: (270, 100)}),                  # b retired: rebased
              ([a], {a: (290, 100)}),                  # fast ones after the rebase
              ([a], {a: (290, 100)}),                  # the same window
              ([a, b], {a: (295, 100), b: (5, 0)})]    # b joins: rebased
    port = _scripted_scraper(tcontroller, list(states))
    jax = _scripted_scraper(jcontroller, list(states))
    t_obs = [port.observe() for _ in states]
    j_obs = [jax.observe() for _ in states]
    t_p99, j_p99 = [o.fleet_p99_s for o in t_obs], [o.fleet_p99_s for o in j_obs]
    assert t_p99[2] is None and t_p99[5] is None
    assert j_p99[2] > 1.0  # JAX: the surge a's lifetime holds
    for i in (0, 1, 3, 4):
        assert t_p99[i] == j_p99[i], (i, t_p99, j_p99)
    assert t_p99[0] > 1.0 and t_p99[1] < 0.01 and t_p99[3] < 0.01 and t_p99[4] < 0.01
    # the ticks after the scale-down, under 17d's policy: JAX's first is hot
    config = dict(min_replicas=1, max_replicas=2, slo_latency_s=1.0, up_consecutive=2,
                  up_cooldown_s=0.0)
    engine = tpolicy.PolicyEngine(tpolicy.PolicyConfig(**config))
    jengine = jpolicy.PolicyEngine(jpolicy.PolicyConfig(**config))
    actions = [engine.decide(1, o).reason for o in t_obs[2:5]]
    assert jengine.decide(1, j_obs[2]).reason == "hot_streak_building"
    assert "hot_streak_building" not in actions, actions


# -- serve-capacity-plan ------------------------------------------------------------------


def test_capacity_plan_inproc_artifact_loads_into_the_policy(tmp_path):
    out_path = tmp_path / "plan.json"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tplanner.main(["--synthetic", "30", "--rate", "20", "--replicas", "1,2",
                            "--speeds", "1,2", "--slo-latency-ms", "2000", "--d", str(D),
                            "--hidden", "8", "--depth", "2", "--buckets", "2,4",
                            "--out", str(out_path)], device="cpu")
    assert rc == 0, out.getvalue()[-2000:]
    artifact = json.loads(out_path.read_text())
    assert len(artifact["rows"]) == 4 and artifact["fit"]["per_replica_rps"] > 0
    assert sorted(artifact) == sorted(jplanner.build_artifact(artifact["rows"], 2.0, 0.99))
    config = tpolicy.PolicyConfig.from_plan(str(out_path), max_replicas=6)
    assert config.per_replica_rps == pytest.approx(artifact["fit"]["per_replica_rps"], rel=1e-3)
    assert config.slo_latency_s == 2.0 and config.max_replicas == 6
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == {"plan_written": str(out_path)}
