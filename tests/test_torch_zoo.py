"""The model zoo of ``keystone_tpu_torch`` on the CPU, held against the
JAX package's: ``load_zoo_spec`` builds the same registry (and the same
parameters) from one JSON file; ``plan_placement`` and ``diff_plans``
give equal plans on the same profiles; ``SharedPrefixEngine`` over the
demo chain and over the flagship chain at 64² (weights carried across by
``convert``; JAX's Pallas kernels in interpret mode) gives every head's
output within rtol 1e-4 / atol 1e-5 of JAX's shared engine and of the
port's solo engine, through the engine, the batcher and the staged
lanes; ``ModelZoo`` page-in, LRU eviction and the typed ``unknown_model``
404 equal JAX's over HTTP; the content digest; a zoo replica behind the
port's router; and the ``serve-gateway --zoo`` entry. Every HTTP call,
future and join has its own timeout."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from keystone_tpu.gateway import GatewayServer as JGatewayServer
from keystone_tpu.observability.registry import MetricsRegistry as JRegistry
from keystone_tpu.serving import bench as jbench
from keystone_tpu.serving.featurize import build_featurize_pipeline as jdemo
from keystone_tpu.serving.featurize import build_flagship_featurize_pipeline as jflagship
from keystone_tpu.zoo import ModelZoo as JModelZoo
from keystone_tpu.zoo import SharedPrefixEngine as JSharedPrefixEngine
from keystone_tpu.zoo import load_zoo_spec as jload
from keystone_tpu.zoo import optimizer as jopt
from keystone_tpu_torch import convert
from keystone_tpu_torch.fleet import RouterServer
from keystone_tpu_torch.gateway import GatewayServer
from keystone_tpu_torch.gateway import http as thttp
from keystone_tpu_torch.observability.registry import MetricsRegistry
from keystone_tpu_torch.serving import bench as tbench
from keystone_tpu_torch.serving.batching import MicroBatcher
from keystone_tpu_torch.serving.featurize import build_featurize_pipeline as tdemo
from keystone_tpu_torch.serving.featurize import featurize_token, pipeline_token
from keystone_tpu_torch.zoo import BuiltModel, ModelRegistry, ModelSpec, ModelZoo
from keystone_tpu_torch.zoo import SharedPrefixEngine, featurize_groups
from keystone_tpu_torch.zoo import load_zoo_spec as tload
from keystone_tpu_torch.zoo import optimizer as topt
from keystone_tpu_torch.zoo.host import named_params, params_nbytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HTTP_TIMEOUT_S = 10
RESULT_TIMEOUT_S = 10
RTOL, ATOL = 1e-4, 1e-5
IMG = 8  # the demo chain's image edge
# the flagship chain at 64², its geometry as tests/test_torch_gateway.py's
FIMG, DESC, VOCAB = 64, 8, 8
GEOMETRY = dict(sift_step=4, sift_bin=4, sift_scales=2, sift_scale_step=1,
                lcs_stride=4, lcs_border=16, lcs_patch=6)

SPEC = {"models": [
    {"name": "alpha", "device_featurize": "demo", "img": IMG, "hidden": 8, "depth": 2,
     "seed": 1, "buckets": [2, 4], "lanes": 1, "default": True, "pinned": True,
     "slo_latency_ms": 250, "max_delay_ms": 1.0, "expected_sizes": {"1": 50, "3": 10}},
    {"name": "beta", "device_featurize": "demo", "img": IMG, "hidden": 8, "depth": 2,
     "seed": 2, "buckets": [4, 2], "lanes": 1, "pinned": True, "max_delay_ms": 1.0},
    {"name": "gamma.plain", "d": 6, "hidden": 8, "depth": 2, "seed": 3, "buckets": [2],
     "lanes": 1, "max_delay_ms": 1.0, "pipeline_depth": 0},
]}


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


def _wait(cond, what, timeout=RESULT_TIMEOUT_S):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture(scope="module")
def spec_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("zoo") / "spec.json"
    path.write_text(json.dumps(SPEC))
    return str(path)


def _image(seed=0, img=IMG):
    return np.random.default_rng(seed).integers(0, 256, (img, img, 3), dtype=np.uint8)


# -- the registry: one JSON file, the same specs and parameters -----------------


def test_load_zoo_spec_builds_the_same_registry_as_jax(spec_path):
    jreg, treg = jload(spec_path), tload(spec_path, device="cpu")
    assert treg.ids() == jreg.ids() and treg.default_id == jreg.default_id == "alpha"
    for js, ts in zip(jreg, treg):
        for field in ("buckets", "lanes", "slo_latency_s", "max_delay_ms", "pipeline_depth",
                      "pinned", "default", "expected_sizes", "param_sharding"):
            assert getattr(ts, field) == getattr(js, field), field
        assert np.dtype(ts.input_dtype) == np.dtype(js.input_dtype)
        assert isinstance(ts.warmup_example, torch.Tensor)
        assert tuple(ts.warmup_example.shape) == tuple(js.warmup_example.shape)
        assert str(ts.warmup_example.dtype).split(".")[1] == str(js.warmup_example.dtype)
        jb, tb = js.build(), ts.build()
        for (jw, jbias), (tw, tbias) in zip(convert.affine_params(jb.fitted),
                                            convert.affine_params(tb.fitted)):
            np.testing.assert_array_equal(tw, jw)
            np.testing.assert_array_equal(tbias, jbias)
        assert (jb.featurize is None) == (tb.featurize is None)
    for bad in ({"models": []}, {"models": [{"d": 4}]},
                {"models": [{"name": "x", "device_featurize": "nope"}]},
                {"models": [{"name": "bad id!"}]},
                {"models": [{"name": "a"}, {"name": "a"}]}):
        path = os.path.join(os.path.dirname(spec_path), "bad.json")
        with open(path, "w") as f:
            json.dump(bad, f)
        with pytest.raises(ValueError) as jerr:
            jload(path)
        with pytest.raises(ValueError) as terr:
            tload(path, device="cpu")
        assert str(terr.value) == str(jerr.value), bad


# -- the placement optimizer: equal plans on the same profiles -----------------


def _profiles(mod):
    P = mod.ModelProfile
    return [
        P("alpha", {1: 500, 3: 40, 8: 120}, {2: {"flops": 1e6}, 8: {"flops": 4e6}},
          params_nbytes=4_000_000, fallback_buckets=(2, 8), pinned=True),
        P("beta", {16: 30, 2: 10}, {16: {"flops": 9e7}}, params_nbytes=60_000_000,
          fallback_buckets=(4, 16)),
        P("gamma", {}, {}, params_nbytes=1_000, fallback_buckets=(8, 32, 128)),
        P("delta", {5: 7}, {}, params_nbytes=0, fallback_buckets=(8,)),
    ]


@pytest.mark.parametrize("budget", [
    dict(), dict(hbm_bytes=50_000_000), dict(hbm_bytes=50_000_000, n_chips=4),
    dict(lane_budget=9), dict(lane_budget=5, param_fraction=0.5, hbm_bytes=10**8),
    dict(lane_budget=2),
])
def test_plan_placement_and_diff_plans_equal_jax(budget):
    def run(mod):
        try:
            plan = mod.plan_placement(_profiles(mod), mod.ChipBudget(**budget))
        except ValueError as e:  # fewer lanes than models
            return str(e)
        other = mod.plan_placement(_profiles(mod)[:3], mod.ChipBudget(lane_budget=4), k=2)
        return plan.to_dict(), mod.diff_plans(plan, other), mod.diff_plans(other, plan)

    assert run(topt) == run(jopt)


# -- the content digest ---------------------------------------------------------


def test_featurize_tokens_group_by_content_as_jax():
    feats = {"a": tdemo(img=IMG, device="cpu")[0], "b": tdemo(img=IMG, device="cpu")[0],
             "c": tdemo(img=IMG, seed=8, device="cpu")[0], "d": tdemo(img=IMG + 4, device="cpu")[0]}
    jfeats = {"a": jdemo(img=IMG)[0], "b": jdemo(img=IMG)[0], "c": jdemo(img=IMG, seed=8)[0],
              "d": jdemo(img=IMG + 4)[0]}
    from keystone_tpu.zoo.cse import featurize_groups as jgroups

    assert featurize_groups(feats) == jgroups(jfeats) == [("a", "b"), ("c",), ("d",)]
    # memoized, and blind to caches a run attaches
    token = featurize_token(feats["a"])
    feats["a"]._batch_run(torch.zeros((2, IMG, IMG, 3), dtype=torch.uint8))
    del feats["a"]._pipeline_token
    assert featurize_token(feats["a"]) == token and feats["a"]._pipeline_token == token


def test_pipeline_token_sees_nested_parameters_and_dtypes():
    from keystone_tpu_torch.serving.featurize import build_flagship_featurize_pipeline

    feat, _ = build_flagship_featurize_pipeline(img=40, desc_dim=DESC, vocab=VOCAB, device="cpu",
                                                **GEOMETRY)
    token = pipeline_token(feat)
    fv = next(op for op in feat.graph.operators.values() if hasattr(op, "gmm"))
    saved = fv.gmm.means.clone()
    fv.gmm.means[0, 0] += 1e-3  # a GMM inside a Fisher-vector node
    del feat._pipeline_token
    assert pipeline_token(feat) != token
    fv.gmm.means.copy_(saved)
    del feat._pipeline_token
    assert pipeline_token(feat) == token
    fv.gmm.means = saved.to(torch.float64)
    del feat._pipeline_token
    assert pipeline_token(feat) != token


def test_params_nbytes_sizes_the_head_as_jax():
    from keystone_tpu.serving.sharding import named_params as jnamed
    from keystone_tpu.serving.sharding import params_nbytes as jnbytes

    jfitted = jbench.build_pipeline(d=6, hidden=8, depth=3, seed=4)
    tfitted = tbench.build_pipeline(d=6, hidden=8, depth=3, seed=4, device="cpu")
    assert sorted(named_params(tfitted)) == sorted(jnamed(jfitted))
    assert params_nbytes(named_params(tfitted)) == jnbytes(jnamed(jfitted)) > 0


# -- shared-prefix engines: every head against JAX's and the solo engine -------


def _demo_pair():
    jfeat, d = jdemo(img=IMG)
    tfeat, td = tdemo(img=IMG, device="cpu")
    assert td == d
    return jfeat, tfeat, d, IMG


def _flagship_pair():
    from test_torch_gateway import _jax_flagship_params

    jfeat, d = jflagship(img=FIMG, desc_dim=DESC, vocab=VOCAB, **GEOMETRY)
    tfeat, _ = convert.flagship_from_numpy(_jax_flagship_params(jfeat), device="cpu", **GEOMETRY)
    return jfeat, tfeat, d, FIMG


@pytest.mark.parametrize("chain", ["demo", "flagship"])
def test_shared_prefix_engine_matches_jax_and_the_solo_engine(chain):
    jfeat, tfeat, d, img = _demo_pair() if chain == "demo" else _flagship_pair()
    jheads = {m: jbench.build_pipeline(d=d, hidden=8, depth=2, seed=s)
              for m, s in (("m2", 2), ("m1", 1))}
    theads = {m: tbench.build_pipeline(d=d, hidden=8, depth=2, seed=s, device="cpu")
              for m, s in (("m2", 2), ("m1", 1))}
    images = np.stack([_image(i, img) for i in range(3)])
    jeng = JSharedPrefixEngine(jfeat, jheads, (4,))
    teng = SharedPrefixEngine(tfeat, theads, (4,), device="cpu")
    assert list(teng.heads) == ["m1", "m2"] and teng.split_cost_model(4) is None
    jout = jeng.apply(images)
    tout = teng.apply(images)
    assert list(tout) == ["m1", "m2"]
    for m in ("m1", "m2"):
        got = tout[m].numpy()
        np.testing.assert_allclose(got, np.asarray(jout[m]), rtol=RTOL, atol=ATOL)
        solo = theads[m].compiled((4,), featurize=tfeat, device="cpu").apply(images).numpy()
        np.testing.assert_allclose(got, solo, rtol=RTOL, atol=ATOL)
    assert not np.allclose(tout["m1"].numpy(), tout["m2"].numpy())
    # one dispatch for the whole group, as JAX's
    assert teng.metrics.dispatches.total == 1
    # dict outputs through the batcher, serial and staged: every request's
    # future resolves to its own row of every head
    for depth in (0, 2):
        mb = MicroBatcher(teng, max_delay_ms=20, pipeline_depth=depth)
        try:
            futs = [mb.submit(im) for im in images]
            rows = [f.result(timeout=60) for f in futs]
        finally:
            mb.close()
        for i, row in enumerate(rows):
            assert sorted(row) == ["m1", "m2"]
            for m in row:
                np.testing.assert_array_equal(row[m], tout[m][i].numpy())
    # chunked through the largest bucket: dicts concatenate
    seven = np.concatenate([images, images, images[:1]])
    big = teng.apply(seven)
    for m in ("m1", "m2"):
        np.testing.assert_array_equal(big[m][:3].numpy(), tout[m].numpy())
        assert big[m].shape[0] == 7
    with pytest.raises(ValueError):
        SharedPrefixEngine(tfeat, theads, (4,), device="cpu", param_sharding=True)
    with pytest.raises(ValueError):
        SharedPrefixEngine(None, theads, (4,), device="cpu")
    with pytest.raises(ValueError):
        SharedPrefixEngine(tfeat, {}, (4,), device="cpu")


# -- the zoo: page-in, LRU eviction, typed 404s, as JAX's ----------------------


def _zoo_pair(spec_path, max_resident=None):
    jzoo = JModelZoo(jload(spec_path), max_resident=max_resident, aot_namespaces=False,
                     metrics_registry=JRegistry())
    tzoo = ModelZoo(tload(spec_path, device="cpu"), max_resident=max_resident, device="cpu",
                    metrics_registry=MetricsRegistry())
    return jzoo, tzoo


def _resident(zoo):
    return {m: row["resident"] for m, row in zoo.planz()["actual"].items()}


def test_zoo_pages_in_evicts_and_answers_unknown_models_as_jax(spec_path):
    jzoo, tzoo = _zoo_pair(spec_path, max_resident=2)
    jsrv = JGatewayServer(zoo=jzoo, port=0, registry=JRegistry()).start()
    tsrv = GatewayServer(zoo=tzoo, port=0, registry=MetricsRegistry()).start()
    try:
        assert tzoo.host(["alpha", "beta"]) == jzoo.host(["alpha", "beta"]) == [("alpha", "beta")]
        assert _resident(tzoo) == _resident(jzoo) == {"alpha": True, "beta": True,
                                                      "gamma.plain": False}
        tplan, jplan = tzoo.planz(), jzoo.planz()
        for doc in (tplan, jplan):
            for row in doc["actual"].values():
                row.pop("free_capacity", None)
                row.pop("total_load", None)
        assert tplan == jplan
        assert tplan["actual"]["alpha"]["shared_with"] == ["beta"]
        for srv in (jsrv, tsrv):
            code, doc = _post(srv.url("/predict/gamma.plain"), {"instances": [[0.1] * 6]})
            assert code == 200 and len(doc["predictions"][0]) == 6
        # both pinned: the page-in over the cap evicts nothing
        assert _resident(tzoo) == _resident(jzoo) == {m: True for m in _resident(jzoo)}
        body = {"instances": [[0.0] * 6]}
        for path in ("/predict/nope", "/predict/ALPHA"):
            assert _post(tsrv.url(path), body) == _post(jsrv.url(path), body)
        code, doc = _post(tsrv.url("/predict/nope"), body)
        assert code == 404 and doc == {"error": "unknown_model", "model": "nope",
                                       "registered": ["alpha", "beta", "gamma.plain"]}
        for path in ("/planz", "/attributionz", "/driftz"):
            (tc, tt), (jc, jt) = _get(tsrv.url(path)), _get(jsrv.url(path))
            assert tc == jc == 200, path
            assert sorted(json.loads(tt)) == sorted(json.loads(jt)), path
        (tc, tt), (jc, jt) = _get(tsrv.url("/readyz")), _get(jsrv.url("/readyz"))
        assert (tc, tt) == (jc, jt) == (200, "ok\n")
        # bare /predict serves the default model (uint8 images)
        image = _image(3).tolist()
        code, doc = _post(tsrv.url("/predict"), {"instances": [image]})
        jcode, jdoc = _post(jsrv.url("/predict"), {"instances": [image]})
        assert code == jcode == 200
    finally:
        for zoo, srv in ((jzoo, jsrv), (tzoo, tsrv)):
            zoo.close()
            srv.stop()


def _unpinned_spec(path):
    doc = json.loads(json.dumps(SPEC))
    for m in doc["models"]:
        m["pinned"] = False
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def test_lru_eviction_drains_in_the_background_as_jax(tmp_path):
    path = _unpinned_spec(str(tmp_path / "unpinned.json"))
    jzoo, tzoo = _zoo_pair(path, max_resident=1)
    try:
        for zoo in (jzoo, tzoo):
            zoo.host(["gamma.plain"])
            x = np.full(6, 0.5, np.float32)
            zoo.predict(x, "gamma.plain").result(timeout=60)
            zoo.predict(_image(1), "alpha").result(timeout=60)  # pages alpha in solo
        assert _resident(tzoo) == _resident(jzoo) == {"alpha": True, "beta": False,
                                                      "gamma.plain": False}
        treg_text = tzoo.attribution  # the ledger charged both models
        assert set(treg_text.models()) == {"alpha", "gamma.plain"}
        # the evicted unit drained on its own thread and released its
        # engines' graphs; paging back in builds a fresh unit
        got = np.asarray(tzoo.predict(np.full(6, 0.5, np.float32), "gamma.plain").result(timeout=60))
        assert got.shape == (6,)
        assert _resident(tzoo) == {"alpha": False, "beta": False, "gamma.plain": True}
        assert tzoo.evict("gamma.plain") is True and tzoo.evict("gamma.plain") is False
    finally:
        jzoo.close()
        tzoo.close()


def test_zoo_specs_that_ask_for_sharding_raise(tmp_path):
    """Sharded specs host (they raised before the port had
    ``serving/sharding.py``): a solo unit with ``shard_model`` and a
    shared-prefix unit with one sharded head answer exactly as their
    unsharded counterparts; each sharded engine holds its own placed
    copy of the head's params, and the caller's pipeline is untouched."""
    doc = {"models": [{"name": name, "d": 4, "hidden": 4, "depth": 1, "shard_model": shard,
                       "buckets": [2], "lanes": 1}
                      for name, shard in (("s", True), ("u", False))]}
    path = tmp_path / "sharded.json"
    path.write_text(json.dumps(doc))
    zoo = ModelZoo(tload(str(path), device="cpu"), device="cpu", metrics_registry=MetricsRegistry())
    x = np.linspace(-1, 1, 4).astype(np.float32)
    try:
        zoo.host()
        engine = zoo.gateway_for("s").pool.lanes[0].engine
        assert engine.model_sharded and set(engine.param_sharding) == {"0/_Affine/W", "0/_Affine/b"}
        assert zoo.gateway_for("u").pool.lanes[0].engine.model_sharded is False
        got = np.asarray(zoo.predict(x, "s").result(timeout=60))
        want = np.asarray(zoo.predict(x, "u").result(timeout=60))
        assert np.array_equal(got, want)
    finally:
        zoo.close()
    feat, d = tdemo(img=IMG, device="cpu")
    reg = ModelRegistry()
    heads = {}
    for mid, shard in (("a", None), ("b", True)):
        heads[mid] = head = tbench.build_pipeline(d=d, hidden=4, depth=1, seed=ord(mid),
                                                  device="cpu")
        reg.register(ModelSpec(mid, build=lambda h=head: BuiltModel(h, feat), buckets=(2,),
                               lanes=1, param_sharding=shard, input_dtype=np.uint8))
    zoo = ModelZoo(reg, device="cpu", metrics_registry=MetricsRegistry())
    image = np.random.default_rng(3).integers(0, 256, (IMG, IMG, 3), dtype=np.uint8)
    try:
        zoo.host()
        engine = zoo.gateway_for("a").pool.lanes[0].engine
        assert isinstance(engine, SharedPrefixEngine) and set(engine._head_binders) == {"b"}
        for mid in ("a", "b"):
            got = np.asarray(zoo.predict(image, mid).result(timeout=60))
            # the unsharded head at the unit's bucket of 2 (a zero pad row)
            padded = torch.as_tensor(np.stack([image, np.zeros_like(image)]))
            solo = heads[mid]._batch_run(feat._batch_run(padded))
            assert np.array_equal(got, solo[0].numpy()), mid
        placed = engine._head_binders["b"][1]["0/_Affine/W"]
        assert placed.data_ptr() != heads["b"].graph.operators[heads["b"]._topo[0]].W.data_ptr()
    finally:
        zoo.close()


def test_the_zoo_needs_a_card_unless_given_the_cpu(spec_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelZoo(tload(spec_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        thttp.main(["--zoo", spec_path])


# -- a zoo replica behind the port's router ------------------------------------


def test_zoo_replica_behind_the_router_attribution_and_drift(spec_path):
    router = RouterServer(registry=MetricsRegistry(), probe_interval_s=0.1).start()
    url = router.url().rstrip("/")
    zoo = ModelZoo(tload(spec_path, device="cpu"), device="cpu", metrics_registry=MetricsRegistry())
    reg = MetricsRegistry()
    zoo.attribution.register(reg)
    zoo.drift.register(reg)
    srv = GatewayServer(zoo=zoo, port=0, registry=reg).start()
    try:
        zoo.host()
        own = srv.url().rstrip("/")
        assert thttp.register_with_router(url, own, attempts=3, interval_s=0.1,
                                          models=list(zoo.registry.ids()))
        _wait(lambda: all(r.ready for r in router.fleet.replicas()), "the zoo replica probed ready")
        image = _image(4)
        want = {m: np.asarray(zoo.predict(image, m).result(timeout=60)) for m in ("alpha", "beta")}
        for m in ("alpha", "beta"):
            code, doc = _post(url + f"/predict/{m}", {"instances": [image.tolist()]})
            assert code == 200
            np.testing.assert_allclose(np.asarray(doc["predictions"][0]), want[m],
                                       rtol=RTOL, atol=ATOL)
        code, doc = _post(url + "/predict/gamma.plain", {"instances": [[0.2] * 6, [0.1] * 6]})
        assert code == 200 and np.asarray(doc["predictions"]).shape == (2, 6)
        code, doc = _post(url + "/predict/nope", {"instances": [[0.2] * 6]})
        assert code == 503 and doc["error"] == "no_replica_for_model"
        # the replica advertises a model its zoo does not know: the
        # replica's typed 404 reaches the client verbatim
        assert thttp.register_with_router(url, own, attempts=1, models=["ghost"])
        code, doc = _post(url + "/predict/ghost", {"instances": [[0.2] * 6]})
        assert code == 404 and doc["error"] == "unknown_model" and doc["model"] == "ghost"
        for path in ("/attributionz",):
            rdoc, zdoc = json.loads(_get(url + path)[1]), json.loads(_get(own + path)[1])
            shares = [e["device_seconds_share"] for e in rdoc["models"].values()]
            assert sum(shares) == pytest.approx(1.0, abs=1e-9)
            assert sorted(rdoc["models"]) == sorted(zdoc["models"]) == ["alpha", "beta", "gamma.plain"]
        # drift: a plan whose baseline is single-image requests, then a
        # shifted size mix of 3-row requests
        from keystone_tpu_torch.zoo.optimizer import ChipBudget, plan_placement

        profiles = zoo.profiles()
        zoo.apply_plan(plan_placement(profiles, ChipBudget()), profiles=profiles)
        for _ in range(zoo.drift.min_rows):
            code, _ = _post(own + "/predict", {"instances": [image.tolist()] * 3})
            assert code == 200
        doc = json.loads(_get(own + "/driftz")[1])
        assert doc["drifted"] == ["alpha"] and doc["recommendation"]["changes"] is not None
        rdoc = json.loads(_get(url + "/driftz")[1])
        assert rdoc["drifted"] == ["alpha"]
    finally:
        router.stop()
        zoo.close()
        srv.stop()


# -- the entry ------------------------------------------------------------------


def test_zoo_entry_in_a_subprocess_registers_and_exits_0_on_sigterm(spec_path):
    router = RouterServer(registry=MetricsRegistry(), probe_interval_s=0.2).start()
    url = router.url().rstrip("/")
    code = ("from keystone_tpu_torch.gateway.http import main; import sys; "
            f"sys.exit(main(['--zoo', {spec_path!r}, '--max-resident', '2', '--optimize', "
            f"'--register', {url!r}], device='cpu'))")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    try:
        lines = []
        reader = threading.Thread(target=lambda: lines.extend(
            json.loads(proc.stdout.readline()) for _ in range(2)), daemon=True)
        reader.start()
        reader.join(60)
        plan, first = lines
        assert sorted(p["model"] for p in plan["plan"]["placements"]) == [
            "alpha", "beta", "gamma.plain"]
        assert first["role"] == "gateway" and first["models"] == ["alpha", "beta", "gamma.plain"]
        _wait(lambda: len(router.fleet) == 1, "the zoo's registration", timeout=30)
        replica = router.fleet.replicas()[0]
        assert sorted(replica.models) == ["alpha", "beta", "gamma.plain"]
        code_, doc = _post(url + "/predict/beta", {"instances": [_image(2).tolist()]})
        assert code_ == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert len(router.fleet) == 0
    finally:
        router.stop()
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
