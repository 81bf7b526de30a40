"""The online model lifecycle of ``keystone_tpu_torch`` on the CPU, held
against the JAX package's: the promotion policy over a grid of gate
inputs, the deterministic canary fraction, the teacher, the streaming
refit's normal equations and solved head (rtol 1e-4 / atol 1e-5), both
controllers walking the same feedback and ticks (stage sequences, the
poisoned rollback within one tick of its shadow start, the bitwise
rollback to the incumbent), the pool's and gateway's lifecycle hooks and
the engines a swap retires, the HTTP surface (``/feedback``,
``/lifecyclez`` and their typed errors, body for body) and the
``serve-gateway --refit`` and ``serve-lifecycle`` entries. Every HTTP
call, future, join and subprocess has its own timeout."""

import contextlib
import io
import itertools
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.gateway import Gateway as JGateway
from keystone_tpu.gateway import GatewayServer as JGatewayServer
from keystone_tpu.gateway import pool as jpool
from keystone_tpu.lifecycle import LifecycleManager as JManager
from keystone_tpu.lifecycle import policy as jpolicy
from keystone_tpu.lifecycle import teacher as jteacher
from keystone_tpu.lifecycle.controller import LifecycleController as JController
from keystone_tpu.lifecycle.refit import RefitAccumulator as JRefit
from keystone_tpu.loadgen import faults as jfaults
from keystone_tpu.serving import bench as jbench
from keystone_tpu_torch.gateway import Gateway, GatewayServer
from keystone_tpu_torch.gateway import pool as tpool
from keystone_tpu_torch.lifecycle import LifecycleManager
from keystone_tpu_torch.lifecycle import cli as tlcli
from keystone_tpu_torch.lifecycle import policy as tpolicy
from keystone_tpu_torch.lifecycle import teacher as tteacher
from keystone_tpu_torch.lifecycle.controller import LifecycleController
from keystone_tpu_torch.lifecycle.refit import RefitAccumulator
from keystone_tpu_torch.loadgen import faults
from keystone_tpu_torch.observability.registry import MetricsRegistry
from keystone_tpu_torch.serving import bench as tbench
from keystone_tpu_torch.serving.aot import AotStore
from keystone_tpu_torch.serving.engine import CompiledPipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HTTP_TIMEOUT_S = 10
RESULT_TIMEOUT_S = 30
D, HIDDEN, DEPTH, SEED = 6, 8, 2, 1
HEAD_SEED = 55
# the JAX controller tests' gates: small evidence counts, one healthy
# canary tick promotes
CFG = dict(min_shadow_pairs=2, min_canary_requests=2, promote_after_healthy_ticks=1)
RTOL_W, ATOL_W = 1e-4, 1e-5
RTOL_G = 1e-5


@pytest.fixture(autouse=True)
def no_faults():
    faults.disarm_all()
    jfaults.disarm_all()
    yield
    faults.disarm_all()
    jfaults.disarm_all()


def _labeled(n, seed=21):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, D)).astype(np.float32)
    return X, jteacher.teacher_labels(X, D, HIDDEN, DEPTH, seed=SEED, head_seed=HEAD_SEED)


def _post(url, doc, timeout=HTTP_TIMEOUT_S):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, timeout=HTTP_TIMEOUT_S):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# -- policy, canary fraction, teacher ------------------------------------------

_ERRS = (None, 0.01, 0.5, 0.6, 5.0)
_GRID = [
    dict(shadow_pairs=sp, shadow_max_abs=mx, canary_requests=cr, canary_errors=ce,
         slo_breaching=slo, candidate_err=c, incumbent_err=(None if c is None else 0.5))
    for sp, mx, cr, ce, slo, c in itertools.product(
        (0, 4), (0.0, 1.0), (0, 4), (0, 2), (False, True), _ERRS)
]


@pytest.mark.parametrize("stage,streak", [
    ("idle", 0), ("candidate", 0), ("shadow", 0), ("canary", 0), ("canary", 1),
    ("promoted", 0), ("rolled_back", 0)])
def test_policy_tick_equals_jax_over_a_grid(stage, streak):
    kw = dict(min_shadow_pairs=4, max_shadow_diff=0.5, min_canary_requests=4,
              max_canary_error_rate=0.25, promote_after_healthy_ticks=2)
    for inputs in _GRID:
        got, why = tpolicy.tick(tpolicy.PolicyState(stage, streak),
                                tpolicy.GateInputs(**inputs), tpolicy.PromotionConfig(**kw))
        want, jwhy = jpolicy.tick(jpolicy.PolicyState(stage, streak),
                                  jpolicy.GateInputs(**inputs), jpolicy.PromotionConfig(**kw))
        assert (got.stage, got.healthy_streak, why) == (want.stage, want.healthy_streak, jwhy), inputs
    assert tpolicy.STAGES == jpolicy.STAGES
    with pytest.raises(ValueError):
        tpolicy.PromotionConfig(promote_err_ratio=2.0, rollback_err_ratio=1.5)


@pytest.mark.parametrize("fraction", [0.0, 0.1, 0.25, 0.5, 1.0])
def test_canary_takes_equals_jax(fraction):
    got = [tpool.canary_takes(i, fraction) for i in range(10_000)]
    assert got == [jpool.canary_takes(i, fraction) for i in range(10_000)]
    assert sum(got) == int(10_000 * fraction)


@pytest.mark.parametrize("head_seed", [None, 7])
def test_teacher_labels_are_bitwise_jax(head_seed):
    X = np.random.default_rng(3).standard_normal((33, 16)).astype(np.float32)
    got = tteacher.teacher_labels(X, 16, 24, 3, seed=2, head_seed=head_seed)
    want = jteacher.teacher_labels(X, 16, 24, 3, seed=2, head_seed=head_seed)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    with pytest.raises(ValueError):
        tteacher.teacher_labels(X[:, :4], 16, 24, 3)


# -- the streaming refit ---------------------------------------------------------


@pytest.fixture(scope="module")
def splits():
    """The demo model split at its head, in both packages, from one seed."""
    return (tbench.build_split_pipeline(d=D, hidden=HIDDEN, depth=DEPTH, seed=SEED, device="cpu"),
            jbench.build_split_pipeline(d=D, hidden=HIDDEN, depth=DEPTH, seed=SEED))


def _state(acc):
    G, AY, n, seen = acc.snapshot()
    return np.asarray(G), np.asarray(AY), n, seen


@pytest.mark.parametrize("poisoned", [False, True])
def test_refit_accumulator_equals_jax(splits, poisoned):
    """The same feedback batches (uneven, the last chunk partial) fold
    into equal normal equations and holdouts, and solve to the same head;
    a snapshot restores exactly."""
    (tbase, _, _), (jbase, _, _) = splits
    kw = dict(feature_dim=HIDDEN, out_dim=D, lam=1e-3, chunk=16, holdout_every=5, holdout_cap=24)
    tacc, jacc = RefitAccumulator(tbase, device="cpu", **kw), JRefit(jbase, **kw)
    X, Y = _labeled(157)
    if poisoned:  # the first chunk of each accumulator's targets
        faults.arm("lifecycle.refit.poison", count=1, match={"model": "default"})
        jfaults.arm("lifecycle.refit.poison", count=1, match={"model": "default"})
    for lo, hi in ((0, 40), (40, 41), (41, 157)):
        assert tacc.add(X[lo:hi], Y[lo:hi]) == jacc.add(X[lo:hi], Y[lo:hi])
    if poisoned:
        assert faults.get_injector().fired_count("lifecycle.refit.poison") == 1
    tG, tAY, tn, tseen = _state(tacc)
    jG, jAY, jn, jseen = _state(jacc)
    assert (tn, tseen, tacc.n_holdout) == (jn, jseen, jacc.n_holdout) == (157 - 24, 157, 24)
    np.testing.assert_allclose(tG, jG, rtol=RTOL_G, atol=RTOL_G)
    np.testing.assert_allclose(tAY, jAY, rtol=RTOL_G, atol=RTOL_G)
    assert all(np.array_equal(a, b) for a, b in zip(tacc._hold_x, jacc._hold_x))
    assert all(np.array_equal(a, b) for a, b in zip(tacc._hold_y, jacc._hold_y))
    tW, tb = tacc.solve()
    jW, jb = jacc.solve()
    if poisoned:
        # targets scaled by -40 in one chunk: a garbage head, unlike the
        # clean one (the bar below is for the clean solve)
        clean = RefitAccumulator(tbase, device="cpu", **kw)
        clean.add(X, Y)
        assert float((tW - clean.solve()[0]).abs().max()) > 1.0
    else:
        np.testing.assert_allclose(tW.numpy(), np.asarray(jW), rtol=RTOL_W, atol=ATOL_W)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=RTOL_W, atol=ATOL_W)
    # the solve leaves the running state as it was
    assert np.array_equal(_state(tacc)[0], tG)
    # snapshot / restore round trip: later feedback is discarded
    snap = tacc.snapshot()
    tacc.add(*_labeled(40, seed=5))
    assert tacc.n_accumulated > tn
    tacc.restore(snap)
    assert _state(tacc)[2:] == (tn, tseen) and np.array_equal(_state(tacc)[0], tG)
    assert torch.equal(tacc.solve()[0], tW)


def test_refit_holdout_errors_and_guards_equal_jax(splits):
    (tbase, tW0, tb0), (jbase, jW0, jb0) = splits
    tacc = RefitAccumulator(tbase, HIDDEN, D, device="cpu", lam=1e-5, chunk=16)
    jacc = JRefit(jbase, HIDDEN, D, lam=1e-5, chunk=16)
    assert tacc.holdout_errors(None, None) == (None, None)
    with pytest.raises(RuntimeError, match="no feedback"):
        tacc.solve()
    with pytest.raises(ValueError):
        tacc.add(np.zeros((3, D)), np.zeros((3, D + 1)))
    with pytest.raises(ValueError):
        RefitAccumulator(tbase, HIDDEN, D, device="cpu", chunk=0)
    X, Y = _labeled(600)
    tacc.add(X, Y)
    jacc.add(X, Y)
    tW, tb = tacc.solve()
    jW, jb = jacc.solve()
    tcand = tbase.and_then(tbench.affine_head(tW, tb, device="cpu"))
    tstale = tbase.and_then(tbench.affine_head(tW0, tb0, device="cpu"))
    jcand = jbase.and_then(jbench.affine_head(jW, jb))
    jstale = jbase.and_then(jbench.affine_head(jW0, jb0))
    got, want = tacc.holdout_errors(tcand, tstale), jacc.holdout_errors(jcand, jstale)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-7)
    # the refit recovers the teacher's head: far better than the stale one
    assert got[0] < got[1] * 1e-2


# -- the controllers -------------------------------------------------------------


def _tgateway(split, **kw):
    base, W0, b0 = split
    gw = Gateway(base.and_then(tbench.affine_head(W0, b0, device="cpu")), buckets=(4,),
                 n_lanes=1, max_delay_ms=1.0, warmup_example=torch.zeros(D), device="cpu",
                 name="t-lifecycle", **kw)
    return base, gw


def _jgateway(split):
    base, W0, b0 = split
    return base, JGateway(base.and_then(jbench.affine_head(W0, b0)), buckets=(4,), n_lanes=1,
                          max_delay_ms=1.0, warmup_example=jnp.zeros((D,), jnp.float32),
                          name="j-lifecycle")


def _tcontroller(gw, base, **kw):
    kw.setdefault("canary_fraction", 0.5)
    kw.setdefault("min_refit_samples", 32)
    return LifecycleController(gw, base=base, head_builder=partial(tbench.affine_head, device="cpu"),
                               feature_dim=HIDDEN, out_dim=D, name="m",
                               config=tpolicy.PromotionConfig(**CFG), **kw)


def _jcontroller(gw, base, **kw):
    kw.setdefault("canary_fraction", 0.5)
    kw.setdefault("min_refit_samples", 32)
    return JController(gw, base=base, head_builder=jbench.affine_head, feature_dim=HIDDEN,
                       out_dim=D, name="m", config=jpolicy.PromotionConfig(**CFG), **kw)


def _walk(gw, ctrl, examples, max_ticks=25):
    """Tick while feeding live traffic (shadow pairs and canary requests
    need requests through the pool's hooks) until a terminal stage;
    returns the stages seen, consecutive repeats folded."""
    seen = [ctrl.status()["state"]]
    status = ctrl.tick()
    for _ in range(max_ticks):
        if seen[-1] != status["state"]:
            seen.append(status["state"])
        if status["state"] in ("promoted", "rolled_back"):
            break
        for i in range(4):
            gw.predict(examples[i % len(examples)]).result(timeout=RESULT_TIMEOUT_S)
        time.sleep(0.05)  # let shadow/canary completion callbacks land
        status = ctrl.tick()
    return seen, status


def test_controllers_promote_alike_and_roll_back_bitwise(splits):
    examples = np.random.default_rng(3).standard_normal((8, D)).astype(np.float32)
    X, Y = _labeled(200)
    (tbase, tgw), (jbase, jgw) = _tgateway(splits[0]), _jgateway(splits[1])
    walks = {}
    with tgw, jgw:
        for side, gw, ctrl in (("port", tgw, _tcontroller(tgw, tbase)),
                               ("jax", jgw, _jcontroller(jgw, jbase))):
            try:
                before = np.asarray(gw.predict(examples[0]).result(timeout=RESULT_TIMEOUT_S))
                ctrl.add_feedback(X, Y)
                seen, status = _walk(gw, ctrl, examples)
                walks[side] = (seen, status["version"], status["promotions"])
                assert status["errors"]["candidate"] < status["errors"]["incumbent"]
                after = np.asarray(gw.predict(examples[0]).result(timeout=RESULT_TIMEOUT_S))
                assert not np.array_equal(after, before)
                # the operator's rollback un-promotes: the incumbent's
                # graphs recaptured from the identical fitted pipeline
                status = ctrl.force_rollback("test")
                assert status["state"] == "rolled_back"
                restored = np.asarray(gw.predict(examples[0]).result(timeout=RESULT_TIMEOUT_S))
                assert np.array_equal(restored, before), side
            finally:
                ctrl.close()
    assert walks["port"] == walks["jax"] == (["idle", "shadow", "canary", "promoted"], 1, 1)


def test_poisoned_refit_rolls_back_within_one_tick_as_in_jax(splits):
    probe = np.linspace(-1, 1, D).astype(np.float32)
    X, Y = _labeled(200)
    (tbase, tgw), (jbase, jgw) = _tgateway(splits[0]), _jgateway(splits[1])
    got = {}
    with tgw, jgw:
        for side, gw, ctrl, inj in (("port", tgw, _tcontroller(tgw, tbase), faults),
                                    ("jax", jgw, _jcontroller(jgw, jbase), jfaults)):
            try:
                before = np.asarray(gw.predict(probe).result(timeout=RESULT_TIMEOUT_S))
                inj.get_injector().arm("lifecycle.refit.poison", count=100)
                ctrl.add_feedback(X, Y)
                first = ctrl.tick()["state"]
                status = ctrl.tick()
                got[side] = (first, status["state"], status["last_reason"],
                             status["refit"]["accumulated"])
                after = np.asarray(gw.predict(probe).result(timeout=RESULT_TIMEOUT_S))
                assert np.array_equal(after, before), side
                inj.get_injector().disarm("lifecycle.refit.poison")
                # clean feedback after the rollback makes a promotable v2
                ctrl.add_feedback(*_labeled(200, seed=33))
                status = ctrl.tick()
                assert (status["state"], status["version"]) == ("shadow", 2), side
            finally:
                ctrl.close()
    assert got["port"] == got["jax"] == ("shadow", "rolled_back", "accuracy", 0)


def test_no_candidate_until_min_refit_samples(splits):
    tbase, tgw = _tgateway(splits[0])
    with tgw:
        ctrl = _tcontroller(tgw, tbase, min_refit_samples=500)
        try:
            ctrl.add_feedback(*_labeled(100))
            status = ctrl.tick()
            assert (status["state"], status["version"]) == ("idle", 0)
            assert status["refit"]["accumulated"] == 100 - 13  # every 8th row held out
            with pytest.raises(ValueError):
                ctrl.add_feedback(np.zeros((2, D)), np.zeros((3, D)))
        finally:
            ctrl.close()
        with pytest.raises(RuntimeError, match="closed"):
            ctrl.add_feedback(*_labeled(4))


# -- the pool's and the gateway's hooks ------------------------------------------


class _Recorder:
    """A duck-typed mirror and canary: records what the pool hands it."""

    def __init__(self, fraction=0.5):
        self.observed, self.routed, self._seq = [], [], itertools.count()
        self.fraction = fraction

    def observe(self, example, primary):
        self.observed.append((example, primary))

    def takes(self):
        return tpool.canary_takes(next(self._seq), self.fraction)

    def route(self, example, parent_span_id, out, fallback):
        self.routed.append(example)
        fallback()


def test_pool_mirror_and_canary_hooks(splits):
    tbase, tgw = _tgateway(splits[0])
    with tgw:
        pool = tgw.pool
        assert pool.pick() is pool.lanes[0] and pool.pick(exclude=pool.lanes) is None
        mirror, canary = _Recorder(), _Recorder(0.25)
        pool.set_mirror(mirror)
        pool.set_canary(canary)
        xs = np.random.default_rng(0).standard_normal((8, D)).astype(np.float32)
        outs = [pool.submit(x).result(timeout=RESULT_TIMEOUT_S) for x in xs]
        assert len(mirror.observed) == 8 and len(canary.routed) == 2
        assert all(p.done() for _, p in mirror.observed)
        pool.set_mirror(None)
        pool.set_canary(None)
        pool.submit(xs[0]).result(timeout=RESULT_TIMEOUT_S)
        assert len(mirror.observed) == 8
        assert np.array_equal(np.asarray(outs[0]), np.asarray(pool.submit(xs[0]).result(RESULT_TIMEOUT_S)))


def test_model_batcher_swap_model_and_retired_engines(splits, monkeypatch, tmp_path):
    """``build_model_batcher`` serves another fitted pipeline on the
    gateway's config; ``swap_model`` rotates every lane onto it and back;
    every engine a swap displaced, and a closed candidate's, is retired
    once its windows computed, and every window drops its hold."""
    retired = []
    real_retire = CompiledPipeline.retire

    def spy(self):
        retired.append((self, self._windows))
        return real_retire(self)

    monkeypatch.setattr(CompiledPipeline, "retire", spy)
    (tbase, W0, b0), _ = splits
    _, gw = _tgateway(splits[0], pipeline_depth=2)
    W1 = np.asarray(W0) * 0.5
    other = tbase.and_then(tbench.affine_head(W1, b0, device="cpu"))
    x = np.linspace(-1, 1, D).astype(np.float32)
    with gw:
        want = other._batch_run(torch.as_tensor(x[None]))[0].numpy()
        mb = gw.build_model_batcher(other, name="cand")
        assert mb.engine.buckets == gw.buckets and mb.pipeline_depth == 2
        assert np.allclose(mb.submit(x).result(timeout=RESULT_TIMEOUT_S), want, atol=1e-6)
        mb.close()
        assert mb.engine.retire() == 0 and retired[-1] == (mb.engine, 0)
        incumbent = gw.fitted
        before = np.asarray(gw.predict(x).result(timeout=RESULT_TIMEOUT_S))
        old = [lane.engine for lane in gw.pool.lanes]
        assert gw.swap_model(other) and gw.fitted is other
        assert [e for e, _ in retired[-len(old):]] == old
        assert np.allclose(gw.predict(x).result(timeout=RESULT_TIMEOUT_S), want, atol=1e-6)
        assert gw.swap_model(incumbent)
        assert np.array_equal(np.asarray(gw.predict(x).result(timeout=RESULT_TIMEOUT_S)), before)
        assert all(lane.engine._windows == 0 for lane in gw.pool.lanes)
        # a candidate on its own store (they raised before the port had
        # serving/aot.py); swap_model swaps the store with the model
        store = AotStore(str(tmp_path / "aot"), registry=MetricsRegistry(), namespace="cand/v1")
        cand = gw.build_model_batcher(other, name="c", aot_store=store)
        assert {b: v["status"] for b, v in cand.engine.aot_report().items()} == {
            b: "saved" for b in gw.buckets}
        cand.close()
        assert gw.swap_model(other, aot_store=store) and gw._aot_store is store
        assert all(v["status"] == "hit" for lane in gw.pool.lanes
                   for v in lane.engine.aot_report().values())
        assert gw.swap_model(incumbent, aot_store=None) and gw._aot_store is None
        assert np.array_equal(np.asarray(gw.predict(x).result(timeout=RESULT_TIMEOUT_S)), before)
    assert not gw.swap_model(other) and gw.fitted is incumbent  # closed: nothing rotates


@pytest.mark.parametrize("depth", [0, 2])
def test_every_window_drops_its_engine_hold(splits, depth):
    """Served and failed (``engine.dispatch.error``) windows both give
    up their hold on the engine, serial and pipelined."""
    (tbase, W0, b0), _ = splits
    eng = tbase.and_then(tbench.affine_head(W0, b0, device="cpu")).compiled((2, 4), device="cpu")
    from keystone_tpu_torch.serving import MicroBatcher

    mb = MicroBatcher(eng, max_delay_ms=20.0, pipeline_depth=depth)
    xs = np.random.default_rng(1).standard_normal((6, D)).astype(np.float32)
    try:
        for f in [mb.submit(x) for x in xs]:
            f.result(timeout=RESULT_TIMEOUT_S)
        faults.arm("engine.dispatch.error", count=1)
        with pytest.raises(faults.FaultInjected):
            mb.submit(xs[0]).result(timeout=RESULT_TIMEOUT_S)
    finally:
        mb.close()
    assert eng._windows == 0 and eng.retire() == 0 and eng._retired


def test_retire_releases_with_the_last_window(splits, monkeypatch):
    """``retire`` does not wait: with windows still computing on the
    engine, the last one to finish releases its graphs, once."""
    (tbase, W0, b0), _ = splits
    eng = tbase.and_then(tbench.affine_head(W0, b0, device="cpu")).compiled((2, 4), device="cpu")
    released = []
    monkeypatch.setattr(eng, "release_graphs", lambda: released.append(eng._windows) or 0)
    eng.hold_window()
    eng.hold_window()
    assert eng.retire() == 0 and released == []
    eng.drop_window()
    assert released == []
    eng.drop_window()
    assert released == [0]


def test_lifecycle_hooks_raise_under_an_engine_factory(splits):
    """As in JAX: a zoo CSE unit's gateway builds no engine from a
    fitted pipeline."""
    (tbase, W0, b0), (jbase, jW0, jb0) = splits
    tfit = tbase.and_then(tbench.affine_head(W0, b0, device="cpu"))
    gw = Gateway(tfit, buckets=(4,), n_lanes=1, device="cpu", name="t-factory",
                 engine_factory=lambda buckets: lambda name: tfit.compiled(buckets, name=name,
                                                                          device="cpu"))
    with gw:
        with pytest.raises(RuntimeError, match="engine-factory"):
            gw.build_model_batcher(tfit, name="c")
        with pytest.raises(RuntimeError, match="engine-factory"):
            gw.swap_model(tfit)
    jfit = jbase.and_then(jbench.affine_head(jW0, jb0))
    jgw = JGateway(jfit, buckets=(4,), n_lanes=1, name="j-factory",
                   engine_factory=lambda buckets: lambda name: jfit.compiled(buckets, name=name))
    with jgw:
        with pytest.raises(RuntimeError, match="engine-factory"):
            jgw.swap_model(jfit)


# -- HTTP and the entries --------------------------------------------------------


def _bodies(url_t, url_j, method, path, doc=None):
    call = (lambda u: _post(u + path, doc)) if method == "POST" else (lambda u: _get(u + path))
    return call(url_t), call(url_j)


def _same_but_errors(got, want, status_of):
    """Equal responses but for the held-out errors, which are compared
    within a tolerance (two solvers' float32 rounding)."""
    errs = [status_of(doc).pop("errors") for doc in (got[1], want[1])]
    assert got == want, (got, want)
    for key in ("candidate", "incumbent"):
        np.testing.assert_allclose(errs[0][key], errs[1][key], rtol=1e-3, atol=1e-7)


def test_feedback_and_lifecyclez_bodies_equal_jax(splits):
    (tbase, tgw), (jbase, jgw) = _tgateway(splits[0]), _jgateway(splits[1])
    tmgr, jmgr = LifecycleManager(), JManager()
    tmgr.add(_tcontroller(tgw, tbase, min_refit_samples=8), default=True)
    jmgr.add(_jcontroller(jgw, jbase, min_refit_samples=8), default=True)
    servers = [GatewayServer(tgw, lifecycle=tmgr).start(), JGatewayServer(jgw, lifecycle=jmgr).start(),
               GatewayServer(tgw).start(), JGatewayServer(jgw).start()]
    ut, uj, bare_t, bare_j = (s.url().rstrip("/") for s in servers)
    X, Y = _labeled(24)
    try:
        # the typed errors, body for body
        for url_pair, method, path, doc in (
            ((bare_t, bare_j), "POST", "/feedback", {"instances": X.tolist(), "labels": Y.tolist()}),
            ((bare_t, bare_j), "GET", "/lifecyclez", None),
            ((bare_t, bare_j), "POST", "/lifecyclez", {"tick": True}),
            ((ut, uj), "POST", "/feedback/nope", {"instances": X.tolist(), "labels": Y.tolist()}),
            ((ut, uj), "POST", "/feedback", {"instances": X.tolist()}),
            ((ut, uj), "POST", "/feedback", {"instances": X.tolist(), "labels": Y[:3].tolist()}),
            ((ut, uj), "POST", "/lifecyclez", {}),
            ((ut, uj), "POST", "/lifecyclez", {"rollback": True, "model": "nope"}),
        ):
            got, want = _bodies(*url_pair, method, path, doc)
            assert got == want and got[0] in (400, 404), (path, got, want)
        # the same feedback and ticks: equal documents
        for path in ("/feedback", "/feedback/m"):
            got, want = _bodies(ut, uj, "POST", path, {"instances": X.tolist(), "labels": Y.tolist()})
            assert got == want == (200, {"queued": 24, "model": "m"})
        assert _bodies(ut, uj, "GET", "/lifecyclez") == ((200, tmgr.status()), (200, jmgr.status()))
        got, want = _bodies(ut, uj, "GET", "/lifecyclez")
        assert got == want, (got, want)
        got, want = _bodies(ut, uj, "POST", "/lifecyclez", {"tick": True})
        _same_but_errors(got, want, lambda doc: doc["ticked"]["m"])
        assert got[1]["ticked"]["m"]["state"] == "shadow"
        got, want = _bodies(ut, uj, "POST", "/lifecyclez", {"rollback": True})
        _same_but_errors(got, want, lambda doc: doc["rolled_back"])
        assert got[1]["rolled_back"]["last_reason"] == "manual"
    finally:
        for s in servers:
            s.stop()
        tmgr.close()
        jmgr.close()
        tgw.close()
        jgw.close()


def test_serve_lifecycle_reads_a_live_port_gateway(splits):
    tbase, tgw = _tgateway(splits[0])
    mgr = LifecycleManager()
    mgr.add(_tcontroller(tgw, tbase, min_refit_samples=8), default=True)
    srv = GatewayServer(tgw, lifecycle=mgr).start()
    url = srv.url().rstrip("/")

    def run(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = tlcli.main(argv)
        return rc, out.getvalue()

    try:
        rc, out = run(["status", "--url", url])
        assert rc == 0 and json.loads(out) == mgr.status()
        mgr.get().add_feedback(*_labeled(24))
        rc, out = run(["tick", "--url", url])
        assert rc == 0 and json.loads(out)["ticked"]["m"]["state"] == "shadow"
        rc, out = run(["rollback", "--url", url, "--model", "m"])
        assert rc == 0 and json.loads(out)["rolled_back"]["state"] == "rolled_back"
        assert run(["rollback", "--url", url, "--model", "nope"])[0] == 1
    finally:
        srv.stop()
        mgr.close()
        tgw.close()
    assert run(["status", "--url", url, "--timeout", "2"])[0] == 1


def test_serve_gateway_refit_entry_serves_the_lifecycle_and_exits_on_sigterm():
    code = ("import sys; sys.path.insert(0, %r); from keystone_tpu_torch.__main__ import main; "
            "sys.exit(main(sys.argv[1:], device='cpu'))" % ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "serve-gateway", "--gateway-port", "0", "--refit", "--d", "6",
         "--hidden", "8", "--depth", "2", "--buckets", "4", "--lanes", "1",
         "--refit-interval-s", "0", "--refit-min-samples", "8", "--canary-fraction", "0.5"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
    watchdog = threading.Timer(60.0, proc.kill)  # a hung start ends the reads below
    watchdog.start()
    try:
        line = proc.stdout.readline()
        url = json.loads(line)["listening"]
        assert "POST /feedback, GET|POST /lifecyclez" in proc.stdout.readline()
        watchdog.cancel()
        code_, doc = _get(url + "/lifecyclez")
        assert code_ == 200 and doc["models"]["default"]["state"] == "idle"
        X = np.random.default_rng(0).standard_normal((16, 6)).astype(np.float32)
        Y = tteacher.teacher_labels(X, 6, 8, 2, head_seed=7)
        assert _post(url + "/feedback", {"instances": X.tolist(), "labels": Y.tolist()}) == (
            200, {"queued": 16, "model": "default"})
        code_, doc = _post(url + "/lifecyclez", {"tick": True})
        assert code_ == 200 and doc["ticked"]["default"]["state"] == "shadow"
        assert _post(url + "/predict", {"instances": X[:2].tolist()})[0] == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()


def test_zoo_serves_an_attached_lifecycle(tmp_path):
    """Zoo mode: a controller over a solo unit's gateway, attached with
    ``ModelZoo.attach_lifecycle``, answers ``/feedback/<model>`` and
    ``/lifecyclez`` on the zoo's frontend, as the JAX zoo's does."""
    from keystone_tpu_torch.zoo import ModelZoo, load_zoo_spec

    spec = tmp_path / "zoo.json"
    spec.write_text(json.dumps({"models": [
        {"name": "m", "d": D, "hidden": HIDDEN, "depth": DEPTH, "seed": SEED, "buckets": [4],
         "lanes": 1}]}))
    zoo = ModelZoo(load_zoo_spec(str(spec), device="cpu"), device="cpu")
    zoo.host()
    base, _, _ = tbench.build_split_pipeline(d=D, hidden=HIDDEN, depth=DEPTH, seed=SEED, device="cpu")
    mgr = LifecycleManager()
    mgr.add(_tcontroller(zoo.gateway_for("m"), base, min_refit_samples=8), default=True)
    zoo.attach_lifecycle(mgr)
    srv = GatewayServer(zoo=zoo).start()
    url = srv.url().rstrip("/")
    X, Y = _labeled(24)
    try:
        assert _get(url + "/lifecyclez") == (200, mgr.status())
        assert _post(url + "/feedback/m", {"instances": X.tolist(), "labels": Y.tolist()}) == (
            200, {"queued": 24, "model": "m"})
        code, doc = _post(url + "/feedback/x", {"instances": X.tolist(), "labels": Y.tolist()})
        assert (code, doc["error"], doc["known"]) == (404, "unknown_lifecycle_model", ["m"])
        code, doc = _post(url + "/lifecyclez", {"tick": True})
        assert code == 200 and doc["ticked"]["m"]["state"] == "shadow"
        assert zoo.lifecycle_status()["models"]["m"]["version"] == 1
    finally:
        srv.stop()
        mgr.close()
        zoo.close()
