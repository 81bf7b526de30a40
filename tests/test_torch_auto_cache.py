"""``workflow/auto_cache.py`` and ``AutoCachingOptimizer`` on the CPU,
against the JAX package: the reference suite's 13-node plan with its
aggressive selection and its six-budget greedy staircase
(tests/workflow/test_auto_cache.py:197-230, AutocCacheRuleSuite.scala), the
same cache sets as JAX's rule for the same graphs and profiles,
``add_caches``, ``profile_nodes`` on a CPU graph, and a fit under the
auto-caching optimizer."""

import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keystone_tpu.parallel.dataset import Dataset as JDataset
from keystone_tpu.workflow import auto_cache as jac
from keystone_tpu.workflow import graph as jgraph
from keystone_tpu.workflow import operators as jops
from keystone_tpu_torch.ops.stats.nodes import ColumnSampler
from keystone_tpu_torch.ops.util.cacher import Cacher
from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.workflow import AutoCachingOptimizer, DefaultOptimizer
from keystone_tpu_torch.workflow import auto_cache as tac
from keystone_tpu_torch.workflow import graph as tgraph
from keystone_tpu_torch.workflow import operators as tops
from keystone_tpu_torch.workflow.api import Transformer
from keystone_tpu_torch.workflow.executor import PipelineEnv


@pytest.fixture(autouse=True)
def reset_port_env():
    PipelineEnv.get_or_create().reset()
    yield
    PipelineEnv.get_or_create().reset()


def _ops(pkg):
    """The JAX test's operators, built on either package's
    ``TransformerOperator``."""

    class Counting(pkg.TransformerOperator):
        def __init__(self, weight=1):
            self.weight = weight
            self.calls = 0

        def single_transform(self, inputs):
            return inputs[0]

        def batch_transform(self, inputs):
            self.calls += 1
            return inputs[0]

        def eq_key(self):
            return id(self)

    class Plus(pkg.TransformerOperator):
        def __init__(self, plus, weight=1):
            self.plus = plus
            self.weight = weight

        def single_transform(self, inputs):
            return inputs[0] + self.plus

        def batch_transform(self, inputs):
            ds = inputs[0]
            return type(ds).from_array(ds.padded() + self.plus, n=ds.n)

        def eq_key(self):
            return ("plus", self.plus)

    class WeightedEstimatorOp(pkg.TransformerOperator):
        """Stands in for the reference's weight-4 estimator node (only the
        weight matters to the rule)."""

        weight = 4

        def single_transform(self, inputs):
            return inputs[0]

        def batch_transform(self, inputs):
            return inputs[0]

        def eq_key(self):
            return id(self)

    return Counting, Plus, WeightedEstimatorOp


PKGS = {
    "jax": (jgraph, jops, jac, lambda a: JDataset.of(jnp.asarray(a))),
    "torch": (tgraph, tops, tac, lambda a: Dataset.of(torch.as_tensor(a))),
}


def _diamond_graph(which):
    """data -> a -> (b, c), b and c both consuming a (a runs twice)."""
    graph, ops, _, ds_of = PKGS[which]
    Counting, _, _ = _ops(ops)
    g, d = graph.EMPTY_GRAPH.add_node(ops.DatasetOperator(ds_of(np.ones((8, 2), np.float32))), ())
    g, a = g.add_node(Counting(), (d,))
    g, b = g.add_node(Counting(), (a,))
    g, c = g.add_node(Counting(weight=3), (a,))
    g, _ = g.add_sink(b)
    g, _ = g.add_sink(c)
    return g, {"data": d, "a": a, "b": b, "c": c}


def _reference_plan(which):
    """AutocCacheRuleSuite.scala:27-73: train branch 0 -> 1 -> 2 -> (3, 4)
    -> 5 -> estimator (weight 4) -> delegating; test branch 8..12 below the
    source."""
    graph, ops, ac, ds_of = PKGS[which]
    _, Plus, WeightedEstimatorOp = _ops(ops)
    nid = {i: graph.NodeId(i) for i in range(13)}
    g = graph.Graph(
        sources=frozenset({graph.SourceId(0)}),
        sink_dependencies={graph.SinkId(0): nid[7]},
        operators={
            nid[0]: ops.DatasetOperator(ds_of(np.arange(8, dtype=np.float32)[:, None])),
            nid[1]: Plus(1), nid[2]: Plus(2), nid[3]: Plus(3), nid[4]: Plus(4),
            nid[5]: Plus(5), nid[6]: WeightedEstimatorOp(), nid[7]: ops.DelegatingOperator(),
            nid[8]: Plus(8), nid[9]: Plus(9), nid[10]: Plus(10), nid[11]: Plus(11),
            nid[12]: Plus(12),
        },
        dependencies={
            nid[0]: (), nid[1]: (nid[0],), nid[2]: (nid[1],), nid[3]: (nid[2],),
            nid[4]: (nid[2],), nid[5]: (nid[3], nid[4]), nid[6]: (nid[5],),
            nid[7]: (nid[6], nid[12]), nid[8]: (graph.SourceId(0),), nid[9]: (nid[8],),
            nid[10]: (nid[9],), nid[11]: (nid[9],), nid[12]: (nid[10], nid[11]),
        },
    )
    P = ac.Profile
    profiles = {
        nid[0]: P(10, float("inf"), 0), nid[1]: P(10, 50, 0), nid[2]: P(30, 200, 0),
        nid[3]: P(20, 1000, 0), nid[4]: P(20, 1000, 0), nid[5]: P(20, 100, 0),
    }
    return g, nid, profiles


def _ints(nodes):
    return {n.id for n in nodes}


def test_runs_and_cached_runtime_match_jax():
    for which in PKGS:
        _, _, ac, _ = PKGS[which]
        g, ids = _diamond_graph(which)
        weights = ac.get_node_weights(g)
        # a feeds b (weight 1) and c (weight 3): 4 evaluations
        assert ac.get_runs(g, set(), weights)[ids["a"]] == 4
        prof = {ids["a"]: ac.Profile(100, 10, 0)}
        assert ac.estimate_cached_runtime(g, set(), prof, weights) == 400
        assert ac.estimate_cached_runtime(g, {ids["a"]}, prof, weights) == 100
    g, nid, _ = _reference_plan("torch")
    jg, jnid, _ = _reference_plan("jax")
    assert {n.id: r for n, r in tac.get_runs(g, {nid[2]}, tac.get_node_weights(g)).items()} == \
        {n.id: r for n, r in jac.get_runs(jg, {jnid[2]}, jac.get_node_weights(jg)).items()}
    assert (tac.Profile(1, 2, 3) + tac.Profile(4, 5, 6)) == tac.Profile(5, 7, 9)


def test_reference_plan_aggressive_selection():
    """Aggressive: a direct-consumer weight sum above 1, source descendants
    left out ({+2, +5}; not the transitively hot 3 and 4, not the twice-used
    test-branch node 9), in both packages."""
    g, nid, _ = _reference_plan("torch")
    got = tac.AutoCacheRule("aggressive").aggressive_cache(g, tac.get_node_weights(g))
    assert got == {nid[2], nid[5]}
    jg, _, _ = _reference_plan("jax")
    assert _ints(got) == _ints(jac.AutoCacheRule("aggressive").aggressive_cache(
        jg, jac.get_node_weights(jg)))


@pytest.mark.parametrize("budget,expected", [
    (10, set()),
    (75, {1}),
    (125, {5}),
    (175, {1, 5}),
    (350, {2, 5}),
    (10000, {2, 5}),
])
def test_reference_plan_greedy_staircase(budget, expected):
    """The six greedy budget selections of AutocCacheRuleSuite.scala:111-193,
    in the port and in JAX's rule on the same graph and profiles."""
    g, nid, profiles = _reference_plan("torch")
    got = tac.AutoCacheRule("greedy", mem_budget_bytes=budget).greedy_cache(
        g, profiles, tac.get_node_weights(g))
    assert got == {nid[i] for i in expected}, (budget, got)
    jg, _, jprofiles = _reference_plan("jax")
    want = jac.AutoCacheRule("greedy", mem_budget_bytes=budget).greedy_cache(
        jg, jprofiles, jac.get_node_weights(jg))
    assert _ints(got) == _ints(want)


@pytest.mark.parametrize("seed", range(4))
def test_greedy_picks_what_jax_picks_on_random_profiles(seed):
    """The reference plan under seeded random profiles and budgets: the
    same selection as JAX's rule, node for node."""
    rng = np.random.default_rng(seed)
    g, nid, _ = _reference_plan("torch")
    jg, jnid, _ = _reference_plan("jax")
    for _ in range(8):
        ns = rng.integers(1, 100, 13)
        mem = rng.integers(1, 500, 13)
        budget = int(rng.integers(0, 2000))
        tprof = {nid[i]: tac.Profile(float(ns[i]), float(mem[i]), 0.0) for i in range(7)}
        jprof = {jnid[i]: jac.Profile(float(ns[i]), float(mem[i]), 0.0) for i in range(7)}
        got = tac.AutoCacheRule("greedy", mem_budget_bytes=budget).greedy_cache(
            g, tprof, tac.get_node_weights(g))
        want = jac.AutoCacheRule("greedy", mem_budget_bytes=budget).greedy_cache(
            jg, jprof, jac.get_node_weights(jg))
        assert _ints(got) == _ints(want), (budget, got, want)


def test_greedy_respects_the_budget_and_reads_the_card_when_not_given(monkeypatch):
    g, ids = _diamond_graph("torch")
    profiles = {ids["a"]: tac.Profile(100, 10, 0)}
    w = tac.get_node_weights(g)
    assert tac.AutoCacheRule("greedy", mem_budget_bytes=5).greedy_cache(g, profiles, w) == set()
    assert tac.AutoCacheRule("greedy", mem_budget_bytes=50).greedy_cache(g, profiles, w) == {ids["a"]}
    from keystone_tpu_torch.observability import device as obs_device

    # no card: the JAX package's 8e9 host figure; a card: 75 % of its free memory
    monkeypatch.setattr(obs_device, "device_memory_stats", lambda device=None: None)
    assert tac.AutoCacheRule()._budget() == 0.75 * 8e9
    monkeypatch.setattr(obs_device, "device_memory_stats",
                        lambda device=None: {"bytes_limit": 1000, "bytes_in_use": 600})
    assert tac.AutoCacheRule()._budget() == 300.0
    assert tac.AutoCacheRule("greedy", mem_budget_bytes=5)._budget() == 5.0


def test_add_caches_inserts_a_cacher_between_a_node_and_its_children():
    g, ids = _diamond_graph("torch")
    g2 = tac.AutoCacheRule.add_caches(g, {ids["a"]})
    cachers = [n for n, op in g2.operators.items() if isinstance(op, Cacher)]
    assert len(cachers) == 1
    cacher = cachers[0]
    assert g2.dependencies[cacher] == (ids["a"],)
    assert g2.dependencies[ids["b"]] == (cacher,)
    assert g2.dependencies[ids["c"]] == (cacher,)
    jg, jids = _diamond_graph("jax")
    jg2 = jac.AutoCacheRule.add_caches(jg, {jids["a"]})
    assert sorted(n.id for n in g2.operators) == sorted(n.id for n in jg2.operators)
    assert {n.id: tuple(d.id for d in deps) for n, deps in g2.dependencies.items()} == \
        {n.id: tuple(d.id for d in deps) for n, deps in jg2.dependencies.items()}


def _plus_diamond(which):
    """data -> a = +1 -> (b = +2, c = +3 of weight 3): array outputs."""
    graph, ops, _, ds_of = PKGS[which]
    _, Plus, _ = _ops(ops)
    g, d = graph.EMPTY_GRAPH.add_node(ops.DatasetOperator(ds_of(np.ones((8, 2), np.float32))), ())
    g, a = g.add_node(Plus(1), (d,))
    g, b = g.add_node(Plus(2), (a,))
    g, c = g.add_node(Plus(3, weight=3), (a,))
    g, _ = g.add_sink(b)
    g, _ = g.add_sink(c)
    return g, {"data": d, "a": a, "b": b, "c": c}


def test_profile_nodes_on_a_cpu_graph_measures_what_jax_measures():
    """Both packages profile the same nodes at scales 2 and 4; the port's
    bytes of each node's array output (on the CPU here, so host bytes)
    equal what JAX counts as device bytes for its arrays, and both count
    the sampled items of the dataset node as host memory only."""
    g, ids = _plus_diamond("torch")
    jg, jids = _plus_diamond("jax")
    got = tac.profile_nodes(g, sorted(g.operators))
    want = jac.profile_nodes(jg, sorted(jg.operators))
    assert _ints(got) == _ints(want)
    for name in ("a", "b", "c"):
        p, q = got[ids[name]], want[jids[name]]
        assert p.ns >= 0 and p.device_mem == 0.0
        assert p.host_mem == pytest.approx(q.device_mem) and q.device_mem == pytest.approx(64.0)
    assert got[ids["data"]].device_mem == want[jids["data"]].device_mem == 0.0
    assert got[ids["data"]].host_mem > 0 and want[jids["data"]].host_mem > 0


def test_measure_size_by_where_the_tensor_lives_and_of_host_blocks(monkeypatch):
    x = torch.ones((6, 4))
    assert tac._measure_size(Dataset.from_array(x)) == (0.0, 96.0)
    assert tac._measure_size(x) == (0.0, 96.0)
    d, h = tac._measure_size(Dataset.from_items([torch.ones(3), "text"]))
    assert d == 0.0 and h >= 12
    blocks = Dataset.from_host_blocks([np.ones((6, 4), np.float32), np.ones((6, 2), np.float32)],
                                      device="cpu")
    monkeypatch.setattr(Dataset, "to_array_mode",
                        lambda self: (_ for _ in ()).throw(AssertionError("moved the blocks")))
    assert tac._measure_size(blocks) == (0.0, 144.0)


def test_profiling_leaves_a_samplers_draws_as_they_were():
    """The profiler runs shallow copies of the operators: a ColumnSampler
    in the graph draws the same columns after the rule as before it."""
    data = Dataset.from_array(torch.arange(2 * 3 * 7, dtype=torch.float32).reshape(2, 3, 7))
    sampler = ColumnSampler(2, seed=3)
    g, d = tgraph.EMPTY_GRAPH.add_node(tops.DatasetOperator(data), ())
    g, s = g.add_node(sampler, (d,))
    g, _ = g.add_sink(s)
    g, _ = g.add_sink(s)
    profiles = tac.profile_nodes(g, sorted(g.operators))
    assert s in profiles and sampler._counter == 0


class _Double(Transformer):
    """x -> 2x, taking a millisecond a row: the profiler's time for it
    grows with its input well above timing noise, so the greedy rule's
    extrapolated cost for it is never clamped to zero."""

    def apply(self, x):
        return x * 2

    def apply_batch(self, ds):
        time.sleep(1e-3 * ds.n)
        return Dataset.from_array(ds.padded() * 2, n=ds.n)


@pytest.mark.parametrize("strategy", ["greedy", "aggressive"])
def test_auto_caching_optimizer_fits_what_the_default_one_fits(strategy, monkeypatch):
    """A prefix feeding an estimator of weight 4 (four passes over its
    input), fit under ``DefaultOptimizer`` and under
    ``AutoCachingOptimizer``: the auto-caching plan holds a Cacher after
    the prefix (aggressive caching also caches the labels the estimator
    reads), and the fitted pipeline's output is the same, bit for
    bit."""
    from keystone_tpu_torch.ops.learning.block_ls import BlockLeastSquaresEstimator

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((40, 6)).astype(np.float32))
    y = torch.as_tensor(rng.standard_normal((40, 2)).astype(np.float32))
    env = PipelineEnv.get_or_create()

    def pipeline():
        return _Double().to_pipeline().and_then(
            BlockLeastSquaresEstimator(6, num_iter=1, lam=0.1),
            Dataset.from_array(x), Dataset.from_array(y))

    applied = []
    orig_apply = tac.AutoCacheRule.apply

    def apply(rule, graph, prefixes):
        applied.append(rule.strategy)
        return orig_apply(rule, graph, prefixes)

    monkeypatch.setattr(tac.AutoCacheRule, "apply", apply)

    def fit_under(opt):
        env.reset()
        env.optimizer = opt
        return pipeline().fit()(Dataset.from_array(x)).array()

    want = fit_under(DefaultOptimizer())
    assert applied == []
    plan, _ = AutoCachingOptimizer(strategy, mem_budget_bytes=10**9).execute(pipeline()._graph)
    cached = [plan.dependencies[n][0] for n, op in plan.operators.items() if isinstance(op, Cacher)]
    assert any(isinstance(plan.operators[n], _Double) for n in cached)
    applied.clear()
    got = fit_under(AutoCachingOptimizer(strategy, mem_budget_bytes=10**9))
    assert applied and set(applied) == {strategy}  # the fit ran the rule
    assert torch.equal(got, want)
