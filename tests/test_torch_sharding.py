"""``keystone_tpu_torch/serving/sharding.py`` on the CPU, held against
the JAX package's ``serving/sharding.py``: ``named_params`` names and
values on the same fitted pipelines (the flagship chain at 64² carried
across by ``convert``, its head, the demo model), ``match_partition_rules``
and ``DEFAULT_RULES`` specs name by name, the unmatched-param refusal,
``resolve_param_sharding``, spec validation, the mesh, the token, the
binder; and engines, a gateway and ``serve-gateway --shard-model``
whose answers equal the unsharded ones."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from keystone_tpu.serving import bench as jbench
from keystone_tpu.serving import sharding as jsharding
from keystone_tpu.serving.featurize import build_flagship_featurize_pipeline as jflagship
from keystone_tpu_torch import convert
from keystone_tpu_torch.gateway import Gateway
from keystone_tpu_torch.gateway import http as thttp
from keystone_tpu_torch.observability.registry import MetricsRegistry
from keystone_tpu_torch.serving import bench as tbench
from keystone_tpu_torch.serving import sharding
from keystone_tpu_torch.serving.sharding import PartitionSpec as P

FIMG, DESC, VOCAB = 64, 8, 8
GEOMETRY = dict(sift_step=4, sift_bin=4, sift_scales=2, sift_scale_step=1,
                lcs_stride=4, lcs_border=16, lcs_patch=6)
RESULT_TIMEOUT_S = 30


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _pairs():
    """(JAX fitted, port fitted) pairs of one model each."""
    from keystone_tpu.ops.learning.block_ls import BlockLinearMapper as JMapper
    from keystone_tpu.ops.util.nodes import TopKClassifier as JTopK
    from test_torch_gateway import _jax_flagship_params

    jfeat, d = jflagship(img=FIMG, desc_dim=DESC, vocab=VOCAB, **GEOMETRY)
    params = _jax_flagship_params(jfeat)
    rng = np.random.default_rng(5)
    W = rng.standard_normal((d, 12)).astype(np.float32)
    icpt = rng.standard_normal(12).astype(np.float32)
    params["model"] = {"W": W, "intercept": icpt}
    tfeat, thead = convert.flagship_from_numpy(params, top_k=3, device="cpu", **GEOMETRY)
    jhead = JMapper(W, d, explicit_intercept=icpt).and_then(JTopK(3)).fit()
    return {
        "flagship": (jfeat, tfeat),
        "head": (jhead, thead),
        "demo": (jbench.build_pipeline(d=6, hidden=8, depth=3, seed=4),
                 tbench.build_pipeline(d=6, hidden=8, depth=3, seed=4, device="cpu")),
    }


@pytest.fixture(scope="module")
def pairs():
    return _pairs()


@pytest.mark.parametrize("which", ["flagship", "head", "demo"])
def test_named_params_equal_jax(pairs, which):
    jfitted, tfitted = pairs[which]
    jnamed, tnamed = jsharding.named_params(jfitted), sharding.named_params(tfitted)
    assert sorted(tnamed) == sorted(jnamed) and tnamed
    for name in jnamed:
        np.testing.assert_array_equal(_host(tnamed[name]), np.asarray(jnamed[name]), err_msg=name)
    assert sharding.params_nbytes(tnamed) == jsharding.params_nbytes(jnamed)


@pytest.mark.parametrize("which", ["flagship", "head", "demo"])
def test_default_rules_give_jax_specs(pairs, which):
    jfitted, tfitted = pairs[which]
    jspecs = jsharding.match_partition_rules(jsharding.DEFAULT_RULES,
                                             jsharding.named_params(jfitted))
    tspecs = sharding.match_partition_rules(sharding.DEFAULT_RULES,
                                            sharding.named_params(tfitted))
    assert {k: tuple(v) for k, v in tspecs.items()} == {k: tuple(v) for k, v in jspecs.items()}
    assert str(P(None, "model")) == str(jsharding.DEFAULT_RULES[0][1])
    # True resolves the default rules, as in JAX
    assert sharding.resolve_param_sharding(True, tfitted) == tspecs


def test_unmatched_params_raise_unless_replicated(pairs):
    jfitted, tfitted = pairs["demo"]
    rules = ((r"/W$", P(None, "model")),)
    jrules = ((r"/W$", jsharding.DEFAULT_RULES[0][1]),)
    with pytest.raises(ValueError, match="no partition rule matched") as te:
        sharding.match_partition_rules(rules, sharding.named_params(tfitted))
    with pytest.raises(ValueError, match="no partition rule matched") as je:
        jsharding.match_partition_rules(jrules, jsharding.named_params(jfitted))
    assert str(te.value) == str(je.value)
    got = sharding.match_partition_rules(rules, sharding.named_params(tfitted),
                                         unmatched="replicate")
    want = jsharding.match_partition_rules(jrules, jsharding.named_params(jfitted),
                                           unmatched="replicate")
    assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}
    with pytest.raises(ValueError, match="unmatched must be"):
        sharding.match_partition_rules(rules, {}, unmatched="skip")
    # one-element params stay replicated whatever the rule says
    assert sharding.match_partition_rules(((".*", P("model")),),
                                          {"x": torch.ones(1)}) == {"x": P()}


def test_resolve_dicts_validation_mesh_and_token(pairs):
    _, tfitted = pairs["demo"]
    names = sorted(sharding.named_params(tfitted))
    specs = sharding.resolve_param_sharding({names[0]: P(None, "model")}, tfitted)
    assert specs[names[0]] == P(None, "model") and all(specs[n] == P() for n in names[1:])
    with pytest.raises(ValueError, match="unknown params"):
        sharding.resolve_param_sharding({"9/Nope/W": P()}, tfitted)
    mesh = sharding.make_mesh(devices=[torch.device("cpu")])
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
    with pytest.raises(ValueError, match="needs 2 devices"):
        sharding.make_mesh(n_model=2, devices=[torch.device("cpu")])
    wide = sharding.make_mesh(n_model=2, devices=[torch.device("cpu")] * 2)
    W = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="does not divide over 2 shards"):
        sharding.make_shard_fns({"w": P(None, "model")}, wide)["w"](W)
    with pytest.raises(ValueError, match="names mesh axis 'rows'"):
        sharding.make_shard_fns({"w": P("rows")}, mesh)["w"](W)
    with pytest.raises(ValueError, match="more entries"):
        sharding.make_shard_fns({"w": P(None, None, "model")}, mesh)["w"](W)
    with pytest.raises(ValueError, match="runs on one card"):
        sharding.make_shard_fns({"w": P("model")}, wide)["w"](torch.zeros(4, 3))
    placed = sharding.make_shard_fns({"w": P(None, "model")}, mesh)["w"](W)
    assert torch.equal(placed, W) and placed.data_ptr() != W.data_ptr()
    assert sharding.placed_shard_bytes({"w": placed}) == {torch.device("cpu"): 48}
    assert torch.equal(sharding.make_gather_fns({"w": P()})["w"](placed), W)
    a = sharding.sharding_token(specs, mesh)
    assert a == sharding.sharding_token(dict(specs), mesh)
    assert a != sharding.sharding_token(specs, wide)
    assert a != sharding.sharding_token({n: P() for n in names}, mesh)


def test_sharded_engines_and_gateway_answer_as_unsharded(pairs):
    _, tfitted = pairs["demo"]
    before = {k: v.clone() for k, v in sharding.named_params(tfitted).items()}
    x = np.random.default_rng(0).standard_normal((5, 6)).astype(np.float32)
    plain = tfitted.compiled((2, 4), device="cpu")
    sharded = tfitted.compiled((2, 4), device="cpu", param_sharding=True)
    assert sharded.model_sharded and not plain.model_sharded
    assert torch.equal(sharded.apply(x), plain.apply(x))
    # the binder runs on the engine's own copies; the caller's pipeline is untouched
    for name, value in sharding.named_params(tfitted).items():
        assert torch.equal(value, before[name])
        assert sharded._placed_params[name].data_ptr() != value.data_ptr()
    with pytest.raises(ValueError, match="no partition rule matched"):
        tfitted.compiled((2,), device="cpu", param_sharding=((r"/W$", P(None, "model")),))
    ok = tfitted.compiled((2,), device="cpu", param_sharding=((r"/W$", P(None, "model")),),
                          param_sharding_unmatched="replicate")
    assert torch.equal(ok.apply(x[:2]), plain.apply(x[:2]))
    for shard in (True, None):
        gw = Gateway(tfitted, buckets=(2, 4), n_lanes=2, device="cpu", param_sharding=shard,
                     warmup_example=torch.zeros(6), registry=MetricsRegistry(),
                     name=f"shard-{shard}")
        with gw:
            outs = [np.asarray(gw.predict(r).result(timeout=RESULT_TIMEOUT_S)) for r in x]
            assert all(lane.engine.model_sharded == bool(shard) for lane in gw.pool.lanes)
        if shard:
            sharded_outs = outs
    for a, b in zip(sharded_outs, outs):
        assert np.array_equal(a, b)


def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = thttp.main(argv, device="cpu")
    return rc, out.getvalue()


def test_serve_gateway_mesh_model_larger_than_the_host_exits_1():
    rc, out = _main(["--shard-model", "--mesh-model", "2", "--d", "4", "--hidden", "4",
                     "--depth", "1", "--buckets", "2"])
    assert rc == 1
    assert "needs 2 devices" in json.loads(out.strip().splitlines()[-1])["error"]
    sharding.set_mesh(None)
