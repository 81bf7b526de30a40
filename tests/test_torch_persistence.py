"""Fitted pipelines that outlive their process, on the CPU:
``FittedPipeline.save``/``load`` (a round trip with equal outputs, the
lazily attached caches left out of the file, a file about the size of the
parameters, ``load`` on CUDA by default), ``and_then``, the
``chain_utils`` chains against the JAX package's, and
``PipelineEnv.save_state``/``load_state`` letting a re-built pipeline skip
its fit."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.ops.learning import BlockLeastSquaresEstimator as JBLS
from keystone_tpu.ops.learning.block_ls import BlockLinearMapper as JMapper
from keystone_tpu.ops.learning.pca import PCAEstimator as JPCAEstimator
from keystone_tpu.ops.stats import NormalizeRows as JNormalizeRows
from keystone_tpu.ops.stats import SignedHellingerMapper as JHellinger
from keystone_tpu.parallel.dataset import Dataset as JDataset
from keystone_tpu.workflow import chain_utils as jchain
from keystone_tpu_torch import convert
from keystone_tpu_torch.ops.learning.block_ls import (
    BlockLeastSquaresEstimator,
    BlockLinearMapper,
)
from keystone_tpu_torch.ops.learning.pca import PCAEstimator
from keystone_tpu_torch.ops.stats.nodes import NormalizeRows, SignedHellingerMapper
from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.serving.featurize import build_flagship_featurize_pipeline
from keystone_tpu_torch.workflow import chain_utils as tchain
from keystone_tpu_torch.workflow.api import Estimator, FittedPipeline, Transformer
from keystone_tpu_torch.workflow.executor import PipelineEnv
from keystone_tpu_torch.workflow.expressions import DatasetExpression
from keystone_tpu_torch.workflow.operators import LAZY_CACHES

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def reset_port_env():
    PipelineEnv.get_or_create().reset()
    yield
    PipelineEnv.get_or_create().reset()


def _voc_params(rng, desc_dim=8, vocab=32, classes=20):
    feats = 2 * desc_dim * vocab
    return {
        "pca": rng.standard_normal((128, desc_dim)).astype(np.float32) * 0.1,
        "means": rng.standard_normal((desc_dim, vocab)).astype(np.float32),
        "variances": 0.5 + rng.random((desc_dim, vocab)).astype(np.float32),
        "weights": np.full(vocab, 1.0 / vocab, np.float32),
        "threshold": 1e-4,
        "W": rng.standard_normal((feats, classes)).astype(np.float32) * 0.1,
        "feature_mean": rng.standard_normal(feats).astype(np.float32) * 0.01,
        "label_mean": rng.standard_normal(classes).astype(np.float32),
    }


def _images(rng):
    """Items of two sizes, as a VOC loader gives them."""
    return Dataset.from_items([
        torch.as_tensor(rng.integers(0, 256, (h, w, 3)).astype(np.float32))
        for h, w in ((40, 48), (48, 40), (40, 48))
    ])


def _lazy_caches(fitted):
    return sorted({name for op in fitted.graph.operators.values()
                   for name in LAZY_CACHES if name in op.__dict__})


def test_save_load_round_trip_leaves_the_caches_out(tmp_path):
    rng = np.random.default_rng(0)
    params = _voc_params(rng)
    featurize, model = convert.voc_from_numpy(params, device="cpu")
    fitted = featurize.and_then(model)
    images = _images(rng)
    want = fitted(images).array()
    # SIFT's operators, GrayScaler's weights and the eq_key digests are
    # attached by now
    assert _lazy_caches(fitted) == sorted(LAZY_CACHES)
    path = str(tmp_path / "voc.pt")
    fitted.save(path)
    assert _lazy_caches(fitted) == sorted(LAZY_CACHES)  # saving takes nothing away
    raw = torch.load(path, weights_only=False)
    assert _lazy_caches(raw) == []
    param_bytes = sum(np.asarray(v).nbytes for v in params.values())
    size = os.path.getsize(path)
    assert param_bytes < size < param_bytes + 32 * 1024, (size, param_bytes)
    loaded = FittedPipeline.load(path, device="cpu")
    got = loaded(images).array()
    assert torch.equal(got, want)
    assert "_operator_cache" in _lazy_caches(loaded)  # rebuilt on first use
    # the flagship chain: LCS's operators too
    feat, _ = build_flagship_featurize_pipeline(img=40, desc_dim=4, vocab=2, device="cpu")
    x = torch.as_tensor(rng.integers(0, 256, (2, 40, 40, 3), dtype=np.uint8))
    want = feat._batch_run(x)
    path = str(tmp_path / "flagship.pt")
    feat.save(path)
    assert _lazy_caches(torch.load(path, weights_only=False)) == []
    assert torch.equal(FittedPipeline.load(path, device="cpu")._batch_run(x), want)


def test_load_runs_on_cuda_unless_given_the_cpu(tmp_path, monkeypatch):
    fitted = NormalizeRows().and_then(SignedHellingerMapper()).fit()
    path = str(tmp_path / "p.pt")
    fitted.save(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FittedPipeline.load(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PipelineEnv.get_or_create().load_state(str(tmp_path))
    x = torch.randn(3, 5)
    loaded = FittedPipeline.load(path, device="cpu")
    assert torch.equal(loaded(Dataset.from_array(x)).array(), fitted(Dataset.from_array(x)).array())


def test_and_then_matches_jax():
    rng = np.random.default_rng(1)
    X = rng.standard_normal((6, 8)).astype(np.float32)
    W = rng.standard_normal((8, 3)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    first = NormalizeRows().and_then(SignedHellingerMapper()).fit()
    second = BlockLinearMapper(torch.as_tensor(W), 8, explicit_intercept=torch.as_tensor(b)).to_pipeline().fit()
    both = first.and_then(second)
    got = both(Dataset.from_array(torch.as_tensor(X))).array().numpy()
    np.testing.assert_array_equal(
        got, second(first(Dataset.from_array(torch.as_tensor(X)))).array().numpy())
    jfirst = JNormalizeRows().and_then(JHellinger()).fit()
    jsecond = JMapper(jnp.asarray(W), 8, explicit_intercept=jnp.asarray(b)).to_pipeline().fit()
    want = np.asarray(jfirst.and_then(jsecond)(JDataset.from_array(jnp.asarray(X))).array())
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(both.apply(torch.as_tensor(X[0])).numpy(), want[0], **TOL)


def test_chain_utils_match_jax():
    rng = np.random.default_rng(2)
    X = np.abs(rng.standard_normal((40, 12))).astype(np.float32)
    Y = rng.standard_normal((40, 2)).astype(np.float32)
    tX, jX = Dataset.from_array(torch.as_tensor(X)), JDataset.from_array(jnp.asarray(X))
    tY, jY = Dataset.from_array(torch.as_tensor(Y)), JDataset.from_array(jnp.asarray(Y))

    chain = tchain.TransformerChain([NormalizeRows(), SignedHellingerMapper()])
    jchain_ = jchain.TransformerChain([JNormalizeRows(), JHellinger()])
    want = np.asarray(jchain_.apply_batch(jX).array())
    np.testing.assert_allclose(chain.apply_batch(tX).array().numpy(), want, **TOL)
    np.testing.assert_allclose(chain.apply(torch.as_tensor(X[3])).numpy(), want[3], **TOL)

    est = tchain.TransformerEstimatorChain(NormalizeRows(), PCAEstimator(4))
    jest = jchain.TransformerEstimatorChain(JNormalizeRows(), JPCAEstimator(4))
    fitted, jfitted = est.fit(tX), jest.fit(jX)
    assert isinstance(fitted, tchain.TransformerChain)
    # PCA's bar, tests/ops/test_pca_zca.py
    np.testing.assert_allclose(fitted.apply_batch(tX).array().numpy(),
                               np.asarray(jfitted.apply_batch(jX).array()), atol=5e-3)

    lest = tchain.TransformerLabelEstimatorChain(
        SignedHellingerMapper(), BlockLeastSquaresEstimator(8, num_iter=2, lam=0.1))
    jlest = jchain.TransformerLabelEstimatorChain(JHellinger(), JBLS(8, num_iter=2, lam=0.1))
    got = lest.fit(tX, tY).apply_batch(tX).array().numpy()
    want = np.asarray(jlest.fit(jX, jY).apply_batch(jX).array())
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    assert lest.weight == jlest.weight == 7 and est.weight == jest.weight == 1


@dataclasses.dataclass(eq=False)
class _Demean(Transformer):
    """Module-level, so that the saved state can be unpickled."""

    mu: float

    def apply(self, x):
        return x - self.mu


_FIT_CALLS = {"n": 0}


@dataclasses.dataclass(eq=False)
class _MeanEstimator(Estimator):
    def fit(self, data):
        _FIT_CALLS["n"] += 1
        return _Demean(float(data.array().mean()))

    def eq_key(self):
        return ("mean_estimator",)


def test_save_state_lets_a_rebuilt_pipeline_skip_its_fit(tmp_path):
    _FIT_CALLS["n"] = 0
    data = Dataset.of(np.ones((8, 2), np.float32) * 5)
    out1 = _MeanEstimator().with_data(data).apply(np.zeros((4, 2), np.float32)).get()
    assert _FIT_CALLS["n"] == 1
    env = PipelineEnv.get_or_create()
    path = str(tmp_path / "state")
    env.save_state(path)
    env.reset()  # as a new process would start
    assert env.load_state(path, device="cpu") >= 1
    out2 = _MeanEstimator().with_data(data).apply(np.zeros((4, 2), np.float32)).get()
    assert _FIT_CALLS["n"] == 1  # loaded: no refit
    assert torch.equal(out1.array(), out2.array())


def test_save_state_streams_large_tensors_and_keeps_a_budget(tmp_path):
    env = PipelineEnv.get_or_create()

    def fill():
        env.state["bigp"] = DatasetExpression.of(Dataset.from_array(torch.ones(600, 600)))
        env.state["smallp"] = DatasetExpression.of(Dataset.from_array(torch.ones(4, 4)))
        env.state["itemsp"] = DatasetExpression.of(
            Dataset.from_items([torch.ones(2), (torch.zeros(3), "label")]))
        for e in env.state.values():
            e.get()

    fill()
    d = str(tmp_path / "state")
    env.save_state(d)
    assert [f for f in os.listdir(d) if f.endswith(".npy")] == ["arr00000.npy"]
    env.reset()
    assert env.load_state(d, device="cpu") == 3
    assert torch.equal(env.state["bigp"].get().padded(), torch.ones(600, 600))
    items = env.state["itemsp"].get().items()
    assert torch.equal(items[0], torch.ones(2)) and items[1][1] == "label"
    # a budget below the big tensor: that entry is dropped, the rest kept
    env.reset()
    fill()
    d2 = str(tmp_path / "state2")
    env.save_state(d2, max_total_bytes=1 << 20)
    assert not any(f.endswith(".npy") for f in os.listdir(d2))
    env.reset()
    assert env.load_state(d2, device="cpu") == 2
    assert "bigp" not in env.state and "smallp" in env.state
    # a value that cannot be pickled is skipped, not an error
    env.reset()
    env.state["lambda"] = DatasetExpression.of(Dataset.from_items([lambda: 0]))
    env.state["lambda"].get()
    env.save_state(str(tmp_path / "state3"))
    with open(os.path.join(tmp_path, "state3", "index.pt"), "rb") as f:
        assert f.read(2)  # written
    assert env.load_state(str(tmp_path / "state3"), device="cpu") == 0
