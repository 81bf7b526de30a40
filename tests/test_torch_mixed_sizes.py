"""Images of several sizes through the port on the CPU, held against the
JAX package per item: each flagship node that takes an items-mode dataset
of mixed shapes (the JAX nodes run ``_bucketed_batch`` or a per-item map;
the port's run one batch per shape), the whole ``run`` at vocab 2, and the
bounded SIFT and LCS operator caches. Tolerances are those of
tests/test_torch_ops.py: PixelScaler 1e-7, GrayScaler 1e-6 / 1e-7, SIFT
±1 after the x512 quantization, LCS 1e-4 / 1e-3, PCA 1e-5, FV 1e-3 / 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.loaders.image_loaders import LabeledImage as JLabeledImage
from keystone_tpu.ops.images import core as jcore
from keystone_tpu.ops.images import fisher_vector as jfv
from keystone_tpu.ops.images import lcs as jlcs
from keystone_tpu.ops.images import sift as jsift
from keystone_tpu.ops.learning import gmm as jgmm
from keystone_tpu.ops.learning import pca as jpca
from keystone_tpu.parallel.dataset import Dataset as JDataset
from keystone_tpu.pipelines.images import imagenet_sift_lcs_fv as jflagship
from keystone_tpu_torch import _cuda
from keystone_tpu_torch.loaders.image_loaders import LabeledImage
from keystone_tpu_torch.ops.images import core as tcore
from keystone_tpu_torch.ops.images import fisher_vector as tfv
from keystone_tpu_torch.ops.images import lcs as tlcs
from keystone_tpu_torch.ops.images import sift as tsift
from keystone_tpu_torch.ops.learning import gmm as tgmm
from keystone_tpu_torch.ops.learning import pca as tpca
from keystone_tpu_torch.parallel.dataset import Dataset, on_device
from keystone_tpu_torch.pipelines.images import imagenet_sift_lcs_fv as tflagship
from keystone_tpu_torch.utils.lru import OPERATOR_SHAPES, LRUCache
from keystone_tpu_torch.workflow.executor import PipelineEnv as TEnv

# 7 images of 3 shapes, in a shuffled order
SHAPES = [(40, 48), (56, 56), (48, 40), (40, 48), (48, 40), (56, 56), (40, 48)]


def raw_images(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in SHAPES]


def descriptor_mats(seed, d):
    """(d, m) matrices whose widths follow the images' descriptor counts."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((d, 20 + h // 4 + w // 8)).astype(np.float32) for h, w in SHAPES]


def gmm_params(rng, d, k):
    means = rng.standard_normal((d, k)).astype(np.float32)
    variances = (0.5 + rng.random((d, k))).astype(np.float32)
    w = rng.random(k).astype(np.float32) + 0.1
    return means, variances, (w / w.sum()).astype(np.float32)


def _gray(raw):
    return [(r.astype(np.float32) @ np.float32([0.2989, 0.587, 0.114]) / 255.0)[..., None]
            .astype(np.float32) for r in raw]


def _pca_pair():
    pca = np.random.default_rng(3).standard_normal((16, 5)).astype(np.float32)
    return jpca.BatchPCATransformer(jnp.asarray(pca)), tpca.BatchPCATransformer(torch.as_tensor(pca))


def _fv_pair(fused):
    d, k = 8, (32 if fused else 4)
    params = gmm_params(np.random.default_rng(5), d, k)
    jg = jgmm.GaussianMixtureModel(*(jnp.asarray(a) for a in params))
    tg = tgmm.GaussianMixtureModel(*(torch.as_tensor(a) for a in params))
    if fused:
        return jfv.FisherVectorFused(jg), tfv.FisherVectorFused(tg)
    return jfv.FisherVector(jg), tfv.FisherVector(tg)


def _check_sift(got, want):
    assert got.shape == want.shape
    assert np.mean(np.abs(got - want) <= 1) >= 0.995


# name -> (JAX node, port node, inputs, check(got, want))
CASES = {
    "PixelScaler": lambda: (jcore.PixelScaler(), tcore.PixelScaler(), raw_images(),
                            dict(rtol=1e-7)),
    "GrayScaler": lambda: (jcore.GrayScaler(), tcore.GrayScaler(),
                           [r.astype(np.float32) / np.float32(255.0) for r in raw_images()],
                           dict(rtol=1e-6, atol=1e-7)),
    "SIFTExtractor": lambda: (jsift.SIFTExtractor(step=4, bin=4, num_scales=2),
                              tsift.SIFTExtractor(step=4, bin=4, num_scales=2),
                              _gray(raw_images()), _check_sift),
    "LCSExtractor": lambda: (jlcs.LCSExtractor(4, 16, 6), tlcs.LCSExtractor(4, 16, 6),
                             raw_images(), dict(rtol=1e-4, atol=1e-3)),
    "BatchPCATransformer": lambda: (*_pca_pair(), descriptor_mats(1, 16), dict(rtol=1e-5, atol=1e-5)),
    "FisherVector": lambda: (*_fv_pair(False), descriptor_mats(2, 8), dict(rtol=1e-3, atol=1e-4)),
    "FisherVectorFused": lambda: (*_fv_pair(True), descriptor_mats(2, 8), dict(rtol=1e-3, atol=1e-4)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_node_matches_jax_per_item_on_mixed_sizes(name):
    jnode, tnode, inputs, check = CASES[name]()
    want = jnode.apply_batch(JDataset.from_items([jnp.asarray(x) for x in inputs])).items()
    out = tnode.apply_batch(Dataset.from_items([torch.as_tensor(x) for x in inputs]))
    assert not out.is_array and out.n == len(inputs)
    got = out.items()
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if callable(check):
            check(g, w)
        else:
            np.testing.assert_allclose(g, w, err_msg=f"item {i}", **check)
    # one batch per shape gives each item what a batch of it alone gives
    for i in (0, 1):
        alone = tnode.apply_batch(Dataset.from_array(torch.as_tensor(inputs[i])[None])).array()[0]
        torch.testing.assert_close(got[i], alone, rtol=0, atol=0)


def test_bucketed_batch_runs_each_shape_as_one_batch():
    """A node whose batched ``apply_batch`` sends items to
    ``_bucketed_batch`` runs an items-mode dataset of mixed shapes as one
    batch per shape, in dataset order, and gives what the JAX package's
    ``bucket_vmap`` node gives; a node with only ``apply`` maps item by
    item."""
    from keystone_tpu.workflow.api import Transformer as JTransformer
    from keystone_tpu_torch.workflow.api import Transformer

    class JNode(JTransformer):
        bucket_vmap = True

        def apply(self, x):
            return jnp.sum(x * x, axis=-1) + x[..., 0]

    class TNode(Transformer):
        calls = 0

        def apply(self, x):
            TNode.calls += 1
            return torch.sum(x * x, dim=-1) + x[..., 0]

    class TBatched(TNode):
        def apply_batch(self, ds):
            if not ds.is_array:
                return self._bucketed_batch(ds)
            return Dataset.from_array(self.apply(ds.padded()), n=ds.n)

    mats = descriptor_mats(6, 3)
    want = JNode().apply_batch(JDataset.from_items([jnp.asarray(m.T) for m in mats])).items()
    got = TBatched().apply_batch(Dataset.from_items([torch.as_tensor(m.T) for m in mats])).items()
    assert TNode.calls == len({m.shape for m in mats})  # one batch per shape
    for g, w in zip(got, want):  # float32 sums of 3 terms, in either order
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
    mapped = TNode().apply_batch(Dataset.from_items([torch.as_tensor(m.T) for m in mats])).items()
    assert TNode.calls == len({m.shape for m in mats}) + len(mats)
    for g, m in zip(mapped, got):
        torch.testing.assert_close(g, m, rtol=0, atol=0)


def test_column_sampler_draws_match_jax_on_mixed_widths():
    """The samplers ahead of the PCA and GMM fits draw the same columns of
    each descriptor matrix as the JAX package's, item by item, whatever
    the widths, and their counters run on alike across calls."""
    from keystone_tpu.ops.stats import ColumnSampler as JColumnSampler
    from keystone_tpu_torch.ops.stats.nodes import ColumnSampler

    mats = descriptor_mats(4, 6)
    jnode, tnode = JColumnSampler(5, seed=3), ColumnSampler(5, seed=3)
    for _ in range(2):
        want = jnode.apply_batch(JDataset.from_items([jnp.asarray(m) for m in mats])).items()
        got = tnode.apply_batch(Dataset.from_items([torch.as_tensor(m) for m in mats])).items()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _synthetic(shapes, n, seed, classes=6):
    """Class-textured images (the JAX flagship test's recipe) at the given
    sizes, in order."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        c = i % classes
        h, w = shapes[rng.integers(len(shapes))]
        x, y = np.meshgrid(np.arange(w), np.arange(h))
        f = 2.0 + 3.0 * c
        base = 128 + 100 * np.sin(x / f) * np.cos(y / f)
        img = np.stack([base + rng.normal(0, 10, (h, w))] * 3, -1).clip(0, 255).astype(np.float32)
        items.append((img, c, f"c{c}_{i}"))
    return items


CONF = dict(
    desc_dim=8, vocab_size=2, lam=1e-4, mixture_weight=0.25, num_classes=6, lcs_stride=8,
    lcs_border=16, lcs_patch=6, num_pca_samples_per_image=20, num_gmm_samples_per_image=20,
)


@pytest.fixture
def fresh_envs():
    from keystone_tpu.workflow.executor import PipelineEnv as JEnv

    JEnv.get_or_create().reset()
    TEnv.get_or_create().reset()
    yield
    JEnv.get_or_create().reset()
    TEnv.get_or_create().reset()


def test_run_on_mixed_sizes_matches_jax(fresh_envs):
    """``run`` on images of 40 x 48 and 48 x 40 (the JAX package's ``run``
    stacks the SIFT descriptors after ``SignedHellingerMapper``, so it
    takes sizes whose descriptor counts agree): the port fits the same
    model, predicts the same top-5 and scores the same error."""
    shapes = [(40, 48), (48, 40)]
    train, test = _synthetic(shapes, 24, 0), _synthetic(shapes, 12, 1)
    assert len({im.shape for im, _, _ in train}) == 2
    jpred, jerr = jflagship.run(
        JDataset.from_items([JLabeledImage(*t) for t in train]),
        JDataset.from_items([JLabeledImage(*t) for t in test]),
        jflagship.ImageNetSiftLcsFVConfig(**CONF),
    )
    tpred, terr = tflagship.run(
        Dataset.from_items([LabeledImage(*t) for t in train]),
        Dataset.from_items([LabeledImage(*t) for t in test]),
        tflagship.ImageNetSiftLcsFVConfig(**CONF), device="cpu",
    )
    assert terr == jerr and terr <= 1.0 / 6.0
    images = [im for im, _, _ in test]
    want = np.asarray(jpred.fit()(JDataset.from_items([jnp.asarray(x) for x in images])).array())
    got = tpred.fit()(Dataset.from_items([torch.as_tensor(x) for x in images])).array().numpy()
    np.testing.assert_array_equal(got, want)


def test_run_on_three_sizes(fresh_envs):
    """Sizes whose descriptor counts differ (40 x 48, 48 x 40, 56 x 56)
    fit and score, and the fitted predictor gives each image the top-5 it
    gives that image alone."""
    shapes = [(40, 48), (48, 40), (56, 56)]
    train, test = _synthetic(shapes, 36, 0), _synthetic(shapes, 18, 1)
    assert len({im.shape for im, _, _ in train}) == 3
    pred, err = tflagship.run(
        Dataset.from_items([LabeledImage(*t) for t in train]),
        Dataset.from_items([LabeledImage(*t) for t in test]),
        tflagship.ImageNetSiftLcsFVConfig(**CONF), device="cpu",
    )
    assert err <= 1.0 / 6.0
    fitted = pred.fit()
    images = [torch.as_tensor(im) for im, _, _ in test]
    together = fitted(Dataset.from_items(images)).array()
    for i in (0, 1, 2, 5):
        alone = fitted(Dataset.from_array(images[i][None])).array()
        torch.testing.assert_close(together[i : i + 1], alone, rtol=0, atol=0)


def test_on_device_keeps_mixed_sizes_as_items():
    """Images of several sizes stay items, in order; items of one shape
    (labels, images of one size) become one array."""
    raw = raw_images()
    ds = Dataset.from_items(raw)
    on = on_device(ds, torch.device("cpu"))
    assert not on.is_array and on.n == len(raw)
    for x, r in zip(on.items(), raw):
        assert isinstance(x, torch.Tensor)
        np.testing.assert_array_equal(x.numpy(), r)
    assert on_device(on, torch.device("cpu")) is on
    same = on_device(Dataset.from_items([r for r in raw if r.shape == raw[0].shape]),
                                torch.device("cpu"))
    assert same.is_array and same.n == 3 and tuple(same.array().shape) == (3, *raw[0].shape)
    labels = on_device(Dataset.from_items([3, 1, 4]), torch.device("cpu"))
    assert labels.is_array and labels.array().tolist() == [3, 1, 4]


def test_operator_caches_are_bounded_and_keep_what_a_capture_reads():
    cache = LRUCache(2)
    assert cache.get_or_make("a", lambda: 1) == 1 and cache.get_or_make("b", lambda: 2) == 2
    assert cache.get_or_make("a", lambda: 3) == 1  # a is now the newest
    cache.get_or_make("c", lambda: 4)
    assert cache.keys() == ["a", "c"] and len(cache) == 2
    with pytest.raises(ValueError):
        LRUCache(0)

    for ext in (tsift.SIFTExtractor(step=4, bin=4, num_scales=2), tlcs.LCSExtractor(4, 16, 6)):
        first = ext.operators(40, 44, "cpu")
        refs = []
        with _cuda.capture_tally(refs):
            assert ext.operators(40, 44, "cpu") is first
        for size in range(OPERATOR_SHAPES + 6):
            ext.operators(40, 45 + size, "cpu")
        assert len(ext._operator_cache) == OPERATOR_SHAPES
        assert (40, 44, "cpu") not in ext._operator_cache.keys()
        assert refs == [first]  # what the capture read outlives the cache entry
        again = ext.operators(40, 44, "cpu")
        assert again is not first
        flat = [t for t in _flatten(first)]
        for a, b in zip(flat, _flatten(again)):
            assert torch.equal(a, b)
    # results unchanged once a shape was dropped and built again
    ext = tsift.SIFTExtractor(step=4, bin=4, num_scales=2)
    img = torch.as_tensor(_gray(raw_images())[0])[None]
    before = ext.extract(img)
    for size in range(OPERATOR_SHAPES + 1):
        ext.operators(30, 30 + size, "cpu")
    torch.testing.assert_close(ext.extract(img), before, rtol=0, atol=0)


def _flatten(tree):
    if isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _flatten(t)
    elif isinstance(tree, torch.Tensor):
        yield tree
