"""VOCSIFTFisher on the CPU: the port's ``run`` against the JAX package's
on a tar of seeded JPEGs of two sizes (48 x 40 and 40 x 48, which the JAX
package's pipeline also takes together) with 1 to 2 labels an image, at
desc_dim 8 with vocab 2 (the plain Fisher vector) and vocab 32 (the fused
one: B3's plain version in the port, Pallas in interpret mode in JAX).
Bars: PCA 5e-3 and GMM 1e-3 (tests/ops/test_pca_zca.py,
tests/ops/test_clustering.py, as tests/test_torch_training.py holds them;
VOC has no Hellinger map after SIFT, so its projected descriptors and GMM
means are O(100), not O(1), and the GMM bar is 1e-3 of the largest |entry|
of each parameter, rtol 1e-3),
‖W_port − W_jax‖ ≤ 5e-4 ‖W_jax‖ (tests/ops/test_weighted_ls.py's solver
bar) for both solvers on the same training features (the two fitted
pipelines' features differ by what their GMMs do, up to the GMM bar, and
W inherits that: 4e-4 and 9e-4 of ‖W‖ here), test scores within rtol 1e-3
(atol 1e-3 of the largest score); the
port's evaluator on JAX's scores gives JAX's MAP exactly. Also ``main``
with JAX's flags, and ``convert.voc_from_numpy`` of JAX's fitted
parameters."""

import io
import tarfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.evaluation import MeanAveragePrecisionEvaluator as JMAP
from keystone_tpu.loaders import image_loaders as jloaders
from keystone_tpu.ops.images import fisher_vector as jfv
from keystone_tpu.ops.learning import block_ls as jbls
from keystone_tpu.ops.learning import pca as jpca
from keystone_tpu.ops.util.nodes import ClassLabelIndicatorsFromIntArrayLabels as JIndicators
from keystone_tpu.parallel.dataset import Dataset as JDataset
from keystone_tpu.pipelines.images import voc_sift_fisher as jvoc
from keystone_tpu.workflow.executor import PipelineEnv as JEnv
from keystone_tpu_torch import convert
from keystone_tpu_torch.evaluation import MeanAveragePrecisionEvaluator
from keystone_tpu_torch.loaders import image_loaders as tloaders
from keystone_tpu_torch.ops.images import fisher_vector as tfv
from keystone_tpu_torch.ops.learning import block_ls as tbls
from keystone_tpu_torch.ops.learning import pca as tpca
from keystone_tpu_torch.ops.util.nodes import ClassLabelIndicatorsFromIntArrayLabels
from keystone_tpu_torch.loaders.image_loaders import ImageExtractor
from keystone_tpu_torch.parallel.dataset import Dataset, on_device
from keystone_tpu_torch.pipelines.images import voc_sift_fisher as tvoc
from keystone_tpu_torch.workflow.executor import PipelineEnv as TEnv

PCA_TOL = 5e-3
GMM_TOL = 1e-3
W_REL = 5e-4
SCORE_RTOL = 1e-3
CLASSES = 4
SIZES = [(48, 40), (40, 48)]  # (width, height) of PIL images
CONFIGS = {"vocab2": 2, "vocab32": 32}


def _jpeg(w, h, c, seed):
    """A seeded JPEG whose texture frequency depends on its first class."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    x, y = np.meshgrid(np.arange(w), np.arange(h))
    f = 2.0 + 1.5 * c
    base = 128 + 80 * np.sin(x / f) * np.cos(y / (f + 1))
    img = np.stack([base + rng.normal(0, 6, (h, w)) + 10 * k for k in range(3)], -1)
    buf = io.BytesIO()
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(buf, "JPEG", quality=90)
    return buf.getvalue()


def _labels_of(i):
    return sorted({i % CLASSES, (3 * i + 1) % CLASSES})


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    """A train tar of 12 and a test tar of 6 JPEGs, alternating sizes, and
    the VOC labels CSV."""
    d = tmp_path_factory.mktemp("voc")
    rows, j = [], 0
    for split, n, seed in (("train", 12, 0), ("test", 6, 100)):
        with tarfile.open(str(d / f"{split}.tar"), "w") as tf:
            for i in range(n):
                name = f"VOC2007/{split}_{i}.jpg"
                data = _jpeg(*SIZES[i % 2], _labels_of(i)[0], seed + i)
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
                for c in _labels_of(i):
                    rows.append(f"{j},{c + 1},class{c},trainval,{name}\n")  # 1-based
                    j += 1
    (d / "voclabels.csv").write_text(
        "id,class,classname,traintesteval,filename\n" + "".join(rows))
    return str(d / "train.tar"), str(d / "test.tar"), str(d / "voclabels.csv")


def _conf(mod, vocab):
    return mod.SIFTFisherConfig(
        desc_dim=8, vocab_size=vocab, lam=0.5, num_classes=CLASSES,
        num_pca_samples_per_image=20, num_gmm_samples_per_image=20,
    )


@pytest.fixture(scope="module")
def fits(voc):
    """Per config: JAX's fitted pipeline, its test scores and MAP (the
    body of its ``run``, fitted with ``fit()`` so that its parameters can
    be read), and the port's ``fit_and_score``."""
    train_tar, test_tar, labels = voc
    out = {}
    for name, vocab in CONFIGS.items():
        JEnv.get_or_create().reset()
        TEnv.get_or_create().reset()
        train = jloaders.VOCLoader(train_tar, labels)
        test = jloaders.VOCLoader(test_tar, labels)
        jlabels = JIndicators(CLASSES).apply_batch(jloaders.MultiLabelExtractor.apply(train))
        jfit = jvoc.build_pipeline(train.map(lambda li: li.image), jlabels, _conf(jvoc, vocab)).fit()
        jscores = np.asarray(jfit(test.map(lambda li: li.image)).array())
        actuals = jloaders.MultiLabelExtractor.apply(test).items()
        jmap = float(np.mean(JMAP(CLASSES).evaluate(actuals, jscores)))
        _, tfit, tscores, tmap = tvoc.fit_and_score(
            tloaders.VOCLoader(train_tar, labels), tloaders.VOCLoader(test_tar, labels),
            _conf(tvoc, vocab), device="cpu")
        train = tloaders.VOCLoader(train_tar, labels)
        features = tvoc.features_of(tfit)
        out[name] = dict(
            jfit=jfit, jscores=jscores, jmap=jmap, actuals=actuals, tfit=tfit,
            tscores=tscores.numpy(), tmap=tmap,
            train_features=features(on_device(ImageExtractor.apply(train), torch.device("cpu"))).array().numpy(),
            train_labels=np.stack([ClassLabelIndicatorsFromIntArrayLabels(CLASSES).apply(y).numpy()
                                   for y in tloaders.MultiLabelExtractor.apply(train).items()]),
        )
    JEnv.get_or_create().reset()
    TEnv.get_or_create().reset()
    return out


def _node(fitted, types):
    (op,) = [o for o in fitted.graph.operators.values() if isinstance(o, types)]
    return op


def _whole(featurize_and_model):
    featurize, model = featurize_and_model
    return featurize.and_then(model)


def _close_scores(got, want):
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL, atol=SCORE_RTOL * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_voc_fit_matches_jax(fits, name):
    f = fits[name]
    jfit, tfit = f["jfit"], f["tfit"]
    jp = np.asarray(_node(jfit, jpca.BatchPCATransformer).pca_mat)
    tp = _node(tfit, tpca.BatchPCATransformer).pca_mat.numpy()
    np.testing.assert_allclose(tp, jp, atol=PCA_TOL)
    fused = CONFIGS[name] >= 32
    jg = _node(jfit, jfv.FisherVectorFused if fused else jfv.FisherVector).gmm
    tg = _node(tfit, tfv.FisherVectorFused if fused else tfv.FisherVector).gmm
    for a in ("means", "variances", "weights"):
        want = np.asarray(getattr(jg, a))
        np.testing.assert_allclose(getattr(tg, a).numpy(), want, err_msg=a,
                                   rtol=GMM_TOL, atol=GMM_TOL * np.abs(want).max())
    tm = _node(tfit, tbls.BlockLinearMapper)
    assert tm.W.shape == (2 * 8 * CONFIGS[name], CLASSES)
    # both solvers, as build_pipeline configures them, on the port's
    # training features and labels
    X, Y = f["train_features"], f["train_labels"]
    kw = dict(block_size=tvoc.BLOCK_SIZE, num_iter=1, lam=0.5)
    jm = jbls.BlockLeastSquaresEstimator(**kw).fit(JDataset.from_array(jnp.asarray(X)),
                                                   JDataset.from_array(jnp.asarray(Y)))
    sm = tbls.BlockLeastSquaresEstimator(**kw).fit(Dataset.from_array(torch.as_tensor(X)),
                                                   Dataset.from_array(torch.as_tensor(Y)))
    np.testing.assert_array_equal(sm.W.numpy(), tm.W.numpy())
    for got, want in ((sm.W, jm.W), (sm.intercept, jm.intercept)):
        want = np.asarray(want)
        assert np.linalg.norm(got.numpy() - want) <= W_REL * np.linalg.norm(want)
    _close_scores(f["tscores"], f["jscores"])
    # the port's evaluator on JAX's scores gives JAX's MAP exactly
    got = float(np.mean(MeanAveragePrecisionEvaluator(CLASSES).evaluate(
        f["actuals"], torch.as_tensor(f["jscores"].copy()))))
    assert got == f["jmap"]
    assert 0.0 <= f["tmap"] <= 1.0 + 1e-12


def test_voc_from_numpy_of_jax_parameters_scores_like_jax(fits, voc):
    f = fits["vocab32"]
    jfit = f["jfit"]
    pca = _node(jfit, jpca.BatchPCATransformer)
    gmm = _node(jfit, jfv.FisherVectorFused).gmm
    model = _node(jfit, jbls.BlockLinearMapper)
    params = {
        "pca": np.asarray(pca.pca_mat), "means": np.asarray(gmm.means),
        "variances": np.asarray(gmm.variances), "weights": np.asarray(gmm.weights),
        "threshold": gmm.weight_threshold, "W": np.asarray(model.W),
        "feature_mean": np.asarray(model.feature_mean), "label_mean": np.asarray(model.label_mean),
    }
    featurize, model = convert.voc_from_numpy(params, device="cpu")
    test = tloaders.VOCLoader(voc[1], voc[2])
    _close_scores(tvoc.score(featurize.and_then(model), test, "cpu").numpy(), f["jscores"])
    # the port's own parameters carry across bit for bit, with an intercept too
    own = convert.voc_params(f["tfit"])
    again = tvoc.score(_whole(convert.voc_from_numpy(own, device="cpu")), test, "cpu")
    np.testing.assert_array_equal(again.numpy(), f["tscores"])
    own["intercept"] = _node(f["tfit"], tbls.BlockLinearMapper).intercept.numpy()
    del own["feature_mean"], own["label_mean"]
    icpt = tvoc.score(_whole(convert.voc_from_numpy(own, device="cpu")), test, "cpu").numpy()
    np.testing.assert_allclose(icpt, f["tscores"], rtol=1e-5, atol=1e-6)


def test_features_of_is_the_fitted_chain_without_its_model(fits, voc):
    """``features_of`` of the fitted pipeline, the chain ``voc_from_numpy``
    builds from its parameters, and that chain with the model give the
    fitted pipeline's features and scores bit for bit (vocab 32: the
    fused Fisher vector, as the estimator chose it)."""
    tfit = fits["vocab32"]["tfit"]
    images = on_device(ImageExtractor.apply(tloaders.VOCLoader(voc[1], voc[2])), torch.device("cpu"))
    feats = tvoc.features_of(tfit)(images).array()
    assert tuple(feats.shape) == (len(fits["vocab32"]["tscores"]), 2 * 8 * 32)
    featurize, model = convert.voc_from_numpy(convert.voc_params(tfit), device="cpu")
    assert sum(isinstance(o, tfv.FisherVectorFused) for o in featurize.graph.operators.values()) == 1
    np.testing.assert_array_equal(featurize(images).array().numpy(), feats.numpy())
    np.testing.assert_array_equal(tvoc.features_of(tfit).and_then(model)(images).array().numpy(),
                                  fits["vocab32"]["tscores"])
    with pytest.raises(ValueError, match="BlockLinearMapper"):
        tvoc.features_of(featurize)


def test_class_label_indicators_from_int_array_labels_match_jax():
    ys = [np.array([1, 3]), np.array([0]), np.array([2, 0, 1])]
    want = np.stack([np.asarray(x) for x in
                     JIndicators(4).apply_batch(JDataset.from_items(ys)).items()])
    got = ClassLabelIndicatorsFromIntArrayLabels(4).apply_batch(Dataset.from_items(ys))
    out = got.to_array_mode().array()
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), want)


def test_main_parses_jax_flags_and_prints_the_same_map(voc, capsys):
    train_tar, test_tar, labels = voc
    argv = ["--trainLocation", train_tar, "--testLocation", test_tar, "--labelPath", labels,
            "--descDim", "8", "--vocabSize", "2", "--lambda", "0.5", "--scaleStep", "0"]
    JEnv.get_or_create().reset()
    assert jvoc.main(argv) == 0
    want = capsys.readouterr().out.splitlines()
    TEnv.get_or_create().reset()
    assert tvoc.main(argv, device="cpu") == 0
    got = capsys.readouterr().out.splitlines()
    JEnv.get_or_create().reset()
    TEnv.get_or_create().reset()
    assert len(got) == len(want) == 2
    assert got[0] == want[0] and got[0].startswith("TEST MAP is: ")
    assert got[1].startswith("Total time: ")
    with pytest.raises(SystemExit):
        tvoc.main(["--trainLocation", "x"], device="cpu")
