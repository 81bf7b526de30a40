"""The random-features image apps on the CPU, held against the JAX
package on the same seeded inputs: each app's ``run`` (RandomPatchCifar,
MnistRandomFFT fused and gathered, LinearPixels, RandomCifar, the kernel
ridge variant and both augmented variants) at the JAX tests' sizes and
bars (tests/pipelines/test_random_patch_cifar.py,
test_mnist_random_fft.py, test_cifar_apps.py), ``main`` with the JAX
flags on CIFAR binary files and MNIST CSVs written to ``tmp_path``, the
loaders against the JAX loaders (a partial CIFAR record raises), and
``convert`` of JAX-fitted RandomPatchCifar, MNIST and KRR models scoring
the same inputs like JAX.

Predictions must be equal. Scores of the augmented block-solver variant
(whose accuracy the JAX test does not bound) are held within rtol 1e-3 /
atol 1e-3 of the largest score, as tests/test_torch_voc.py holds VOC's."""

import contextlib
import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.loaders import cifar as jcifar
from keystone_tpu.loaders import csv_loader as jcsv
from keystone_tpu.ops.images import core as jcore
from keystone_tpu.ops.learning import block_ls as jbls
from keystone_tpu.ops.learning import kernel as jkernel
from keystone_tpu.ops.stats import nodes as jstats
from keystone_tpu.parallel.dataset import Dataset as JDataset
from keystone_tpu.pipelines.images import cifar_apps as japps
from keystone_tpu.pipelines.images import mnist_random_fft as jmnist
from keystone_tpu.pipelines.images import random_patch_cifar as jrpc
from keystone_tpu_torch import convert, native
from keystone_tpu_torch.loaders import cifar as tcifar
from keystone_tpu_torch.loaders import csv_loader as tcsv
from keystone_tpu_torch.ops.images import core as tcore
from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.pipelines.images import cifar_apps as tapps
from keystone_tpu_torch.pipelines.images import mnist_random_fft as tmnist
from keystone_tpu_torch.pipelines.images import random_patch_cifar as trpc
from keystone_tpu_torch.workflow.executor import PipelineEnv as TEnv

SCORE_RTOL = 1e-3


@pytest.fixture(autouse=True)
def reset_port_env():
    TEnv.get_or_create().reset()
    yield
    TEnv.get_or_create().reset()


def np_(x):
    if hasattr(x, "get"):
        x = x.get()
    if isinstance(x, (Dataset, JDataset)):
        x = x.array()
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _images(labels, images):
    """The same numpy (labels, images) as JAX's and the port's LabeledImages."""
    return (
        jcifar.LabeledImages(JDataset.from_array(jnp.asarray(labels)),
                             JDataset.from_array(jnp.asarray(images))),
        tcifar.LabeledImages(Dataset.from_array(torch.as_tensor(labels)),
                             Dataset.from_array(torch.as_tensor(images))),
    )


def _cifar(n_train, n_test, seed):
    """JAX's synthetic_cifar, and the port's, which draws the same."""
    jtr, jte = jrpc.synthetic_cifar(n_train=n_train, n_test=n_test, seed=seed)
    ttr, tte = trpc.synthetic_cifar(n_train=n_train, n_test=n_test, seed=seed)
    np.testing.assert_array_equal(np_(ttr.images), np_(jtr.images))
    return (jtr, jte), (ttr, tte)


def _spatial_cifar(n_train, n_test, seed=0):
    """Class-dependent spatial gray patterns (test_cifar_apps.py's
    ``_spatial_cifar``: color blobs collapse under GrayScaler)."""
    rng = np.random.default_rng(seed)
    x, y = np.meshgrid(np.arange(32), np.arange(32))
    patterns = [
        100 + 80 * np.sin(2 * np.pi * (x * np.cos(a) + y * np.sin(a)) / p)
        for a, p in zip(np.linspace(0, np.pi, 10, endpoint=False),
                        [4, 6, 8, 10, 12, 5, 7, 9, 11, 13])
    ]

    def make(n):
        ys = rng.integers(0, 10, n)
        imgs = np.stack([patterns[c] + rng.normal(0, 10, (32, 32)) for c in ys])
        imgs = np.repeat(imgs[:, :, :, None], 3, axis=3).clip(0, 255)
        return ys.astype(np.int32), imgs.astype(np.float32)

    (jtr, ttr), (jte, tte) = _images(*make(n_train)), _images(*make(n_test))
    return (jtr, jte), (ttr, tte)


def _augmented_scores(pipe, test, size, jax_side):
    if jax_side:
        aug = jcore.CenterCornerPatcher(size, size, horizontal_flips=True).apply_batch(test.images)
    else:
        aug = tcore.CenterCornerPatcher(size, size, horizontal_flips=True).apply_batch(test.images)
    return np_(pipe(aug))


def _run_app(app):
    """(JAX predictions or scores, the port's, JAX accuracy, the port's,
    the JAX test's accuracy bar)."""
    if app == "random_patch_cifar":
        (jtr, jte), (ttr, tte) = _cifar(128, 32, 0)
        kw = dict(num_filters=16, patch_size=6, patch_steps=3, lam=10.0)
        jp, jm = jrpc.run(jtr, jte, jrpc.RandomCifarConfig(**kw))
        tp, tm = trpc.run(ttr, tte, trpc.RandomCifarConfig(**kw), device="cpu")
        return np_(jp(jte.images)), np_(tp(tte.images)), jm, tm, 0.6
    if app.startswith("mnist"):
        jtr, jte = jmnist.synthetic_mnist(n_train=256, n_test=64, seed=0)
        ttr, tte = tmnist.synthetic_mnist(n_train=256, n_test=64, seed=0)
        kw = dict(num_ffts=2, block_size=512, lam=10.0, fused=app == "mnist_fused")
        jp, jm = jmnist.run(jtr, jte, jmnist.MnistRandomFFTConfig(**kw))
        tp, tm = tmnist.run(ttr, tte, tmnist.MnistRandomFFTConfig(**kw), device="cpu")
        return np_(jp(jte.data)), np_(tp(tte.data)), jm, tm, 0.9
    if app == "linear_pixels":
        # n must exceed the 1024 gray-pixel feature dim: no regularization
        (jtr, jte), (ttr, tte) = _spatial_cifar(2048, 64)
        jp, jm = japps.linear_pixels(jtr, jte)
        tp, tm = tapps.linear_pixels(ttr, tte, device="cpu")
        return np_(jp(jte.images)), np_(tp(tte.images)), jm, tm, 0.8
    if app == "random_cifar":
        (jtr, jte), (ttr, tte) = _cifar(96, 24, 1)
        kw = dict(num_filters=12, pool_size=14, pool_stride=13, lam=100.0)
        jp, jm = japps.random_cifar(jtr, jte, **kw)
        tp, tm = tapps.random_cifar(ttr, tte, device="cpu", **kw)
        return np_(jp(jte.images)), np_(tp(tte.images)), jm, tm, 0.3
    if app == "kernel":
        (jtr, jte), (ttr, tte) = _cifar(64, 16, 2)
        kw = dict(num_filters=8, patch_size=6, patch_steps=4, gamma=1e-2, block_size=32,
                  num_epochs=3, lam=1.0)
        jp, jm = japps.random_patch_cifar_kernel(jtr, jte, japps.RandomCifarKernelConfig(**kw))
        tp, tm = tapps.random_patch_cifar_kernel(ttr, tte, tapps.RandomCifarKernelConfig(**kw),
                                                 device="cpu")
        return np_(jp(jte.images)), np_(tp(tte.images)), jm, tm, 0.6
    if app == "augmented":
        (jtr, jte), (ttr, tte) = _cifar(48, 12, 3)
        kw = dict(num_filters=8, patch_size=6, patch_steps=4, lam=50.0, augment_patch_size=24,
                  augment_copies=3)
        jp, jm = japps.random_patch_cifar_augmented(jtr, jte, japps.RandomCifarAugmentedConfig(**kw))
        tp, tm = tapps.random_patch_cifar_augmented(
            ttr, tte, tapps.RandomCifarAugmentedConfig(**kw), device="cpu")
        return (_augmented_scores(jp, jte, 24, True), _augmented_scores(tp, tte, 24, False),
                jm, tm, 0.0)
    (jtr, jte), (ttr, tte) = _cifar(48, 12, 4)
    kw = dict(num_filters=8, patch_size=6, patch_steps=4, lam=1.0, augment_patch_size=24,
              augment_copies=3, gamma=1e-2, block_size=48, num_epochs=2)
    jp, jm = japps.random_patch_cifar_augmented_kernel(
        jtr, jte, japps.RandomCifarAugmentedKernelConfig(**kw))
    tp, tm = tapps.random_patch_cifar_augmented_kernel(
        ttr, tte, tapps.RandomCifarAugmentedKernelConfig(**kw), device="cpu")
    return (_augmented_scores(jp, jte, 24, True).argmax(1),
            _augmented_scores(tp, tte, 24, False).argmax(1), jm, tm, 0.5)


@pytest.mark.parametrize("app", [
    "random_patch_cifar", "mnist_fused", "mnist_gathered", "linear_pixels", "random_cifar",
    "kernel", "augmented", "augmented_kernel",
])
def test_app_run_predicts_as_jax(app, mesh8):
    want, got, jm, tm, bar = _run_app(app)
    assert got.shape == want.shape
    if app == "augmented":
        np.testing.assert_allclose(got, want, rtol=SCORE_RTOL,
                                   atol=SCORE_RTOL * np.abs(want).max())
    else:
        np.testing.assert_array_equal(got, want)
    assert tm.total_accuracy == jm.total_accuracy
    assert tm.total_accuracy > bar or (bar == 0.0 and 0.0 <= tm.total_accuracy <= 1.0)


def _write_cifar(path, labels, images):
    """CIFAR binary records: a label byte, then the three channel planes."""
    n = len(labels)
    planes = np.asarray(images).astype(np.uint8).transpose(0, 3, 1, 2).reshape(n, -1)
    np.concatenate([np.asarray(labels, np.uint8)[:, None], planes], axis=1).tofile(path)


def _write_mnist_csv(path, labels, pixels):
    """MNIST-layout CSV rows: the 1-based label, then integer pixels."""
    rows = np.concatenate([np.asarray(labels)[:, None] + 1, pixels], axis=1).astype(np.int64)
    np.savetxt(path, rows, fmt="%d", delimiter=",")


def _accuracy_line(fn, argv, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert fn(argv, **kw) == 0
    text = out.getvalue()
    assert "Total time:" in text
    return re.search(r"Accuracy: [0-9.]+", text).group(0)


@pytest.fixture
def files(tmp_path):
    """A CIFAR train and test file of synthetic_cifar's images (rounded to
    bytes) and MNIST-layout train and test CSVs of synthetic_mnist's
    pixels (scaled to integers; more rows than the 1,024 features of two
    FFTs, since byte-range pixels leave λ = 10 no regularizing power)."""
    tr, te = jrpc.synthetic_cifar(n_train=128, n_test=32, seed=5)
    out = {}
    for name, d in (("cifar_train", tr), ("cifar_test", te)):
        out[name] = str(tmp_path / f"{name}.bin")
        _write_cifar(out[name], np_(d.labels), np.round(np_(d.images)))
    mtr, mte = jmnist.synthetic_mnist(n_train=1536, n_test=64, seed=5)
    for name, d in (("mnist_train", mtr), ("mnist_test", mte)):
        out[name] = str(tmp_path / f"{name}.csv")
        px = np.clip(np.round(np_(d.data) * 20 + 128), 0, 255)
        _write_mnist_csv(out[name], np_(d.labels), px)
    return out


def test_main_with_the_jax_flags_on_files(files, mesh8):
    argv = ["--trainLocation", files["cifar_train"], "--testLocation", files["cifar_test"],
            "--numFilters", "16", "--patchSteps", "3", "--lambda", "10"]
    assert _accuracy_line(trpc.main, argv, device="cpu") == _accuracy_line(jrpc.main, argv)
    argv = ["--trainLocation", files["mnist_train"], "--testLocation", files["mnist_test"],
            "--numFFTs", "2", "--blockSize", "512", "--lambda", "10", "--seed", "3"]
    line = _accuracy_line(tmnist.main, argv, device="cpu")
    assert line == _accuracy_line(jmnist.main, argv)
    assert float(line.split()[1]) > 0.9


def test_loaders_read_what_jax_reads_and_refuse_partial_records(files, tmp_path):
    assert native.io_native_available()  # the native route (numpy is the other)
    j, t = jcifar.CifarLoader(files["cifar_train"]), tcifar.CifarLoader(files["cifar_train"])
    assert t.images.n == 128 and np_(t.images).shape == (128, 32, 32, 3)
    np.testing.assert_array_equal(np_(t.images), np_(j.images))
    np.testing.assert_array_equal(np_(t.labels), np_(j.labels))
    partial = tmp_path / "partial.bin"
    partial.write_bytes(open(files["cifar_test"], "rb").read()[:-5])
    for loader in (tcifar.CifarLoader, jcifar.CifarLoader):
        with pytest.raises(ValueError, match="whole number"):
            loader(str(partial))
    jl = jcsv.LabeledData.from_csv(files["mnist_train"], label_offset=1)
    tl = tcsv.LabeledData.from_csv(files["mnist_train"], label_offset=1)
    np.testing.assert_array_equal(np_(tl.labels), np_(jl.labels))
    np.testing.assert_array_equal(np_(tl.data), np_(jl.data))
    assert np_(tl.labels).min() == 0 and np_(tl.data).shape == (1536, 784)
    np.testing.assert_array_equal(np_(tcsv.CsvDataLoader(files["mnist_test"])),
                                  np_(jcsv.CsvDataLoader(files["mnist_test"])))
    pair = tcsv.LabeledData.of(np.arange(3), np.ones((3, 2), np.float32))
    assert pair.labels.n == pair.data.n == 3


def _node(fitted, cls):
    (node,) = [op for op in fitted.graph.operators.values() if isinstance(op, cls)]
    return node


def test_convert_jax_fits_scores_like_jax(mesh8):
    """JAX-fitted RandomPatchCifar, MnistRandomFFT and KRR models, carried
    across as numpy arrays, classify the same inputs as JAX."""
    (jtr, jte), (ttr, tte) = _cifar(128, 32, 0)
    jp, _ = jrpc.run(jtr, jte, jrpc.RandomCifarConfig(num_filters=16, patch_steps=3, lam=10.0))
    jfit = jp.fit()
    conv, pool = _node(jfit, jcore.Convolver), _node(jfit, jcore.Pooler)
    scaler, model = _node(jfit, jstats.StandardScalerModel), _node(jfit, jbls.BlockLinearMapper)
    params = {
        "filters": np.asarray(conv.filters), "img_size": 32,
        "whitener": np.asarray(conv.whitener.whitener),
        "whitener_means": np.asarray(conv.whitener.means),
        "alpha": _node(jfit, jcore.SymmetricRectifier).alpha,
        "pool_stride": pool.stride, "pool_size": pool.pool_size,
        "scaler_mean": np.asarray(scaler.mean), "scaler_std": np.asarray(scaler.std),
        "W": np.asarray(model.W), "feature_mean": np.asarray(model.feature_mean),
        "label_mean": np.asarray(model.label_mean),
    }
    ported = convert.random_patch_cifar_from_numpy(params, device="cpu")
    want = np_(jfit(jte.images))
    np.testing.assert_array_equal(np_(ported(tte.images)), want)
    # and the port's own parameters carry across bit for bit
    tp, _ = trpc.run(ttr, tte, trpc.RandomCifarConfig(num_filters=16, patch_steps=3, lam=10.0),
                     device="cpu")
    tfit = tp.fit()
    again = convert.random_patch_cifar_from_numpy(convert.random_patch_cifar_params(tfit),
                                                 device="cpu")
    np.testing.assert_array_equal(np_(again(tte.images)), np_(tfit(tte.images)))

    jtr, jte = jmnist.synthetic_mnist(n_train=256, n_test=64, seed=1)
    ttr, tte = tmnist.synthetic_mnist(n_train=256, n_test=64, seed=1)
    conf = dict(num_ffts=2, block_size=512, lam=10.0)
    jm = jmnist.run(jtr, jte, jmnist.MnistRandomFFTConfig(**conf))[0].fit()
    fft, model = _node(jm, jstats.RandomFFTFeatures), _node(jm, jbls.BlockLinearMapper)
    ported = convert.mnist_random_fft_from_numpy({
        "signs": np.asarray(fft.signs), "rectify_threshold": fft.rectify_threshold,
        "W": np.asarray(model.W), "feature_mean": np.asarray(model.feature_mean),
        "label_mean": np.asarray(model.label_mean)}, block_size=512, device="cpu")
    np.testing.assert_array_equal(np_(ported(tte.data)), np_(jm(jte.data)))
    tm = tmnist.run(ttr, tte, tmnist.MnistRandomFFTConfig(**conf), device="cpu")[0].fit()
    again = convert.mnist_random_fft_from_numpy(convert.mnist_random_fft_params(tm),
                                               block_size=512, device="cpu")
    np.testing.assert_array_equal(np_(again(tte.data)), np_(tm(tte.data)))

    rng = np.random.default_rng(2)
    X = rng.standard_normal((60, 5)).astype(np.float32)
    Y = rng.standard_normal((60, 3)).astype(np.float32)
    jk = jkernel.KernelRidgeRegression(jkernel.GaussianKernelGenerator(0.3), 0.5, 16, 4).fit(
        JDataset.from_array(jnp.asarray(X)), JDataset.from_array(jnp.asarray(Y)))
    kt = jk.kernel_transformer
    ported = convert.krr_from_numpy({
        "train_X": np.asarray(kt.train_X), "n_train": kt.n_train, "gamma": kt.gamma,
        "W": np.asarray(jk.model), "block_size": jk.block_size}, device="cpu")
    Xt = rng.standard_normal((9, 5)).astype(np.float32)
    want = np_(jk.apply_batch(JDataset.from_array(jnp.asarray(Xt))))
    np.testing.assert_allclose(np_(ported(Dataset.from_array(torch.as_tensor(Xt)))), want,
                               atol=1e-4)
    assert convert.krr_params(ported)["n_train"] == 60
