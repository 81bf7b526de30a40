"""The random-features image nodes of ``keystone_tpu_torch/ops/images/core.py``
on the CPU, held against the JAX package on the same seeded numpy inputs:
Convolver (plain, normalized, whitened, ``fast``),
Pooler, SymmetricRectifier, ImageVectorizer's channel-major layout,
Cropper, Windower, both patchers and RandomImageTransformer. Bars are the
JAX tests' own (tests/ops/test_images.py): atol 1e-3 for the Convolver,
rtol 1e-5 for the Pooler; layout and augmentation nodes are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.ops.images import core as jcore
from keystone_tpu.ops.learning.zca import ZCAWhitenerEstimator as JZCA
from keystone_tpu.parallel.dataset import Dataset as JDataset
from keystone_tpu_torch.ops.images import core as tcore
from keystone_tpu_torch.ops.learning.zca import ZCAWhitener
from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.utils import chunks

CONV_ATOL = 1e-3
FAST_BAR = 8e-3


def np_(x):
    if isinstance(x, Dataset):
        x = x.padded()
    if isinstance(x, JDataset):
        x = x.padded()
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _conv_pair(case, rng):
    """(JAX Convolver, port Convolver, images (n, X, Y, C)) for a case."""
    k, C, F, X, Y = {"plain": (3, 2, 4, 8, 7), "normalized": (3, 3, 5, 9, 9),
                     "whitened": (2, 2, 3, 6, 6), "cifar": (6, 3, 8, 32, 32)}[case]
    scale = 255.0 if case == "cifar" else 1.0
    imgs = (rng.uniform(0, 1, (3, X, Y, C)) * scale).astype(np.float32)
    filters = rng.standard_normal((F, k * k * C)).astype(np.float32)
    jw = tw = None
    if case in ("whitened", "cifar"):
        sample = (rng.uniform(0, 1, (80, k * k * C)) * scale).astype(np.float32)
        jw = JZCA(eps=0.1).fit_single(jnp.asarray(sample))
        tw = ZCAWhitener(torch.tensor(np.asarray(jw.whitener)),
                         torch.tensor(np.asarray(jw.means)))
    norm = case != "plain"
    j = jcore.Convolver(jnp.asarray(filters), X, Y, C, whitener=jw, normalize_patches=norm)
    t = tcore.Convolver(torch.as_tensor(filters), X, Y, C, whitener=tw, normalize_patches=norm)
    return j, t, imgs


@pytest.mark.parametrize("case", ["plain", "normalized", "whitened", "cifar"])
def test_convolver_matches_jax(case):
    """Single image and batch, OHWI weights over A[x, y, c] against the
    port's OIHW/NCHW convolution: a transposed layout would give mirrored
    features that only this comparison catches."""
    j, t, imgs = _conv_pair(case, np.random.default_rng(0))
    want = np_(j.apply_batch(JDataset.from_array(jnp.asarray(imgs))))
    got = t.apply_batch(Dataset.from_array(torch.as_tensor(imgs)))
    assert got.padded().shape == want.shape == (3, t.res_width, t.res_height, t.filters.shape[0])
    np.testing.assert_allclose(np_(got), want, atol=CONV_ATOL)
    np.testing.assert_allclose(np_(t.apply(torch.as_tensor(imgs[1]))), want[1], atol=CONV_ATOL)
    # items mode maps the single-image path
    items = t.apply_batch(Dataset.from_items([torch.as_tensor(im) for im in imgs]))
    np.testing.assert_allclose(np.stack([np_(x) for x in items.items()]), want, atol=CONV_ATOL)


def test_convolver_fast_raises():
    """``fast=True`` runs (the float32 path, so it equals ``fast=False``)
    within the JAX test's bar of the JAX package's ``fast=True``: 8e-3 of
    the largest feature (tests/ops/test_precision_policy.py)."""
    j, t, imgs = _conv_pair("cifar", np.random.default_rng(1))
    fast = tcore.Convolver(t.filters, 32, 32, 3, whitener=t.whitener, fast=True)
    exact = np_(t.apply_batch(Dataset.from_array(torch.as_tensor(imgs))))
    got = np_(fast.apply_batch(Dataset.from_array(torch.as_tensor(imgs))))
    jfast = jcore.Convolver(jnp.asarray(np_(t.filters)), 32, 32, 3, whitener=j.whitener, fast=True)
    want = np_(jfast.apply_batch(JDataset.from_array(jnp.asarray(imgs))))
    np.testing.assert_array_equal(got, exact)
    assert np.abs(got - want).max() / np.abs(want).max() < FAST_BAR


@pytest.mark.parametrize("case", ["plain", "normalized", "whitened", "cifar"])
def test_convolver_fast_matches_jax(case):
    """``fast=True`` in every configuration, batched and one image at a
    time, against the JAX package's ``fast=True`` at the JAX test's bar,
    and equal to the port's ``fast=False``."""
    j, t, imgs = _conv_pair(case, np.random.default_rng(4))
    fast = tcore.Convolver(t.filters, t.img_width, t.img_height, t.img_channels,
                           whitener=t.whitener, normalize_patches=t.normalize_patches, fast=True)
    jfast = jcore.Convolver(jnp.asarray(np_(t.filters)), t.img_width, t.img_height,
                            t.img_channels, whitener=j.whitener,
                            normalize_patches=t.normalize_patches, fast=True)
    want = np_(jfast.apply_batch(JDataset.from_array(jnp.asarray(imgs))))
    exact = np_(t.apply_batch(Dataset.from_array(torch.as_tensor(imgs))))
    got = np_(fast.apply_batch(Dataset.from_array(torch.as_tensor(imgs))))
    one = np.stack([fast.apply(torch.as_tensor(im)).numpy() for im in imgs])
    np.testing.assert_array_equal(got, exact)
    for mine in (got, one):
        assert np.abs(mine - want).max() / np.abs(want).max() < FAST_BAR


def test_convolver_in_chunks_equals_one_batch(monkeypatch):
    j, t, imgs = _conv_pair("whitened", np.random.default_rng(2))
    whole = np_(t.apply_batch(Dataset.from_array(torch.as_tensor(imgs))))
    per_image = t.res_width * t.res_height * t.filters.shape[0] * 4
    monkeypatch.setattr(chunks, "CHUNK_BYTES", per_image)  # one image a chunk
    # the convolution's blocking may differ with the batch size: float32
    # rounding apart, the chunks give the batch's values
    np.testing.assert_allclose(np_(t.apply_batch(Dataset.from_array(torch.as_tensor(imgs)))),
                               whole, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fns", ["sum", "abs_max"])
def test_pooler_matches_jax(fns, monkeypatch):
    rng = np.random.default_rng(3)
    imgs = rng.standard_normal((2, 27, 27, 4)).astype(np.float32)
    if fns == "sum":
        j, t = jcore.Pooler(13, 14), tcore.Pooler(13, 14)
    else:
        j = jcore.Pooler(5, 6, pixel_fn=jnp.abs, pool_fn=lambda w: jnp.max(w, axis=(1, 2)))
        t = tcore.Pooler(5, 6, pixel_fn=torch.abs, pool_fn=lambda w: torch.amax(w, dim=(1, 2)))
        monkeypatch.setattr(chunks, "CHUNK_BYTES", 27 * 27 * 4 * 4)  # one image a chunk
    want = np_(j.apply_batch(JDataset.from_array(jnp.asarray(imgs))))
    got = np_(t.apply_batch(Dataset.from_array(torch.as_tensor(imgs))))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np_(t.apply(torch.as_tensor(imgs[0]))), want[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("max_val,alpha", [(0.0, 0.25), (0.5, -0.25)])
def test_symmetric_rectifier_matches_jax_and_keeps_pad_rows_zero(max_val, alpha, monkeypatch):
    rng = np.random.default_rng(4)
    x = np.zeros((5, 3, 3, 2), np.float32)
    x[:3] = rng.standard_normal((3, 3, 3, 2))
    j = jcore.SymmetricRectifier(max_val, alpha)
    t = tcore.SymmetricRectifier(max_val, alpha)
    want = np_(j.apply_batch(JDataset.from_array(jnp.asarray(x), n=3)))
    monkeypatch.setattr(chunks, "CHUNK_BYTES", 2 * 3 * 3 * 2 * 4 * 2)  # two rows a chunk
    got = np_(t.apply_batch(Dataset.from_array(torch.as_tensor(x), n=3)))
    np.testing.assert_array_equal(got, want)
    assert not got[3:].any()
    np.testing.assert_array_equal(
        np_(tcore.SymmetricRectifier(alpha=0.25).apply(torch.tensor([[[1.0, -2.0]]])))[0, 0],
        [0.75, 0.0, 0.0, 1.75])


def test_vectorizer_cropper_and_packing_layouts_match_jax():
    rng = np.random.default_rng(5)
    imgs = rng.standard_normal((2, 4, 3, 2)).astype(np.float32)
    want = np_(jcore.ImageVectorizer().apply_batch(JDataset.from_array(jnp.asarray(imgs))))
    got = np_(tcore.ImageVectorizer().apply_batch(Dataset.from_array(torch.as_tensor(imgs))))
    np.testing.assert_array_equal(got, want)
    # vec[c + x*C + y*C*X] == img[x, y, c]
    X, C = 4, 2
    for x in range(4):
        for y in range(3):
            for c in range(2):
                assert got[1, c + x * C + y * C * X] == imgs[1, x, y, c]
    np.testing.assert_array_equal(
        np_(tcore.pack_filters([torch.as_tensor(f) for f in imgs])),
        np_(jcore.pack_filters([jnp.asarray(f) for f in imgs])))
    crop_j = np_(jcore.Cropper(1, 0, 3, 2).apply_batch(JDataset.from_array(jnp.asarray(imgs))))
    crop_t = np_(tcore.Cropper(1, 0, 3, 2).apply_batch(Dataset.from_array(torch.as_tensor(imgs))))
    np.testing.assert_array_equal(crop_t, crop_j)


@pytest.mark.parametrize("stride,size", [(2, 3), (1, 6), (3, 2)])
def test_windower_matches_jax(stride, size):
    rng = np.random.default_rng(6)
    imgs = rng.standard_normal((3, 7, 8, 2)).astype(np.float32)
    want = jcore.Windower(stride, size).apply(JDataset.of(imgs))
    got = tcore.Windower(stride, size).apply(Dataset.of(torch.as_tensor(imgs)))
    assert got.n == want.n
    np.testing.assert_array_equal(np_(got.array()), np_(want.array()))


def test_patchers_and_flips_draw_what_jax_draws():
    rng = np.random.default_rng(7)
    imgs = rng.standard_normal((4, 10, 9, 3)).astype(np.float32)
    jds, tds = JDataset.from_array(jnp.asarray(imgs)), Dataset.from_array(torch.as_tensor(imgs))
    for jnode, tnode in (
        (jcore.RandomPatcher(3, 6, 5, seed=2), tcore.RandomPatcher(3, 6, 5, seed=2)),
        (jcore.CenterCornerPatcher(6, 5, horizontal_flips=True),
         tcore.CenterCornerPatcher(6, 5, horizontal_flips=True)),
        (jcore.CenterCornerPatcher(4, 4), tcore.CenterCornerPatcher(4, 4)),
        (jcore.RandomImageTransformer(0.5, seed=3), tcore.RandomImageTransformer(0.5, seed=3)),
    ):
        want, got = jnode.apply_batch(jds), tnode.apply_batch(tds)
        assert got.n == want.n
        np.testing.assert_array_equal(np_(got.array()), np_(want.array()))
    assert tcore.CenterCornerPatcher(4, 4, horizontal_flips=True).patches_per_image == 10
    with pytest.raises(TypeError):
        tcore.RandomPatcher(1, 2, 2).apply(torch.zeros(4, 4, 3))
