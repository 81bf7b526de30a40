"""HOG, DAISY, the image conversions and the image utilities on the CPU
against the JAX package: HOG and DAISY against JAX's extractors and
against the frozen goldens (``tests/fixtures/goldens/``) under the JAX
package's own fractional bar (``tests/ops/test_featurizer_goldens.py``:
at least 99.5 % of entries within 1e-3 and none past 0.05), HOG against
the naive loop translation of the reference, mixed-size batches against
one image at a time, and every conversion and utility function."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.ops.images import conversions as jconv
from keystone_tpu.ops.images import image_utils as jutils
from keystone_tpu.ops.images.daisy import DaisyExtractor as JDaisy
from keystone_tpu.ops.images.hog import HogExtractor as JHog
from keystone_tpu_torch.ops.images import conversions as tconv
from keystone_tpu_torch.ops.images import image_utils as tutils
from keystone_tpu_torch.ops.images.daisy import DaisyExtractor
from keystone_tpu_torch.ops.images.hog import EPSILON, UU, VV, HogExtractor
from keystone_tpu_torch.parallel.dataset import Dataset

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "goldens")
GOLDEN_FRAC, GOLDEN_ATOL, GOLDEN_MAX = 0.995, 1e-3, 0.05


def _load(name):
    return np.loadtxt(os.path.join(FIXDIR, name), delimiter=",")


def _golden_bar(out, want):
    out, want = np.asarray(out), np.asarray(want)
    assert out.shape == want.shape
    diff = np.abs(out - want)
    assert np.mean(diff <= GOLDEN_ATOL) >= GOLDEN_FRAC, np.mean(diff <= GOLDEN_ATOL)
    assert diff.max() <= GOLDEN_MAX, diff.max()
    return diff


# -- HOG ------------------------------------------------------------------------


def test_hog_matches_frozen_golden_and_jax():
    rgb = _load("input_rgb.csv").reshape(64, 64, 3).astype(np.float32)
    out = HogExtractor(bin_size=8, device="cpu").apply(rgb).numpy()
    _golden_bar(out, _load("hog.csv"))
    _golden_bar(out, JHog(bin_size=8).apply(rgb))


@pytest.mark.parametrize("shape,b", [((32, 32, 3), 8), ((50, 37, 3), 8), ((40, 61, 1), 6),
                                     ((24, 24, 3), 8), ((12, 12, 3), 8)])
def test_hog_matches_jax(shape, b):
    rng = np.random.default_rng(sum(shape) + b)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    got = HogExtractor(b, device="cpu").apply(img).numpy()
    want = np.asarray(JHog(b).apply(img))
    assert got.shape == want.shape
    if got.size:
        _golden_bar(got, want)


def test_hog_matches_the_naive_loop():
    """The JAX package's loop translation of the reference
    (tests/ops/test_hog_daisy.py), its histogram and normalization."""
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (24, 24, 3)).astype(np.float32)
    b = 8
    X, Y, C = img.shape
    nx, ny = round(X / b), round(Y / b)
    hist = np.zeros((nx, ny, 18))
    for x in range(1, nx * b - 1):
        for y in range(1, ny * b - 1):
            best, bdx, bdy = -np.inf, 0, 0
            for c in range(C - 1, -1, -1):
                dx = img[x + 1, y, c] - img[x - 1, y, c]
                dy = img[x, y + 1, c] - img[x, y - 1, c]
                if dx * dx + dy * dy > best:
                    best, bdx, bdy = dx * dx + dy * dy, dx, dy
            best_dot, best_o = 0.0, 0
            for o in range(9):
                dot = UU[o] * bdy + VV[o] * bdx
                if dot > best_dot:
                    best_o, best_dot = o, dot
                elif -dot > best_dot:
                    best_o, best_dot = o + 9, -dot
            xp, yp = (x + 0.5) / b - 0.5, (y + 0.5) / b - 0.5
            ixp, iyp = int(np.floor(xp)), int(np.floor(yp))
            vx0, vy0 = xp - ixp, yp - iyp
            for cx, cy, w in [(ixp, iyp, (1 - vx0) * (1 - vy0)), (ixp, iyp + 1, (1 - vx0) * vy0),
                              (ixp + 1, iyp, vx0 * (1 - vy0)), (ixp + 1, iyp + 1, vx0 * vy0)]:
                if 0 <= cx < nx and 0 <= cy < ny:
                    hist[cx, cy, best_o] += w * np.sqrt(best)
    combined = hist[:, :, :9] + hist[:, :, 9:]
    norm = (combined ** 2).sum(2)

    def blk(x0, y0):
        return norm[x0, y0] + norm[x0 + 1, y0] + norm[x0, y0 + 1] + norm[x0 + 1, y0 + 1]

    ns = [1 / np.sqrt(blk(*o) + EPSILON) for o in ((1, 1), (0, 1), (1, 0), (0, 0))]
    hs = [np.minimum(hist[1, 1] * n, 0.2) for n in ns]
    cs = [np.minimum(combined[1, 1] * n, 0.2) for n in ns]
    want = np.zeros((1, 32))
    want[0, :18] = 0.5 * sum(hs)
    want[0, 18:27] = 0.5 * sum(cs)
    want[0, 27:31] = 0.2357 * np.array([h.sum() for h in hs])
    got = HogExtractor(b, device="cpu").apply(img).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)  # the JAX test's bar


def test_hog_and_daisy_mixed_sizes_equal_one_image_at_a_time():
    rng = np.random.default_rng(4)
    imgs = [rng.uniform(0, 255, s).astype(np.float32)
            for s in [(40, 48, 3), (48, 40, 3), (40, 48, 3), (56, 56, 3)]]
    for ext in (HogExtractor(8, device="cpu"), DaisyExtractor(device="cpu")):
        out = ext.apply_batch(Dataset.from_items(imgs)).items()
        for img, o in zip(imgs, out):
            torch.testing.assert_close(o, ext.apply(img), rtol=1e-5, atol=1e-6)
    batch = np.stack([imgs[0], imgs[2]])
    got = HogExtractor(8, device="cpu").apply_batch(Dataset.from_array(batch)).array()
    assert got.shape == (2, 3 * 4, 32)


# -- DAISY ----------------------------------------------------------------------


def test_daisy_matches_frozen_golden_and_jax():
    gray = _load("input_gray.csv").astype(np.float32)
    out = DaisyExtractor(device="cpu").apply(gray).numpy()
    _golden_bar(out, _load("daisy.csv"))
    _golden_bar(out, JDaisy().apply(gray))


@pytest.mark.parametrize("shape,kw", [((48, 48), {}), ((61, 50), {}), ((48, 48, 3), {}),
                                      ((70, 64), dict(daisy_t=6, daisy_q=2, daisy_r=5, stride=6))])
def test_daisy_matches_jax(shape, kw):
    rng = np.random.default_rng(sum(shape))
    img = rng.uniform(0, 1, shape).astype(np.float32)
    got = DaisyExtractor(device="cpu", **kw).apply(img).numpy()
    want = np.asarray(JDaisy(**kw).apply(img))
    _golden_bar(got, want)
    ext = DaisyExtractor(device="cpu", **kw)
    # every H-sized histogram is unit-norm or zero (the JAX test's check)
    for i in range(0, ext.daisy_feature_size, ext.daisy_h):
        norms = np.linalg.norm(got[i:i + ext.daisy_h], axis=0)
        assert ((np.abs(norms - 1) < 1e-4) | (norms < 1e-6)).all()


def test_daisy_conv_pads_asymmetrically_as_jax():
    from keystone_tpu.ops.images.daisy import _conv2d_same as jconv2d
    from keystone_tpu_torch.ops.images.daisy import _conv2d_same

    rng = np.random.default_rng(6)
    x = rng.normal(size=(9, 7)).astype(np.float32)
    for kx, ky in [([1.0, 0.0, -1.0], [1.0, 2.0, 1.0]), ([1.0, 2.0], [0.5, 0.25, 0.125, 1.0]),
                   (list(rng.normal(size=13)), list(rng.normal(size=6)))]:
        got = _conv2d_same(torch.as_tensor(x), kx, ky).numpy()
        np.testing.assert_allclose(got, np.asarray(jconv2d(jnp.asarray(x), kx, ky)),
                                   rtol=1e-5, atol=1e-5)


# -- conversions ------------------------------------------------------------------


@pytest.mark.parametrize("order,channels", [("bgr", 3), ("abgr", 4), ("rgb", 3), ("gray", 1)])
def test_bytes_to_image_equals_jax(order, channels):
    data = bytes(np.random.default_rng(channels).integers(0, 256, 5 * 7 * channels, dtype=np.uint8))
    got = tconv.bytes_to_image(data, 5, 7, channels, order=order, device="cpu")
    want = jconv.bytes_to_image(data, 5, 7, channels, order=order)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bytes_to_image_validates_as_jax():
    for args in [(bytes(4), 1, 1, 4, "bgr"), (bytes(1), 1, 1, 1, "nope"),
                 (bytes(3), 1, 1, 3, "abgr"), (bytes(3), 1, 1, 3, "gray")]:
        with pytest.raises(ValueError):
            tconv.bytes_to_image(*args[:4], order=args[4], device="cpu")
        with pytest.raises(ValueError):
            jconv.bytes_to_image(*args[:4], order=args[4])


def test_conversions_equal_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (5, 7, 3)).astype(np.float32)
    gray = rng.uniform(-3, 9, (5, 7)).astype(np.float32)
    t, j = torch.as_tensor(img), jnp.asarray(img)
    for fn in ("hwc_to_chw", "chw_to_hwc", "vectorize"):
        np.testing.assert_array_equal(getattr(tconv, fn)(t).numpy(), np.asarray(getattr(jconv, fn)(j)))
    vec = tconv.vectorize(t)
    np.testing.assert_array_equal(tconv.unvectorize(vec, (5, 7, 3)).numpy(), img)
    for g in (gray, gray[:, :, None]):
        np.testing.assert_array_equal(tconv.gray_to_rgb(torch.as_tensor(g)).numpy(),
                                      np.asarray(jconv.gray_to_rgb(jnp.asarray(g))))
    packed = tconv.image_to_rgb_ints(t)
    assert packed.dtype == torch.int32
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jconv.image_to_rgb_ints(j)))
    np.testing.assert_array_equal(tconv.rgb_ints_to_image(packed).numpy(), img)
    for x in (gray, gray[:, :, None], img * 3.1 - 100):
        for scale in (False, True):
            np.testing.assert_array_equal(
                tconv.image_to_rgb_ints(torch.as_tensor(x), scale=scale).numpy(),
                np.asarray(jconv.image_to_rgb_ints(jnp.asarray(x), scale=scale)))
    with pytest.raises(ValueError):
        tconv.gray_to_rgb(t)


# -- image utilities ----------------------------------------------------------------


def test_image_utils_equal_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (9, 11, 3)).astype(np.float32)
    t, j = torch.as_tensor(img), jnp.asarray(img)
    np.testing.assert_allclose(tutils.to_gray_scale(t).numpy(),
                               np.asarray(jutils.to_gray_scale(j)), rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(tutils.crop(t, 1, 2, 7, 9).numpy(),
                                  np.asarray(jutils.crop(j, 1, 2, 7, 9)))
    np.testing.assert_array_equal(tutils.flip_horizontal(t).numpy(),
                                  np.asarray(jutils.flip_horizontal(j)))
    np.testing.assert_array_equal(tutils.flip_image(t).numpy(), np.asarray(jutils.flip_image(j)))
    np.testing.assert_array_equal(tutils.pixel_combine(t, t).numpy(),
                                  np.asarray(jutils.pixel_combine(j, j)))
    np.testing.assert_array_equal(tutils.map_pixels(t, lambda x: x * 2).numpy(), img * 2)
    for a, b in zip(tutils.split_channels(t), jutils.split_channels(j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    kx, ky = [1.0, 2.0, 1.0], [0.25, 0.5, 0.125, 1.0]
    for x in (img, img[:, :, :1], img[:, :, 0]):
        np.testing.assert_allclose(tutils.conv2d(torch.as_tensor(x), kx, ky).numpy(),
                                   np.asarray(jutils.conv2d(jnp.asarray(x), kx, ky)),
                                   rtol=1e-5, atol=1e-3)
    path = str(tmp_path / "x.png")
    Image.fromarray(img.astype(np.uint8)).save(path)
    loaded = tutils.load_image(path, device="cpu")
    np.testing.assert_array_equal(loaded.numpy(), np.asarray(jutils.load_image(path)))
    (tmp_path / "bad.png").write_bytes(b"not an image")
    assert tutils.load_image(str(tmp_path / "bad.png"), device="cpu") is None
