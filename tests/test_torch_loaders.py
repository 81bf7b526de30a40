"""The port's loaders on the CPU against the JAX package's, on tars of
seeded JPEGs of mixed sizes built in place: the eager ``ImageNetLoader``,
``VOCLoader`` and ``MultiLabelExtractor``; ``StreamingImageLoader``'s
items (with ``limit`` and ``cycle``), batches in uint8 and float32, the
native and PIL decodes at a fixed size, and ``featurized_batches`` through
a CPU engine; ``tar_shard_paths``; and ``main`` on a tiny tar."""

import io
import os
import tarfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.loaders import image_loaders as jloaders
from keystone_tpu.loaders import streaming as jstreaming
from keystone_tpu.pipelines.images import imagenet_sift_lcs_fv as jflagship
from keystone_tpu.serving.featurize import (
    build_flagship_featurize_pipeline as jax_build,
)
from keystone_tpu_torch import native
from keystone_tpu_torch.loaders import image_loaders as tloaders
from keystone_tpu_torch.loaders import streaming as tstreaming
from keystone_tpu_torch.pipelines.images import imagenet_sift_lcs_fv as tflagship
from keystone_tpu_torch.serving.engine import CompiledPipeline
from keystone_tpu_torch.serving.featurize import (
    build_flagship_featurize_pipeline as torch_build,
)
from keystone_tpu_torch.workflow.executor import PipelineEnv as TEnv

WNIDS = ["n01000001", "n01000002", "n01000003"]
SIZES = [(48, 40), (40, 48), (64, 52)]  # (width, height) of PIL images
# the features' bar of tests/serving/test_device_featurize.py
FEAT_TOL = dict(rtol=1e-4, atol=1e-5)


def _jpeg(w, h, seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    x, y = np.meshgrid(np.arange(w), np.arange(h))
    f = 3.0 + seed % 5
    base = 128 + 80 * np.sin(x / f) * np.cos(y / (f + 1))
    img = np.stack([base + rng.normal(0, 6, (h, w)) + 10 * c for c in range(3)], -1)
    buf = io.BytesIO()
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(buf, "JPEG", quality=90)
    return buf.getvalue()


def _write_tar(path, members):
    with tarfile.open(path, "w") as tf:
        for name, data in members:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


@pytest.fixture(scope="module")
def tars(tmp_path_factory):
    """Three tars (one per WNID, 4 images each, sizes cycling through
    SIZES, one member of an unmapped WNID), the WNID map, and a VOC tar
    with its labels CSV."""
    d = tmp_path_factory.mktemp("tars")
    for t, wnid in enumerate(WNIDS):
        members = [(f"{wnid}_{i}.JPEG", _jpeg(*SIZES[(t + i) % 3], 10 * t + i)) for i in range(4)]
        if t == 1:
            members.insert(2, ("n09999999_0.JPEG", _jpeg(40, 40, 99)))
        _write_tar(str(d / f"{wnid}.tar"), members)
    labels = d / "labels.txt"
    labels.write_text("".join(f"{w} {i}\n" for i, w in enumerate(WNIDS)))
    voc = d / "voc"
    voc.mkdir()
    _write_tar(str(voc / "voc.tar"), [(f"VOC2007/img_{i}.jpg", _jpeg(*SIZES[i % 3], 50 + i))
                                      for i in range(5)])
    voc_labels = d / "voclabels.csv"
    voc_labels.write_text("id,class,classname,traintesteval,filename\n" + "".join(
        f"{j},{c},x,train,VOC2007/img_{i}.jpg\n"
        for j, (i, c) in enumerate([(0, 1), (1, 2), (2, 1), (2, 3), (3, 2)])))
    return str(d), str(labels), str(voc), str(voc_labels)


def test_eager_loaders_match_jax(tars):
    loc, labels, voc, voc_labels = tars
    want, got = jloaders.ImageNetLoader(loc, labels), tloaders.ImageNetLoader(loc, labels)
    assert not got.is_array and got.n == want.n == 12
    assert len({li.image.shape for li in got.items()}) == 3
    for g, w in zip(got.items(), want.items()):
        assert (g.filename, g.label) == (w.filename, w.label)
        assert isinstance(g, tloaders.LabeledImage) and g.image.dtype == np.float32
        np.testing.assert_array_equal(g.image, w.image)
    want, got = jloaders.VOCLoader(voc, voc_labels), tloaders.VOCLoader(voc, voc_labels)
    assert got.n == want.n == 4
    for g, w in zip(got.items(), want.items()):
        assert (g.filename, g.label, g.labels) == (w.filename, w.label, w.labels)
        np.testing.assert_array_equal(g.image, w.image)
    for g, w in zip(tloaders.MultiLabelExtractor.apply(got).items(),
                    jloaders.MultiLabelExtractor.apply(want).items()):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("limit,cycle,processes", [(None, 1, 0), (5, 1, 0), (17, 2, 0), (None, 1, 2)])
def test_streaming_items_match_jax(tars, limit, cycle, processes):
    """Threads, and spawned decode processes (which import the streaming
    module and neither torch nor jax), give the JAX package's stream."""
    loc, labels, _, _ = tars
    kw = dict(shard_index=0, num_shards=1, limit=limit, cycle=cycle, decode_window=3,
              decode_processes=processes)
    want = list(jstreaming.StreamingImageNetLoader(loc, labels, **kw).items())
    got = list(tstreaming.StreamingImageNetLoader(loc, labels, **kw).items())
    assert len(got) == len(want) == (limit or 12 * cycle)
    for (gn, gl, ga), (wn, wl, wa) in zip(got, want):
        assert (gn, gl) == (wn, wl)
        np.testing.assert_array_equal(ga, wa)


@pytest.mark.parametrize("native_decode", [True, False], ids=["native", "pil"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_batches_match_jax(tars, native_decode, dtype):
    loc, labels, _, _ = tars
    kw = dict(decode_size=32, shard_index=0, num_shards=1, use_native_decode=native_decode)
    want = list(jstreaming.StreamingImageNetLoader(loc, labels, **kw).batches(5, dtype))
    got = list(tstreaming.StreamingImageNetLoader(loc, labels, **kw).batches(5, dtype))
    assert [n for _, _, n in got] == [n for _, _, n in want] == [5, 5, 2]
    for (gb, gl, _), (wb, wl, _) in zip(got, want):
        assert gl == wl and gb.dtype == wb.dtype == dtype and gb.shape == (5, 32, 32, 3)
        np.testing.assert_array_equal(gb, wb)


def test_native_and_pil_decodes_agree(tars):
    loc, labels, _, _ = tars
    assert native.jpeg_native_available()
    assert os.path.dirname(native._JPEG._path()) == native.BUILD_DIR
    kw = dict(decode_size=24, shard_index=0, num_shards=1)
    nat = list(tstreaming.StreamingImageNetLoader(loc, labels, **kw).items())
    pil = list(tstreaming.StreamingImageNetLoader(loc, labels, use_native_decode=False, **kw).items())
    for (nn, nl, na), (pn, pl, pa) in zip(nat, pil):
        assert (nn, nl) == (pn, pl) and na.shape == pa.shape == (24, 24, 3)
        # both decode the DCT at draft scale and resize by a triangle
        # filter: within a few levels of each other
        assert np.abs(na - pa).mean() < 3.0
    blobs = [_jpeg(48, 40, 1), _jpeg(40, 48, 2), b"not a jpeg"]
    imgs, ok = native.jpeg_decode_batch_f32(blobs, 16)
    assert ok.tolist() == [True, True, False]
    np.testing.assert_array_equal(imgs[0], native.jpeg_decode_f32(blobs[0], 16))
    assert native.jpeg_decode_f32(blobs[2], 16) is None


def test_tar_shard_paths_are_disjoint_and_cover(tars):
    loc = tars[0]
    whole = tstreaming.tar_shard_paths(loc, 0, 1)
    assert whole == jstreaming.tar_shard_paths(loc, 0, 1) and len(whole) == 3
    for world in (2, 3):
        parts = [tstreaming.tar_shard_paths(loc, r, world) for r in range(world)]
        assert parts == [jstreaming.tar_shard_paths(loc, r, world) for r in range(world)]
        assert sorted(sum(parts, [])) == whole
        assert sum(len(p) for p in parts) == len(set(sum(parts, [])))
    # no process group: shard 0 of 1
    assert tstreaming.tar_shard_paths(loc) == whole
    one = os.path.join(loc, f"{WNIDS[0]}.tar")
    assert tstreaming.tar_shard_paths(one, 0, 1) == [one]


def test_featurized_batches_match_jax_featurize(tars):
    loc, labels, _, _ = tars
    TEnv.get_or_create().reset()
    geometry = dict(img=32, desc_dim=4, vocab=2, sift_step=4, sift_bin=4, sift_scales=2,
                    sift_scale_step=1, lcs_stride=4, lcs_border=8, lcs_patch=6)
    jfeat, dim = jax_build(**geometry)
    tfeat, tdim = torch_build(device="cpu", **geometry)
    assert tdim == dim
    engine = CompiledPipeline(tfeat, (4,), device="cpu")
    kw = dict(decode_size=32, shard_index=0, num_shards=1)
    got, labs = [], []
    for feats, lab, n in tstreaming.StreamingImageNetLoader(loc, labels, **kw).featurized_batches(engine, 4):
        assert feats.shape == (4, dim)
        got.append(feats[:n].numpy())
        labs += lab
    want = [np.asarray(jfeat._batch_run(jnp.asarray(b)))[:n]
            for b, _, n in jstreaming.StreamingImageNetLoader(loc, labels, **kw).batches(4, np.uint8)]
    assert labs == [0] * 4 + [1] * 4 + [2] * 4
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want), **FEAT_TOL)
    TEnv.get_or_create().reset()


def test_main_prints_the_same_error_as_jax(tmp_path, capsys):
    """``main`` on a tiny train and test tar of 48 x 40 and 40 x 48 images
    (sizes the JAX package's ``run`` also takes together)."""
    from keystone_tpu.workflow.executor import PipelineEnv as JEnv

    for split, n, seed in (("train", 6, 0), ("test", 3, 100)):
        members = []
        for t, wnid in enumerate(WNIDS):
            members += [(f"{wnid}_{i}.JPEG", _jpeg(*SIZES[(t + i) % 2], seed + 10 * t + i))
                        for i in range(n)]
        _write_tar(str(tmp_path / f"{split}.tar"), members)
    labels = tmp_path / "labels.txt"
    labels.write_text("".join(f"{w} {i}\n" for i, w in enumerate(WNIDS)))
    argv = ["--trainLocation", str(tmp_path / "train.tar"), "--testLocation",
            str(tmp_path / "test.tar"), "--labelPath", str(labels), "--descDim", "4",
            "--vocabSize", "2", "--lambda", "1e-4"]
    JEnv.get_or_create().reset()
    assert jflagship.main(argv) == 0
    want = capsys.readouterr().out.splitlines()
    TEnv.get_or_create().reset()
    assert tflagship.main(argv, device="cpu") == 0
    got = capsys.readouterr().out.splitlines()
    JEnv.get_or_create().reset()
    TEnv.get_or_create().reset()
    assert len(got) == len(want) == 2
    assert got[0] == want[0] and got[0].startswith("TEST Top-5 error is ")
    assert got[1].startswith("Total time: ")
    with pytest.raises(SystemExit):
        tflagship.main(["--trainLocation", "x"], device="cpu")
    assert isinstance(torch.zeros(1), torch.Tensor)
