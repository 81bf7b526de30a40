"""``gram``, ``tsqr_r`` and ``qr_q`` and the one-device shuffle on the CPU
against the JAX package: the Gram matrix of float32 and bf16 inputs (a
float32 result either way), Q and R (Q orthonormal, QR = A), the bucket
packing with its validity mask and overflow count, ``repartition_by_key``,
and ``device_shuffle`` against JAX's and the host ``Shuffler``'s rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.parallel import linalg as jlinalg
from keystone_tpu.parallel import mesh as mesh_lib
from keystone_tpu.parallel import shuffle as jshuffle
from keystone_tpu_torch.ops.util.nodes import Shuffler
from keystone_tpu_torch.parallel import linalg as tlinalg
from keystone_tpu_torch.parallel import shuffle as tshuffle
from keystone_tpu_torch.parallel.dataset import Dataset

# the JAX package's bars for these (tests/parallel/test_linalg.py): 1e-4
RTOL = 1e-4


def _one_device_mesh():
    return mesh_lib.make_mesh(n_data=1, devices=jax.devices()[:1])


@pytest.mark.parametrize("shape", [(64, 8), (300, 17), (1000, 64)])
def test_gram_float32_matches_jax(shape):
    a = np.random.default_rng(shape[0]).normal(size=shape).astype(np.float32)
    got = tlinalg.gram(torch.as_tensor(a))
    want = np.asarray(jlinalg.gram(jnp.asarray(a)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_gram_of_bf16_comes_back_float32_as_jax():
    a = np.random.default_rng(3).normal(size=(200, 12)).astype(np.float32)
    tb = torch.as_tensor(a).to(torch.bfloat16)
    got = tlinalg.gram(tb)
    want = jlinalg.gram(jnp.asarray(a, jnp.bfloat16))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    # float32 accumulation of exact bf16 products: both equal float64's
    exact = tb.double().T @ tb.double()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=RTOL, atol=1e-3)


@pytest.mark.parametrize("shape", [(128, 6), (500, 40)])
def test_qr_q_matches_jax(shape):
    a = np.random.default_rng(shape[1]).normal(size=shape).astype(np.float32)
    q, r = tlinalg.qr_q(torch.as_tensor(a))
    with mesh_lib.use_mesh(_one_device_mesh()):
        jq, jr = jlinalg.qr_q(jnp.asarray(a))
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=RTOL, atol=RTOL)
    assert (torch.diagonal(r) >= 0).all()
    d = shape[1]
    assert float((q.T @ q - torch.eye(d)).abs().max()) < 1e-4
    assert float(torch.linalg.norm(q @ r - torch.as_tensor(a)) / np.linalg.norm(a)) < 1e-5
    np.testing.assert_allclose(tlinalg.tsqr_r(torch.as_tensor(a)).numpy(), r.numpy())


@pytest.mark.parametrize("n_shards,capacity", [(1, 16), (1, 5), (3, 4), (3, 2)])
def test_bucket_packing_matches_jax(n_shards, capacity):
    rng = np.random.default_rng(n_shards * 10 + capacity)
    m = 16
    dest = rng.integers(0, n_shards + 2, m).astype(np.int32)  # some discarded
    x = rng.normal(size=(m, 3)).astype(np.float32)
    ids = np.arange(m, dtype=np.int32)
    (tb, tid), tvalid, tover = tshuffle._pack_buckets(
        (torch.as_tensor(x), torch.as_tensor(ids)), torch.as_tensor(dest), n_shards, capacity)
    (jb, jid), jvalid, jover = jshuffle._pack_buckets(
        (jnp.asarray(x), jnp.asarray(ids)), jnp.asarray(dest), n_shards, capacity)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert int(tover) == int(jover)
    kept = int((dest < n_shards).sum())
    assert int(tover) == kept - int(tvalid.sum())


@pytest.mark.parametrize("capacity", [24, 7])
def test_repartition_by_key_matches_jax_on_one_shard(capacity):
    rng = np.random.default_rng(capacity)
    keys = rng.integers(-3, 50, 24).astype(np.int32)  # negative keys discard
    x = rng.normal(size=(24, 2)).astype(np.float32)
    (rows,), valid, over = tshuffle.repartition_by_key(
        (torch.as_tensor(x),), torch.as_tensor(keys), capacity)
    (jrows,), jvalid, jover = jshuffle.repartition_by_key(
        (jnp.asarray(x),), jnp.asarray(keys), capacity, _one_device_mesh())
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert int(over) == int(jover) == max(int((keys >= 0).sum()) - capacity, 0)


@pytest.mark.parametrize("n,n_pad", [(10, 16), (16, 16), (37, 40)])
def test_device_shuffle_matches_jax_and_the_host_shuffler(n, n_pad, mesh8):
    rng = np.random.default_rng(n)
    x = np.zeros((n_pad, 3), np.float32)
    x[:n] = rng.normal(size=(n, 3))
    got = tshuffle.device_shuffle(torch.as_tensor(x), n, seed=5)
    with mesh_lib.use_mesh(mesh8):
        want = np.asarray(jshuffle.device_shuffle(jnp.asarray(x), n, seed=5))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[n:] == 0).all()
    host = Shuffler(seed=5).apply_batch(Dataset.from_array(torch.as_tensor(x[:n]))).array()
    np.testing.assert_array_equal(got[:n].numpy(), host.numpy())
    on_device = Shuffler(seed=5, device=True).apply_batch(
        Dataset.from_array(torch.as_tensor(x), n=n))
    np.testing.assert_array_equal(on_device.padded().numpy(), got.numpy())
