"""The port's data-parallel layer at 2 and 4 processes, held against the
JAX package at as many devices.

``parallel/virtual.launch`` starts the processes (gloo, a ``FileStore``
rendezvous, the ``spawn`` method, a time limit per launch); each runs
``_checks`` on its own rows of the same seeded numpy inputs: the mesh and
its multislice shape, ``Dataset.shard`` padding and masks, ``gram``,
``tsqr_r``, ``qr_q``, the three shuffles, the block fit in memory and
from host blocks, its checkpoint resume, the least-squares block path,
the TSQR column PCA and an apply on sharded rows. The JAX side runs in this process on an
N-device sub-mesh of its 8 virtual devices (``make_mesh(n_data=N,
devices=jax.devices()[:N])``), so both sum in N shards. Bars: the JAX
tests' own, rtol 2e-4 / atol 2e-5 between fits (``FIT_TOL``,
tests/test_torch_block_ls.py:29), 1e-4 for the PCA (its
tests/test_torch_training.py bar), float32 rounding (rtol 1e-5) for the
Gram and the QR factors, bit for bit for routing and padding. W must be
identical on every process. One launch per group size, module-scoped;
the workers import no JAX (this module imports it only inside tests).

Then ``runtime.initialize``'s contract: a no-op without a configuration
and idempotent, a clear error on a partial one, a refusal to run alone
where the environment looks like a cluster, a CUDA run without a card
raises; a collective that hangs fails within the launch's limit; and two
processes joined through JAX's ``COORDINATOR_ADDRESS`` /
``NUM_PROCESSES`` / ``PROCESS_ID`` fit rows that span both (the
counterpart of tests/parallel/test_multiprocess.py)."""

import dataclasses
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from keystone_tpu_torch.parallel import runtime, virtual

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIT_TOL = dict(rtol=2e-4, atol=2e-5)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
PCA_TOL = 1e-4
LAUNCH_S = 120.0
WORLDS = (2, 4)


def _inputs():
    """Seeded numpy inputs shared by both sides."""
    rng = np.random.default_rng(22)
    n, d, k = 50, 24, 3  # 50 rows: padded at both 2 and 4 shards
    X = rng.standard_normal((n, d)).astype(np.float32)
    Y = (X @ rng.standard_normal((d, k)) + 0.3 * rng.standard_normal((n, k))).astype(np.float32)
    Xh = rng.standard_normal((48, d)).astype(np.float32)  # 48 rows: no padding
    Yh = (Xh @ rng.standard_normal((d, k))).astype(np.float32)
    A = rng.standard_normal((64, 8)).astype(np.float32)
    S = rng.standard_normal((40, 3)).astype(np.float32)  # 40 rows: 10 or 20 a shard
    dest = rng.integers(0, 6, 40).astype(np.int64)  # some past the shard count: dropped
    keys = rng.integers(-2, 30, 40).astype(np.int64)
    mats = np.stack([
        (rng.standard_normal((6, 3)) @ rng.standard_normal((3, 5))).astype(np.float32)
        for _ in range(12)
    ])
    return dict(X=X, Y=Y, Xh=Xh, Yh=Yh, A=A, S=S, dest=dest, keys=keys, mats=mats)


class _Interrupt(RuntimeError):
    pass


def _fail_after(k):
    def cb(done):
        if done >= k:
            raise _Interrupt(f"injected failure after {k} blocks")
    return cb


def _checks(inp):
    """One process's part of every check; returns what the test compares."""
    import keystone_tpu_torch.parallel.mesh as mesh_lib
    from keystone_tpu_torch.ops.learning.block_ls import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.learning.least_squares import LeastSquaresEstimator
    from keystone_tpu_torch.ops.learning.pca import DistributedColumnPCAEstimator
    from keystone_tpu_torch.ops.util.nodes import Shuffler
    from keystone_tpu_torch.parallel import linalg, shuffle
    from keystone_tpu_torch.parallel.dataset import Dataset

    t = torch.as_tensor
    world = runtime.process_count()
    out = {"rank": runtime.process_index(), "jax_imported": "jax" in sys.modules}
    mesh = mesh_lib.current_mesh()
    out["mesh"] = (mesh.shape, mesh.ranks, mesh_lib.n_data_shards(mesh))
    ms = runtime.make_multislice_mesh(n_slices=2) if world % 2 == 0 else None
    out["multislice"] = (ms.axis_names, ms.shape, mesh_lib.n_data_shards(ms),
                         tuple(mesh_lib.data_sharding(ms).spec))
    out["shape_logic"] = runtime.multislice_shape(world, n_slices=2, n_model=1)
    try:
        Dataset.from_array(t(inp["X"])).shard(mesh_lib.make_mesh(n_model=2))
        out["model_axis"] = "no error"
    except NotImplementedError as e:
        out["model_axis"] = str(e)

    # Dataset.shard: padding, masks, the gathered views
    ds = Dataset.from_array(t(inp["X"])).shard()
    out["shard"] = dict(n=ds.n, padded_n=ds.padded_n, local=ds.local(), mask=ds.mask(),
                        padded=ds.padded(), first=ds.first(), array=ds.array())
    hb = Dataset.from_host_array(t(inp["X"]), 8, device="cpu").shard()
    out["host_shard"] = dict(padded_n=hb.padded_n, widths=hb.block_widths,
                             local=torch.cat(hb.host_blocks, 1), mask=hb.mask())

    # gram, tsqr_r, qr_q over row shards
    A = Dataset.from_array(t(inp["A"])).shard()
    out["gram"] = linalg.gram(A.local(), A.mesh)
    out["tsqr_r"] = linalg.tsqr_r(A.local(), A.mesh)
    out["qr_q"] = linalg.qr_q(A.local(), A.mesh)

    # the three shuffles over the same shards
    per = inp["S"].shape[0] // world
    lo = runtime.process_index() * per
    mine = slice(lo, lo + per)
    S = t(inp["S"][mine])
    ids = t(np.arange(lo, lo + per))
    out["a2a"] = shuffle.all_to_all_repartition((S, ids), t(inp["dest"][mine]), 6, mesh)
    out["by_key"] = shuffle.repartition_by_key((S,), t(inp["keys"][mine]), 7, mesh)
    Sd = Dataset.from_array(t(inp["S"]), n=37).shard()
    out["device_shuffle"] = shuffle.device_shuffle(Sd.local(), 37, seed=5, mesh=mesh)
    out["shuffler"] = Shuffler(seed=5, device=True).apply_batch(Sd).local()

    # the block fit in memory (padded rows), its apply, and from host blocks
    est = BlockLeastSquaresEstimator(8, num_iter=2, lam=0.1)
    data = Dataset.from_array(t(inp["X"])).shard()
    model = est.fit(data, Dataset.from_array(t(inp["Y"])))
    out["fit"] = dict(W=model.W, mu=model.feature_mean, mu_y=model.label_mean)
    out["fit_gathered"] = mesh_lib.all_gather_rows(model.W[None], mesh)
    out["apply"] = model.apply_batch(data).local()
    hosted = Dataset.from_host_array(t(inp["Xh"]), 8, device="cpu")  # sharded by the fit
    hmodel = BlockLeastSquaresEstimator(8, num_iter=1).fit(hosted, Dataset.from_array(t(inp["Yh"])))
    out["host_fit"] = dict(W=hmodel.W, mu=hmodel.feature_mean)
    out["host_fit_gathered"] = mesh_lib.all_gather_rows(hmodel.W[None], mesh)
    # interrupted after 4 of 6 block updates, resumed from shard 0's snapshot
    path = os.path.join(inp["ckpt_dir"], f"bls{world}.npz")
    try:
        dataclasses.replace(est, checkpoint_path=path, checkpoint_every=2,
                            block_callback=_fail_after(4)).fit(data, Dataset.from_array(t(inp["Y"])))
    except _Interrupt:
        pass
    done = []
    resumed = dataclasses.replace(est, checkpoint_path=path, checkpoint_every=2,
                                  block_callback=done.append).fit(data, Dataset.from_array(t(inp["Y"])))
    out["resume"] = dict(W=resumed.W, done=done,
                         gathered=mesh_lib.all_gather_rows(resumed.W[None], mesh))
    block_path = LeastSquaresEstimator(lam=0.1)._options()[2][1]
    out["ls_block"] = block_path.fit(data, Dataset.from_array(t(inp["Y"]))).transformers[-1].W
    if ms is not None:
        out["multislice_fit"] = est.fit(Dataset.from_array(t(inp["X"])).shard(ms),
                                        Dataset.from_array(t(inp["Y"]))).W

    # the TSQR column PCA, its columns sharded over the current mesh
    out["column_pca"] = DistributedColumnPCAEstimator(3).fit(
        Dataset.from_items([t(m) for m in inp["mats"]])).pca_mat
    out["stats"] = {k: list(v) for k, v in mesh_lib.STATS.items()}
    out["jax_imported_after"] = "jax" in sys.modules
    return out


def _launch(inp, world):
    t0 = time.monotonic()
    got = virtual.launch(_checks, world, (inp,), device="cpu", timeout_s=LAUNCH_S, threads=1)
    return got + [time.monotonic() - t0]


def _jax_shuffle(inp, world, which):
    """One of the JAX package's three shuffles at ``world`` shards, given
    its mesh (no ``use_mesh``: these run in threads beside each other)."""
    import jax.numpy as jnp

    from keystone_tpu.parallel import shuffle as jshuffle

    jm = _jax_mesh(world)
    S = jnp.asarray(inp["S"])
    if which == "a2a":
        ids = jnp.arange(inp["S"].shape[0], dtype=jnp.int32)
        return jshuffle.all_to_all_repartition(
            (S, ids), jnp.asarray(inp["dest"].astype(np.int32)), 6, jm)
    if which == "by_key":
        return jshuffle.repartition_by_key((S,), jnp.asarray(inp["keys"].astype(np.int32)), 7, jm)
    x = inp["S"].copy()
    x[37:] = 0
    return np.asarray(jshuffle.device_shuffle(jnp.asarray(x), 37, seed=5, mesh=jm))


SHUFFLES = ("a2a", "by_key", "device_shuffle")


@pytest.fixture(scope="module")
def runs():
    """Both launches, and the JAX shuffles (seconds of XLA compiles each),
    side by side."""
    inp = dict(_inputs(), ckpt_dir=tempfile.mkdtemp(prefix="keystone_dist_ckpt_"))
    try:
        with ThreadPoolExecutor(len(WORLDS) * (1 + len(SHUFFLES))) as pool:
            launches = {w: pool.submit(_launch, inp, w) for w in WORLDS}
            shuffles = {(w, k): pool.submit(_jax_shuffle, inp, w, k)
                        for w in WORLDS for k in SHUFFLES}
            got = {w: f.result() for w, f in launches.items()}
            got["jax_shuffles"] = {w: {k: shuffles[w, k].result() for k in SHUFFLES}
                                   for w in WORLDS}
        got["snapshots_left"] = sorted(os.listdir(inp["ckpt_dir"]))
        yield inp, got
    finally:
        shutil.rmtree(inp["ckpt_dir"], ignore_errors=True)


def _jax_mesh(world):
    import jax

    from keystone_tpu.parallel import mesh as jmesh

    return jmesh.make_mesh(n_data=world, devices=jax.devices()[:world])


def _cat(results, key):
    return np.concatenate([np.asarray(r[key]) for r in results[:-1]])


# -- the workers ------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_workers_import_no_jax_and_launch_in_time(runs, world):
    _, got = runs
    for r in got[world][:-1]:
        assert not r["jax_imported"] and not r["jax_imported_after"], r["rank"]
    assert [r["rank"] for r in got[world][:-1]] == list(range(world))
    assert got[world][-1] < LAUNCH_S


# -- the mesh ----------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_and_multislice_axes_match_jax(runs, world):
    import jax

    from keystone_tpu.parallel import mesh as jmesh
    from keystone_tpu.parallel import runtime as jruntime

    _, got = runs
    r0 = got[world][0]
    shape, ranks, shards = r0["mesh"]
    jm = _jax_mesh(world)
    assert shape == dict(jm.shape) and shards == jmesh.n_data_shards(jm) == world
    assert ranks == tuple((r,) for r in range(world))
    names, ms_shape, ms_shards, spec = r0["multislice"]
    jms = jruntime.make_multislice_mesh(n_slices=2, devices=jax.devices()[:world])
    assert names == jms.axis_names and ms_shape == dict(jms.shape)
    assert ms_shards == jmesh.n_data_shards(jms) == world
    assert spec == tuple(jmesh.data_sharding(jms).spec)
    assert r0["shape_logic"] == jruntime.multislice_shape(world, n_slices=2, n_model=1)
    assert "model axis" in r0["model_axis"] and "ROADMAP" in r0["model_axis"]


def test_multislice_shape_logic_matches_jax():
    from keystone_tpu.parallel import runtime as jruntime

    for args in ((64, 4, 2), (8, 2, 1), (256, 4, 8)):
        assert runtime.multislice_shape(*args) == jruntime.multislice_shape(*args)
    for bad in ((8, 3, 1), (8, 2, 3)):
        with pytest.raises(ValueError):
            runtime.multislice_shape(*bad)
        with pytest.raises(ValueError):
            jruntime.multislice_shape(*bad)


# -- Dataset.shard -------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_shard_pads_and_masks_as_jax(runs, world):
    import jax.numpy as jnp

    from keystone_tpu.parallel.dataset import Dataset as JDataset

    inp, got = runs
    jds = JDataset.from_array(jnp.asarray(inp["X"])).shard(_jax_mesh(world))
    res = [r["shard"] for r in got[world][:-1]]
    assert {r["n"] for r in res} == {jds.n} and {r["padded_n"] for r in res} == {jds.padded_n}
    want = np.asarray(jds.padded())
    np.testing.assert_array_equal(np.concatenate([r["local"] for r in res]), want)
    np.testing.assert_array_equal(np.concatenate([r["mask"] for r in res]), np.asarray(jds.mask()))
    for r in res:  # the whole-array views gather
        np.testing.assert_array_equal(r["padded"], want)
        np.testing.assert_array_equal(r["array"], inp["X"])
        np.testing.assert_array_equal(r["first"], inp["X"][0])
    hres = [r["host_shard"] for r in got[world][:-1]]
    np.testing.assert_array_equal(np.concatenate([r["local"] for r in hres]), want)
    assert {r["padded_n"] for r in hres} == {jds.padded_n}
    assert hres[0]["widths"] == [8, 8, 8]


# -- gram, tsqr_r, qr_q --------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_gram_tsqr_and_qr_match_jax(runs, world):
    import jax.numpy as jnp

    from keystone_tpu.parallel import linalg as jlinalg
    from keystone_tpu.parallel.dataset import Dataset as JDataset

    inp, got = runs
    jm = _jax_mesh(world)
    A = JDataset.from_array(jnp.asarray(inp["A"])).shard(jm).padded()
    res = got[world][:-1]
    want_r = np.asarray(jlinalg.tsqr_r(A, jm))
    want_q, _ = jlinalg.qr_q(A, jm)
    for r in res:
        np.testing.assert_allclose(r["gram"], np.asarray(jlinalg.gram(A)), **F32_TOL)
        np.testing.assert_allclose(r["tsqr_r"], want_r, **F32_TOL)
        np.testing.assert_array_equal(r["tsqr_r"], res[0]["tsqr_r"])
        np.testing.assert_array_equal(r["qr_q"][1], res[0]["tsqr_r"])
    q = np.concatenate([r["qr_q"][0] for r in res])
    np.testing.assert_allclose(q, np.asarray(want_q), **F32_TOL)
    np.testing.assert_allclose(q.T @ q, np.eye(8), atol=1e-4)


# -- the shuffles ---------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_repartitions_match_jax_at_the_same_shard_count(runs, world):
    _, got = runs
    res = got[world][:-1]
    jax_got = got["jax_shuffles"][world]
    (jrows, jids), jvalid, jover = jax_got["a2a"]
    np.testing.assert_array_equal(np.concatenate([r["a2a"][0][0] for r in res]), np.asarray(jrows))
    np.testing.assert_array_equal(np.concatenate([r["a2a"][0][1] for r in res]), np.asarray(jids))
    np.testing.assert_array_equal(np.concatenate([r["a2a"][1] for r in res]), np.asarray(jvalid))
    assert {int(r["a2a"][2]) for r in res} == {int(jover)}
    (jrows,), jvalid, jover = jax_got["by_key"]
    np.testing.assert_array_equal(np.concatenate([r["by_key"][0][0] for r in res]), np.asarray(jrows))
    np.testing.assert_array_equal(np.concatenate([r["by_key"][1] for r in res]), np.asarray(jvalid))
    assert {int(r["by_key"][2]) for r in res} == {int(jover)}


@pytest.mark.parametrize("world", WORLDS)
def test_device_shuffle_matches_jax_and_the_host_shuffler(runs, world):
    inp, got = runs
    res = got[world][:-1]
    want = got["jax_shuffles"][world]["device_shuffle"]
    np.testing.assert_array_equal(_cat(got[world], "device_shuffle"), want)
    np.testing.assert_array_equal(np.concatenate([r["shuffler"] for r in res]), want)
    perm = np.random.default_rng(5).permutation(37)
    np.testing.assert_array_equal(want[:37], inp["S"][perm])


# -- the block solver and the PCA ---------------------------------------------


def _jax_fit(world, X, Y, block=8, host=False, **kw):
    import jax.numpy as jnp

    from keystone_tpu.ops.learning import BlockLeastSquaresEstimator as JBLS
    from keystone_tpu.parallel import mesh as jmesh
    from keystone_tpu.parallel.dataset import Dataset as JDataset

    jm = _jax_mesh(world)
    with jmesh.use_mesh(jm):
        if host:
            data, labels = JDataset.from_host_array(X, block), JDataset.from_array(jnp.asarray(Y))
        else:
            data = JDataset.from_array(jnp.asarray(X)).shard(jm)
            labels = JDataset.from_array(jnp.asarray(Y)).shard(jm)
        return JBLS(block, **kw).fit(data, labels)


@pytest.mark.parametrize("world", WORLDS)
def test_block_fit_on_sharded_rows_matches_jax_and_every_rank_agrees(runs, world):
    inp, got = runs
    res = got[world][:-1]
    jm = _jax_fit(world, inp["X"], inp["Y"], num_iter=2, lam=0.1)
    for r in res:
        np.testing.assert_allclose(r["fit"]["W"], np.asarray(jm.W), **FIT_TOL)
        np.testing.assert_allclose(r["fit"]["mu"], np.asarray(jm.feature_mean), **FIT_TOL)
        np.testing.assert_allclose(r["fit"]["mu_y"], np.asarray(jm.label_mean), **FIT_TOL)
        # W bit for bit the same on every process (gathered there, and here)
        for w in r["fit_gathered"]:
            np.testing.assert_array_equal(w, r["fit"]["W"])
        np.testing.assert_array_equal(r["fit"]["W"], res[0]["fit"]["W"])
    import jax.numpy as jnp

    from keystone_tpu.parallel.dataset import Dataset as JDataset

    jpred = jm.apply_batch(JDataset.from_array(jnp.asarray(inp["X"])).shard(_jax_mesh(world)))
    np.testing.assert_allclose(_cat(got[world], "apply"), np.asarray(jpred.padded()), **FIT_TOL)
    # LeastSquares' block path: Densify -> BlockLeastSquaresEstimator(1000, 3)
    jls = _jax_fit(world, inp["X"], inp["Y"], block=1000, num_iter=3, lam=0.1)
    for r in res:
        np.testing.assert_allclose(r["ls_block"], np.asarray(jls.W), **FIT_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_checkpoint_resume_on_sharded_rows_matches_the_uninterrupted_fit(runs, world):
    """Shard 0 alone writes the snapshot, every process reads it, the
    fingerprint joins every shard's probe; a completed fit clears it."""
    _, got = runs
    res = got[world][:-1]
    for r in res:
        assert r["resume"]["done"] == [1, 2]  # resumed at block 5 of 6
        np.testing.assert_allclose(r["resume"]["W"], r["fit"]["W"], **FIT_TOL)
        for w in r["resume"]["gathered"]:
            np.testing.assert_array_equal(w, r["resume"]["W"])
    assert got["snapshots_left"] == []


@pytest.mark.parametrize("world", WORLDS)
def test_host_block_fit_shards_its_slabs_and_matches_jax(runs, world):
    inp, got = runs
    res = got[world][:-1]
    jm = _jax_fit(world, inp["Xh"], inp["Yh"], host=True, num_iter=1)
    for r in res:
        np.testing.assert_allclose(r["host_fit"]["W"], np.asarray(jm.W), **FIT_TOL)
        np.testing.assert_allclose(r["host_fit"]["mu"], np.asarray(jm.feature_mean), **FIT_TOL)
        for w in r["host_fit_gathered"]:
            np.testing.assert_array_equal(w, r["host_fit"]["W"])
    # the fits' sums crossed processes
    assert res[0]["stats"]["all_reduce"][0] >= 3


@pytest.mark.parametrize("world", WORLDS)
def test_block_fit_over_a_multislice_mesh_matches_jax(runs, world):
    import jax
    import jax.numpy as jnp

    from keystone_tpu.ops.learning import BlockLeastSquaresEstimator as JBLS
    from keystone_tpu.parallel import mesh as jmesh
    from keystone_tpu.parallel import runtime as jruntime
    from keystone_tpu.parallel.dataset import Dataset as JDataset

    inp, got = runs
    jms = jruntime.make_multislice_mesh(n_slices=2, devices=jax.devices()[:world])

    def placed(a):
        a = np.concatenate([a, np.zeros((-len(a) % world, a.shape[1]), np.float32)])
        return JDataset.from_array(jax.device_put(jnp.asarray(a), jmesh.data_sharding(jms)),
                                   n=len(inp["X"]))

    with jmesh.use_mesh(jms):
        want = JBLS(8, num_iter=2, lam=0.1).fit(placed(inp["X"]), placed(inp["Y"]))
    for r in got[world][:-1]:
        np.testing.assert_allclose(r["multislice_fit"], np.asarray(want.W), **FIT_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_column_pca_matches_jax(runs, world):
    from keystone_tpu.ops import learning as jlearn
    from keystone_tpu.parallel import mesh as jmesh
    from keystone_tpu.parallel.dataset import Dataset as JDataset

    inp, got = runs
    with jmesh.use_mesh(_jax_mesh(world)):
        want = np.asarray(jlearn.DistributedColumnPCAEstimator(3).fit(
            JDataset.from_items(list(inp["mats"]))).pca_mat)
    res = got[world][:-1]
    for r in res:
        np.testing.assert_allclose(r["column_pca"], want, atol=PCA_TOL)
        np.testing.assert_array_equal(r["column_pca"], res[0]["column_pca"])


# -- runtime.initialize and the launcher ---------------------------------------

CLUSTER_VARS = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR",
                "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "TPU_WORKER_HOSTNAMES", "TPU_PROCESS_ADDRESSES", "MEGASCALE_NUM_SLICES",
                "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "PMI_SIZE", "TORCHELASTIC_RUN_ID")


@pytest.fixture
def fresh_runtime(monkeypatch):
    for v in CLUSTER_VARS:
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setattr(runtime, "_initialized", False)
    yield runtime
    assert not torch.distributed.is_initialized()


def test_initialize_without_a_config_is_a_noop_and_idempotent(fresh_runtime):
    fresh_runtime.initialize(device="cpu")
    fresh_runtime.initialize(device="cpu")
    assert fresh_runtime._initialized and fresh_runtime.process_count() == 1


@pytest.mark.parametrize("env,missing", [
    ({"NUM_PROCESSES": "2"}, "COORDINATOR_ADDRESS"),
    ({"COORDINATOR_ADDRESS": "127.0.0.1:1", "PROCESS_ID": "0"}, "NUM_PROCESSES"),
    ({"RANK": "0", "WORLD_SIZE": "2"}, "MASTER_ADDR"),
])
def test_initialize_names_what_a_partial_config_lacks(fresh_runtime, monkeypatch, env, missing):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=missing):
        fresh_runtime.initialize(device="cpu")


@pytest.mark.parametrize("var,value", [
    ("TPU_WORKER_HOSTNAMES", "host-a,host-b"), ("LOCAL_WORLD_SIZE", "4"), ("SLURM_NTASKS", "2"),
])
def test_initialize_refuses_to_run_alone_in_a_cluster(fresh_runtime, monkeypatch, var, value):
    monkeypatch.setenv(var, value)
    with pytest.raises(RuntimeError, match="refusing to run alone"):
        fresh_runtime.initialize(device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CUDA-less error")
def test_a_cuda_run_without_a_card_raises(fresh_runtime, monkeypatch):
    for k, v in {"COORDINATOR_ADDRESS": "127.0.0.1:1", "NUM_PROCESSES": "2",
                 "PROCESS_ID": "0"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="CUDA"):
        fresh_runtime.initialize()  # None means cuda: NCCL or nothing
    with pytest.raises(RuntimeError, match="CUDA"):
        virtual.launch(_hang, 2, device="cuda")


def _hang(seconds):
    """Rank 1 never enters the collective rank 0 waits in."""
    if runtime.process_index() == 1:
        time.sleep(seconds)
    t = torch.ones(1)
    torch.distributed.all_reduce(t)
    return float(t)


def test_a_collective_that_hangs_fails_within_the_launch_limit():
    t0 = time.monotonic()
    with pytest.raises((TimeoutError, RuntimeError)):
        virtual.launch(_hang, 2, (300,), timeout_s=5, threads=1)
    assert time.monotonic() - t0 < 20


WORKER = r"""
import sys
import numpy as np
import torch
from keystone_tpu_torch.ops.learning.block_ls import BlockLeastSquaresEstimator
from keystone_tpu_torch.parallel import runtime
from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.parallel import mesh as mesh_lib

torch.set_num_threads(1)
runtime.initialize(device="cpu")  # COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID
assert runtime.process_count() == 2
assert mesh_lib.current_mesh().shape == {"data": 2, "model": 1}
N, D, K = 512, 96, 5
rng = np.random.default_rng(0)
Xh = rng.standard_normal((N, D)).astype(np.float32)
Yh = Xh @ rng.standard_normal((D, K)).astype(np.float32)
data = Dataset.from_array(torch.as_tensor(Xh)).shard()
assert data.local().shape[0] == N // 2
model = BlockLeastSquaresEstimator(block_size=D, num_iter=1, lam=0.0).fit(
    data, Dataset.from_array(torch.as_tensor(Yh)))
Wref = np.linalg.lstsq(Xh - Xh.mean(0), Yh - Yh.mean(0), rcond=None)[0]
err = float(np.abs(model.W.numpy() - Wref).max())
assert err < 1e-2, err
assert "jax" not in sys.modules
print("MPOK", runtime.process_index(), err, flush=True)
runtime.shutdown()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_processes_joined_by_the_jax_variables_fit_rows_spanning_both():
    port = _free_port()
    procs = []
    for pid in range(2):
        env = {k: v for k, v in os.environ.items() if k not in CLUSTER_VARS}
        env.update(COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NUM_PROCESSES="2",
                   PROCESS_ID=str(pid),
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen([sys.executable, "-c", WORKER], env=env, cwd=ROOT,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=90)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("the two-process fit passed its 90 s limit")
    finally:
        for p in procs:
            p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "MPOK" in out, f"process {pid}:\n{out}"
