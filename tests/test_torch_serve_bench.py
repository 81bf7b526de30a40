"""``serving/bench.py`` of ``keystone_tpu_torch`` on the CPU, held against
the JAX package's: every row of the JAX module is in the port with JAX's
metric name, unit and ``extra`` key set (read from both sources); the
rows cheap on the CPU print JAX's row (cold_vs_warm, bucketed_throughput
and goodput_mfu side by side with JAX's on the same seeded model, their
seeded fields equal), and the microbatch, gateway, swap, pipeline
overlap and lifecycle rows print the keys of JAX's source; the in-row
checks raise on a forced failure (goodput's efficiency, the flagship
row's missing cost model, the overlap row's 1.2x floor); the featurize
rows' host path runs ``jit_batch`` and their output and H2D checks hold;
the shard row raises on one device; ``serve-bench --help`` offers JAX's
options; and the entry runs ``serve-bench`` (exit 0, rows and the
kernels' launch line), no longer answering exit 2. Small shapes: the
whole file takes about 20 s on one worker."""

import ast
import contextlib
import io
import json
import os

import numpy as np
import pytest

from keystone_tpu.serving import bench as jbench
from keystone_tpu_torch import __main__ as cli
from keystone_tpu_torch.serving import bench as tbench
from keystone_tpu_torch.serving.engine import CompiledPipeline
from keystone_tpu_torch.serving.featurize import (
    build_featurize_pipeline,
    build_flagship_featurize_pipeline,
)
from keystone_tpu_torch.workflow.api import FittedPipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, HIDDEN, DEPTH, BUCKETS = 32, 32, 2, (4, 8)


def _emits(path):
    """metric -> (unit, extra keys, spreads ``**extra``) of every ``emit``
    call in a bench module (the chaos rows name theirs through
    ``_emit_chaos_row``, whose one entry stands for both). JAX's
    ``"skipped"`` stand-in for the cold-start row on a device backend has
    no counterpart: the port runs that row on the card."""
    tree = ast.parse(open(path).read())
    out = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "emit"):
            continue
        metric = node.args[0]
        name = metric.value if isinstance(metric, ast.Constant) else f"<{ast.unparse(metric)}>"
        unit = node.args[2].value
        if unit == "skipped":
            continue
        extra = next((k.value for k in node.keywords if k.arg == "extra"), None)
        keys = frozenset(k.value for k in extra.keys if k is not None) if extra is not None else None
        spread = extra is not None and any(k is None for k in extra.keys)
        assert name not in out, name
        out[name] = (unit, keys, spread)
    return out


JAX_EMITS = _emits(os.path.join(ROOT, "keystone_tpu", "serving", "bench.py"))
PORT_EMITS = _emits(os.path.join(ROOT, "keystone_tpu_torch", "serving", "bench.py"))


def test_every_jax_row_is_ported_with_its_name_unit_and_keys():
    assert set(PORT_EMITS) == set(JAX_EMITS)
    assert len(JAX_EMITS) == 18  # 17 literal metrics and the chaos rows' one emit
    for metric, want in JAX_EMITS.items():
        assert PORT_EMITS[metric] == want, metric
    # every bench_* and run_* function of the JAX module has its port
    names = {n.name for n in ast.parse(open(jbench.__file__).read()).body
             if isinstance(n, ast.FunctionDef)}
    assert {n for n in names if n.startswith(("bench_", "run_", "_run_", "_emit_"))} <= set(dir(tbench))


def _collect():
    rows = []

    def emit(metric, value, unit, vs=None, extra=None):
        row = {"metric": metric, "value": value, "unit": unit, "vs_baseline": vs}
        row.update(extra or {})
        rows.append(row)

    return rows, emit


def _keys_of(metric):
    return {"metric", "value", "unit", "vs_baseline"} | JAX_EMITS[metric][1]


@pytest.fixture(scope="module")
def fitted():
    return (jbench.build_pipeline(D, HIDDEN, DEPTH),
            tbench.build_pipeline(D, HIDDEN, DEPTH, device="cpu"))


# fields of each cheap row that the seeds fix (timings and the
# XLA-compile / graph-capture counts differ by construction)
SEEDED = {
    "bench_cold_vs_warm": ("bucket", "batch"),
    "bench_bucketed_throughput": ("distinct_batch_sizes", "buckets", "padded_rows"),
    "bench_goodput_mfu": ("value", "predicted_efficiency", "goodput_rows", "padded_rows",
                          "distinct_batch_sizes", "buckets", "flops_per_dispatch",
                          "cost_analysis_available", "device_flops_total", "mfu", "roofline"),
}


@pytest.mark.parametrize("row", sorted(SEEDED))
def test_cheap_rows_print_jax_rows(row, fitted):
    jrows, jemit = _collect()
    trows, temit = _collect()
    getattr(jbench, row)(jemit, fitted[0], BUCKETS, D)
    getattr(tbench, row)(temit, fitted[1], BUCKETS, D, device="cpu")
    (want,), (got,) = jrows, trows
    assert got["metric"] == want["metric"] and got["unit"] == want["unit"]
    assert set(got) == set(want) == _keys_of(got["metric"])
    for k in SEEDED[row]:
        assert got[k] == want[k], k


@pytest.mark.parametrize("row", ["bench_microbatch", "bench_gateway", "bench_swap_blip"])
def test_request_plane_rows_print_jax_keys(row, fitted):
    rows, emit = _collect()
    getattr(tbench, row)(emit, fitted[1], BUCKETS, D, n_requests=64, device="cpu")
    (got,) = rows
    assert set(got) == _keys_of(got["metric"])
    assert got["value"] > 0


def test_goodput_efficiency_check_raises(fitted, monkeypatch):
    from keystone_tpu_torch.serving import autoscale

    # a prediction no live counter can meet: the row must refuse
    monkeypatch.setattr(autoscale, "predicted_efficiency", lambda hist, buckets: 1.0)
    rows, emit = _collect()
    with pytest.raises(RuntimeError, match="fell below the padding_waste-model prediction"):
        tbench.bench_goodput_mfu(emit, fitted[1], BUCKETS, D, device="cpu")
    assert rows == []


def test_flagship_row_raises_without_a_cost_model(monkeypatch):
    # an engine that publishes nothing: the fused graph's cost model is
    # missing, and the row says so before it compares any rate
    monkeypatch.setattr(CompiledPipeline, "_set_cost_model", lambda self, bucket, counter: None)
    rows, emit = _collect()
    with pytest.raises(RuntimeError, match="published no cost model"):
        tbench.bench_flagship_featurize(
            emit, img=48, desc_dim=64, vocab=32, hidden=16, depth=2, buckets=(2, 4),
            n_requests=8, n_threads=2, n_check=4, device="cpu",
        )
    assert rows == []


# the overlap row's wait against an 8-row window of a two-layer chain:
# the window computes and delivers in about a millisecond, so nothing
# the serial lane does beyond the wait comes near 20 % of 100 ms (the
# 1.2x floor), however loaded the host; at the row's own 10 ms the
# margin is a couple of milliseconds, which a host busy with other test
# workers can take
NOTHING_TO_HIDE = dict(n_windows=8, prep_latency_ms=100.0)


def _overlap_row(fitted, monkeypatch, cores, **kw):
    # a host of ``cores`` cores: the row asserts its 1.2x floor on >= 2
    monkeypatch.setattr(os, "cpu_count", lambda: cores)
    rows, emit = _collect()
    tbench.bench_pipeline_overlap(emit, fitted[1], BUCKETS, D, device="cpu", **kw)
    return rows


def test_pipeline_overlap_row_prints_jax_keys(fitted, monkeypatch):
    # one core: the floor is not asserted, the overlap efficiency and the
    # bit-identical outputs are
    (got,) = _overlap_row(fitted, monkeypatch, 1)
    assert set(got) == _keys_of("serving_pipeline_overlap")
    assert got["bit_identical"] is True and got["host_cores"] == 1
    assert got["window"] == max(BUCKETS) and got["bottleneck"] == "host_prep"
    assert got["overlap_efficiency"] > 0.8


def test_pipeline_overlap_floor_raises_with_nothing_to_hide(fitted, monkeypatch):
    # the prep wait has nothing to hide behind it, so the pipelined lane
    # cannot reach 1.2x the serial one, and the row refuses (the card's
    # case: a 128-row window of the demo chain replays in about 0.1 ms)
    with pytest.raises(RuntimeError, match="stage overlap buys nothing"):
        _overlap_row(fitted, monkeypatch, 8, **NOTHING_TO_HIDE)


def test_shard_row_raises_on_one_device():
    rows, emit = _collect()
    with pytest.raises(RuntimeError, match="needs >= 2 devices"):
        tbench.bench_sharded_vs_replicated(emit, device="cpu")
    assert rows == []


def _options(main):
    """The option strings of a ``serve-bench`` parser, off its usage."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
    usage = buf.getvalue().split("\n\n")[0]
    return {tok.strip("[]") for tok in usage.split() if tok.strip("[]").startswith("--")}


def test_help_offers_jax_options():
    want = _options(jbench.main)
    assert len(want) == 25
    # and one of the port's own: the overlap row left out (its floor is
    # out of reach on a CUDA card, see bench_pipeline_overlap)
    got = _options(lambda argv: tbench.main(argv, device="cpu"))
    assert got == want | {"--no-pipeline-overlap"}


def test_the_entry_runs_serve_bench():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["serve-bench", "--lifecycle-only", "--no-cache"], device="cpu")
    assert rc == 0
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    (row,) = [r for r in lines if "metric" in r]
    assert row["metric"] == "serving_online_refit" and set(row) == _keys_of(row["metric"])
    assert row["failures"] == 0 and row["rollback_reason"] == "accuracy"
    # the last line: the kernels' launches in the process (none on the CPU)
    assert lines[-1] == {"kernel_launches": {"sift_bin_sample": 0, "plane_sandwich": 0,
                                             "fisher_vector_stats": 0}}
    assert "not ported" not in buf.getvalue()


@pytest.mark.parametrize("row", ["serving_device_featurize", "serving_flagship_featurize"])
def test_featurize_rows_host_path_is_jit_batch(row, monkeypatch):
    """The two featurize rows' host path featurizes each window through
    ``featurize.jit_batch()``, as the JAX rows' does, and their output and
    H2D checks hold through it on the CPU, at the rows' own geometry (the
    rate check compares two paths that both compute on the CPU here; on
    the card it is phase 19's)."""
    made = []
    jit_batch = FittedPipeline.jit_batch

    def spy(self, *a, **k):
        made.append(jit_batch(self, *a, **k))
        return made[-1]

    monkeypatch.setattr(FittedPipeline, "jit_batch", spy)
    if row == "serving_device_featurize":
        img, buckets = 16, (8, 32)
        featurize, feat_d = build_featurize_pipeline(img=img, device="cpu")
    else:
        img, buckets = 48, (2, 4)
        featurize, feat_d = build_flagship_featurize_pipeline(
            img=img, desc_dim=64, vocab=32, device="cpu")
    model = tbench.build_pipeline(d=feat_d, hidden=16, depth=2, device="cpu")
    rng = np.random.default_rng(11)
    check = list(rng.integers(0, 256, (6, img, img, 3), dtype=np.uint8))
    raws = list(rng.integers(0, 256, (8, img, img, 3), dtype=np.uint8))
    host, dev_, maxdiff, _ = tbench._featurize_ab(
        featurize, model, feat_d, img, buckets, raws, check, 2, (row + "-host", row + "-device"),
        tbench.resolve_device("cpu"), 120,
    )
    assert len(made) == 1 and made[0].device.type == "cpu"
    tbench._assert_allclose(host, dev_, row)
    assert maxdiff <= 1e-4
    assert host["bytes_per_row"] / dev_["bytes_per_row"] >= 3.0
    assert host["rate"] > 0 and dev_["rate"] > 0
