"""Serving benchmarks: the tracked serving metrics (counterpart of
``keystone_tpu/serving/bench.py``), and the demo model the gateway serves
without a featurize chain (``_Affine``, ``build_pipeline``,
``affine_head``, ``build_split_pipeline``).

``build_pipeline(d, hidden, depth, seed)`` is a chain of ``depth``
``tanh(x @ W + b)`` nodes whose weights come from
``np.random.default_rng(seed)`` in the JAX package's order, so both
packages serve the same model from one seed.

Each row keeps the JAX row's metric name, unit, headline value, ``extra``
keys and in-row checks with their thresholds, and raises where it raises.
Where a JAX field names an XLA concept the port keeps the key and gives
it what the port measures: ``compiles``/``compile_count`` count CUDA-graph
captures (none on the CPU, where the engine runs eagerly), and
``fv_kernel`` names the CUDA kernel ``ks_fv_stats`` (``"plain"`` below
32 mixtures, where JAX says ``"xla"``). Every row that
builds a model takes ``device=`` (``None`` means ``cuda``).

- ``serving_cold_vs_warm_latency`` — one shape, cold (a fresh engine's
  first dispatch at a padded size: the warm pass, the CUDA-graph capture
  and the checking replay, AOT store detached) vs warm (a replay)
  latency through the engine.
- ``serving_bucketed_throughput`` — examples/sec through a bucketed
  engine fed every batch size 1..max_bucket, with the engine's
  capture/padding counters attached.
- ``serving_microbatch_p99`` — p99 end-to-end request latency of
  concurrent single-example ``submit()``s coalesced by the
  ``MicroBatcher`` under a small deadline.
- ``serving_gateway_p99`` — the same concurrent single-example load
  pushed through the FULL request plane (``keystone_tpu_torch/gateway/``:
  admission -> lane routing -> micro-batch -> engine), read by scraping
  the gateway's ``/metrics`` histogram (``histogram_quantile`` over the
  exported ``le`` buckets), so the regression row IS the series
  operators alert on.
- ``serving_swap_blip`` — p99 latency of requests issued while a forced
  live engine swap runs under steady load (zero failures asserted).
- ``serving_pipeline_overlap`` — sustained lane throughput of a
  PIPELINED ``MicroBatcher`` (host-prep/upload/compute/deliver stages,
  serving/pipeline.py) vs the serial batcher on a workload whose host
  featurize is a non-trivial fraction of window time, with per-stage
  standalone rates, bottleneck attribution and ``overlap_efficiency``
  (one-sided ``>= 0.8`` assert; outputs bit-identical asserted).
- ``serving_goodput_mfu`` — device-truth accounting under mixed-size
  traffic: measured padding efficiency off the live per-bucket goodput
  counters, asserted against the ``padding_waste`` model's prediction
  for the same observed histogram, plus modeled device FLOPs (the
  engine's per-bucket cost model, ``observability/device.CostCounter``),
  the rolling MFU gauge, and each bucket's roofline class where hardware
  peaks are known (the H100's from the table; ``KEYSTONE_PEAK_FLOPS`` /
  ``KEYSTONE_PEAK_MEMBW_GBPS`` elsewhere; without peaks those fields
  report null — never fabricated zeros).
- ``serving_device_featurize`` / ``serving_flagship_featurize``
  (``--featurize``/``--featurize-only``) — the device-side featurization
  A/B on the demo conv chain and on the flagship SIFT+LCS→FV chain: the
  same chain and model served through a ``host_featurize`` gateway
  (features made on the prep stage through ``featurize.jit_batch()``,
  as the JAX rows' host path does, and staged as float32) vs a
  ``device_featurize`` gateway (raw uint8 staged; cast + featurize +
  predict in one CUDA graph per bucket, B1–B3 launching in the flagship
  chain's). Asserted: outputs allclose, device-path H2D bytes ≤ 1/3 of
  the host path's, sustained device-path examples/sec >= host, and (the
  flagship) a cost model for every warmed bucket with MFU and roofline
  present when peaks are known.
- ``serving_sharded_vs_replicated`` (``--shard``/``--shard-only``) — the
  same model served mesh-sharded vs replicated lanes, swept over model
  sizes; needs >= 2 cards (``torch.cuda.device_count()``) and raises
  otherwise, as the JAX row does on fewer than 2 devices.
- ``serving_chaos_lane_kill`` / ``serving_chaos_prep_stall``
  (``--chaos``) — sustained open-loop load through a full gateway while
  a fault point fires mid-window, with the ``loadgen/invariants.py``
  verdict ASSERTED in the row. Headline: the post/pre p99 ratio.
- ``serving_online_refit`` (``--lifecycle``) — refit → shadow → canary →
  promote under load with zero failed requests, then a poisoned refit
  rolled back within one policy tick.
- ``serving_router_failover`` / ``serving_router_trace_overhead``
  (``--fleet``) — the fleet router over two in-process gateway replicas
  with one black-holed mid-run (fleet p99 off the router's federated
  ``/metrics``), and the tracing on/off p99 A/B.
- ``serving_zoo`` / ``serving_attribution_drift`` (``--zoo``,
  ``--attribution``) — two flagship-featurize models through one
  ``ModelZoo`` vs two gateways, and the attribution and drift plane
  through a mid-run size-mixture shift.
- ``serving_cold_start_aot`` — fresh ``serve-gateway`` processes with
  and without a pre-populated AOT store, timed from ``exec()`` to the
  first ``/predict``. The JAX row skips on a device backend, whose chip
  a second process cannot share; CUDA processes share the card, so the
  port runs it there.
- ``serving_autoscale_ramp`` (``--autoscale``) — a step-load ramp through
  a live router + autoscale loop over in-process replicas, with
  ``router.replica.partition`` fired mid-scale-up.

Callable standalone (``python -m keystone_tpu_torch serve-bench``; tests
call ``main(argv, device="cpu")``), which prints one JSON row per metric
and, last, the kernels' launch counts. ``--profile-dir DIR`` wraps the
whole run in a Kineto trace (``utils/profiling.trace``).
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from keystone_tpu_torch._device import resolve_device
from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.workflow.api import Transformer


@dataclasses.dataclass(eq=False)
class _Affine(Transformer):
    """Per-example tanh(x @ W + b)."""

    W: Any
    b: Any

    def apply(self, x):
        return torch.tanh(x @ self.W + self.b)

    def apply_batch(self, ds: Dataset) -> Dataset:
        if not ds.is_array:
            return self._bucketed_batch(ds)
        return Dataset.from_array(self.apply(ds.padded()), n=ds.n)


def _draws(d: int, hidden: int, depth: int, seed: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The (W, b) of every layer, drawn as the JAX package draws them."""
    rng = np.random.default_rng(seed)
    dims = [d] + [hidden] * (depth - 1) + [d]
    return [
        ((rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32)
          / np.sqrt(dims[i])),
         np.zeros(dims[i + 1], np.float32))
        for i in range(depth)
    ]


def _param(a, dev) -> torch.Tensor:
    """A float32 copy of ``a`` (numpy, or a tensor on any device) on ``dev``."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=dev, dtype=torch.float32).clone()
    return torch.tensor(np.asarray(a, np.float32), device=dev)


def affine_chain(layers, device=None):
    """A fitted chain of ``tanh(x @ W + b)`` nodes from ``(W, b)`` pairs
    (numpy, or tensors: a refit's solved head), on ``device`` (``None``
    means ``cuda``)."""
    dev = resolve_device(device)
    pipe = None
    for W, b in layers:
        node = _Affine(_param(W, dev), _param(b, dev))
        pipe = node.to_pipeline() if pipe is None else pipe.and_then(node)
    return pipe.to_pipeline().fit()


def build_pipeline(d: int = 256, hidden: int = 512, depth: int = 4, seed: int = 0,
                   device=None):
    """An estimator-free chain of ``depth`` affine+tanh nodes ->
    FittedPipeline, on ``device`` (``None`` means ``cuda``)."""
    return affine_chain(_draws(d, hidden, depth, seed), device)


def affine_head(W, b, device=None):
    """One ``tanh(x @ W + b)`` node as a standalone FittedPipeline;
    ``base.and_then(affine_head(W, b))`` composes it back onto a base."""
    return affine_chain([(W, b)], device)


def build_split_pipeline(d: int = 256, hidden: int = 512, depth: int = 4, seed: int = 0,
                         device=None):
    """``build_pipeline`` split at the last layer: ``(base, W, b)`` with
    ``base`` the first ``depth - 1`` layers and ``(W, b)`` the last one's
    numpy weights; ``base.and_then(affine_head(W, b))`` is the same model."""
    if depth < 2:
        raise ValueError(f"split needs depth >= 2, got {depth}")
    layers = _draws(d, hidden, depth, seed)
    head_w, head_b = layers[-1]
    return affine_chain(layers[:-1], device), head_w, head_b


# -- shared row plumbing -------------------------------------------------------


def _zeros(d: int) -> np.ndarray:
    return np.zeros((d,), np.float32)


def _clients(submit, inputs, n_threads: int, what: str):
    """``submit(x)`` for every input from ``n_threads`` client threads
    (thread t takes inputs t, t + n_threads, ...); returns (wall seconds,
    results in input order). A shed or timeout FAILS the row instead of
    silently killing its thread: a dead client issues fewer requests,
    which would shrink the seconds and overstate the rate."""
    served = [None] * len(inputs)
    errors = []

    def client(tid):
        try:
            for i in range(tid, len(inputs), n_threads):
                served[i] = submit(inputs[i])
        except Exception as e:
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"{what} client failed: {errors[0]!r}") from errors[0]
    return time.perf_counter() - t0, served


def _gateway_submit(gw, timeout: float):
    # a lane delivers each request's row to the host
    return lambda x: np.asarray(gw.predict(x).result(timeout=timeout))


def _host_hook(featurize, dev):
    """The host path's prep-stage featurizer, as the JAX package's: one
    coalesced window of raw uint8 images through ``featurize.jit_batch()``
    (one CUDA graph per window size, captured at that size's first
    window; eager on the CPU) and returned to the host as float32
    features, which the engine stages."""
    feat_jit = featurize.jit_batch(device=dev)

    def hook(raw):
        batch = np.stack([np.asarray(r, np.uint8) for r in raw])
        return feat_jit(batch).cpu().numpy()

    return hook


# -- the default rows ------------------------------------------------------------


def bench_cold_vs_warm(
    emit, fitted, buckets: Sequence[int], d: int, warm_reps: int = 30, device=None,
) -> None:
    # the cold number must measure a REAL capture, so the AOT store is
    # detached (aot_store=False; it only engages at warmup(), which this
    # row never calls — the explicit False makes the contract
    # load-bearing instead of incidental)
    dev = resolve_device(device)
    engine = fitted.compiled(buckets=buckets, aot_store=False, device=dev)
    rng = np.random.default_rng(1)
    n = max(1, buckets[0] - 1)  # padded path, not the exact bucket size
    x = rng.standard_normal((n, d)).astype(np.float32)
    # one capture on the card (the CPU engine runs eagerly: none)
    captures = 1 if dev.type == "cuda" else 0

    t0 = time.perf_counter()
    engine.apply(x, sync=True)
    cold_ms = (time.perf_counter() - t0) * 1e3
    if engine.metrics.compile_count != captures:
        raise RuntimeError(
            f"cold apply expected exactly {captures} capture(s): "
            + str(engine.metrics.summary())
        )

    warm = []
    for _ in range(warm_reps):
        t0 = time.perf_counter()
        engine.apply(x, sync=True)
        warm.append((time.perf_counter() - t0) * 1e3)
    if engine.metrics.compile_count != captures:
        raise RuntimeError(
            "warm dispatches recaptured: " + str(engine.metrics.summary())
        )
    warm_p50 = float(np.percentile(warm, 50))
    speedup = cold_ms / warm_p50
    emit(
        "serving_cold_vs_warm_latency", cold_ms, "ms",
        extra={
            "warm_p50_ms": round(warm_p50, 3),
            "warm_p99_ms": round(float(np.percentile(warm, 99)), 3),
            "speedup": round(speedup, 1),
            "bucket": engine.bucket_for(n),
            "batch": n,
        },
    )


def bench_bucketed_throughput(
    emit, fitted, buckets: Sequence[int], d: int, passes: int = 3, device=None,
) -> None:
    engine = fitted.compiled(buckets=buckets, device=resolve_device(device))
    rng = np.random.default_rng(2)
    mb = engine.max_bucket
    # every size when small, else a spread hitting every bucket + edges
    if mb <= 32:
        sizes = list(range(1, mb + 1))
    else:
        sizes = sorted(
            set(int(s) for s in rng.integers(1, mb + 1, 24))
            | set(engine.buckets) | {1, mb}
        )
    xs = {n: rng.standard_normal((n, d)).astype(np.float32) for n in sizes}
    engine.warmup(example=_zeros(d))
    served = 0
    t0 = time.perf_counter()
    for _ in range(passes):
        for n, x in xs.items():
            engine.apply(x, sync=True)
            served += n
    dt = time.perf_counter() - t0
    summary = engine.metrics.summary()
    if engine.metrics.compile_count > len(engine.buckets):
        raise RuntimeError(f"recapture bound broken: {summary}")
    emit(
        "serving_bucketed_throughput", served / dt, "examples/sec",
        extra={
            "distinct_batch_sizes": len(xs),
            "compiles": engine.metrics.compile_count,
            "buckets": list(engine.buckets),
            "padded_rows": summary["padded_rows"],
            "dispatch_p50_ms": summary["dispatch_p50_ms"],
            "dispatch_p99_ms": summary["dispatch_p99_ms"],
        },
    )


def bench_microbatch(
    emit, fitted, buckets: Sequence[int], d: int,
    n_requests: int = 256, n_threads: int = 8, max_delay_ms: float = 2.0, device=None,
) -> None:
    from keystone_tpu_torch.serving.batching import MicroBatcher

    engine = fitted.compiled(buckets=buckets, device=resolve_device(device))
    engine.warmup(example=_zeros(d))
    rng = np.random.default_rng(3)
    examples = rng.standard_normal((n_requests, d)).astype(np.float32)
    futures = [None] * n_requests
    t0 = time.perf_counter()
    with MicroBatcher(engine, max_delay_ms=max_delay_ms) as mb:

        def client(tid):
            for i in range(tid, n_requests, n_threads):
                futures[i] = mb.submit(examples[i])

        threads = [threading.Thread(target=client, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for f in futures:
            f.result(timeout=30)
    dt = time.perf_counter() - t0
    m = engine.metrics
    p99 = m.request_latency.p99
    emit(
        "serving_microbatch_p99", (p99 or 0.0) * 1e3, "ms",
        extra={
            "requests": n_requests,
            "client_threads": n_threads,
            "max_delay_ms": max_delay_ms,
            "request_p50_ms": round((m.request_latency.p50 or 0) * 1e3, 3),
            "max_coalesced": m.max_coalesced,
            "dispatches": m.dispatches.total,
            "requests_per_sec": round(n_requests / dt, 1),
        },
    )


def bench_gateway(
    emit, fitted, buckets: Sequence[int], d: int,
    n_requests: int = 256, n_threads: int = 8, n_lanes: int = 2, device=None,
) -> None:
    """``serving_gateway_p99`` — p99 end-to-end latency through the FULL
    request plane (admission queue -> lane routing -> micro-batch ->
    engine) under concurrent load; comparable against the bare
    ``serving_microbatch_p99`` row to price the gateway layer.

    The headline value is read by SCRAPING the gateway's own ``/metrics``
    (``keystone_gateway_request_latency_seconds`` buckets ->
    ``histogram_quantile`` interpolation) rather than bench-local
    stopwatches; the client-side measurement rides along in ``extra``
    for cross-checking bucket-resolution error."""
    import urllib.request

    from keystone_tpu_torch.gateway import Gateway, GatewayServer
    from keystone_tpu_torch.gateway.admission import Overloaded
    from keystone_tpu_torch.observability.prometheus import (
        histogram_buckets,
        quantile_from_buckets,
    )

    rng = np.random.default_rng(4)
    examples = rng.standard_normal((n_requests, d)).astype(np.float32)
    with Gateway(
        fitted, buckets=buckets, n_lanes=n_lanes, max_delay_ms=2.0,
        warmup_example=_zeros(d), name="bench-gateway", device=resolve_device(device),
    ) as gw:
        # each client thread times its own requests SYNCHRONOUSLY
        # (submit -> result), and a shed predict is counted instead of
        # crashing the bench
        latencies = []
        lock = threading.Lock()
        t0 = time.perf_counter()

        def client(tid):
            for i in range(tid, n_requests, n_threads):
                t = time.perf_counter()
                try:
                    gw.predict(examples[i]).result(timeout=60)
                except Overloaded:
                    continue  # shows up in the shed counter
                with lock:
                    latencies.append(time.perf_counter() - t)

        threads = [threading.Thread(target=client, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.perf_counter() - t0
        m = gw.metrics
        if not latencies:
            raise RuntimeError(
                "gateway bench: every request was shed; summary="
                + str(m.registry.varz().get("keystone_gateway_shed_total"))
            )
        # the regression number comes off the wire: scrape /metrics
        # exactly like an operator's Prometheus would
        with GatewayServer(gw, port=0, registry=m.registry) as srv:
            with urllib.request.urlopen(srv.url("/metrics"), timeout=15) as resp:
                exposition = resp.read().decode("utf-8")
        buckets_scraped = histogram_buckets(
            exposition, "keystone_gateway_request_latency_seconds", {"gateway": gw.name},
        )
        p99_s = quantile_from_buckets(0.99, buckets_scraped)
        if p99_s is None:
            raise RuntimeError(
                "gateway bench: /metrics had no latency buckets:\n" + exposition
            )
        emit(
            "serving_gateway_p99", p99_s * 1e3, "ms",
            extra={
                "source": "scraped /metrics histogram_quantile",
                "requests": n_requests,
                "served": len(latencies),
                "client_threads": n_threads,
                "lanes": n_lanes,
                "client_p99_ms": round(float(np.percentile(latencies, 99)) * 1e3, 3),
                "p50_ms": round((quantile_from_buckets(0.5, buckets_scraped) or 0) * 1e3, 3),
                "requests_per_sec": round(len(latencies) / dt, 1),
                "shed": int(m.outcome_count("shed")),
                "errors": int(m.outcome_count("error")),
                "retries": int(m.retry_count()),
            },
        )


def bench_swap_blip(
    emit, fitted, buckets: Sequence[int], d: int,
    n_requests: int = 256, n_threads: int = 4, device=None,
) -> None:
    """``serving_swap_blip`` — p99 latency of requests issued WHILE a
    forced live engine swap (build + capture + atomic re-point + drain)
    runs under steady load, with the zero-failure requirement asserted."""
    from keystone_tpu_torch.gateway import Gateway

    rng = np.random.default_rng(5)
    examples = rng.standard_normal((n_requests, d)).astype(np.float32)
    with Gateway(
        fitted, buckets=buckets, n_lanes=2, max_delay_ms=2.0,
        warmup_example=_zeros(d), name="bench-swap", device=resolve_device(device),
    ) as gw:
        latencies = [0.0] * n_requests
        failures = [0]

        def client(tid):
            for i in range(tid, n_requests, n_threads):
                t = time.perf_counter()
                try:
                    gw.predict(examples[i]).result(timeout=60)
                except Exception:
                    failures[0] += 1
                latencies[i] = time.perf_counter() - t

        threads = [threading.Thread(target=client, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        gw.rebucket(force=True)  # the live swap, mid-load
        swap_s = time.perf_counter() - t0
        for t in threads:
            t.join()
        if failures[0] != 0:
            raise RuntimeError(f"{failures[0]} requests failed across the live swap")
        emit(
            "serving_swap_blip", float(np.percentile(latencies, 99)) * 1e3, "ms",
            extra={
                "requests": n_requests,
                "p50_ms": round(float(np.percentile(latencies, 50)) * 1e3, 3),
                "swap_wall_ms": round(swap_s * 1e3, 1),
                "swaps": int(gw.metrics.swap_count()),
                "failures": failures[0],
                "buckets_after": list(gw.buckets),
            },
        )


def bench_pipeline_overlap(
    emit, fitted, buckets: Sequence[int], d: int,
    n_windows: int = 32, prep_latency_ms: float = 10.0, pipeline_depth: int = 2,
    device=None,
) -> None:
    """``serving_pipeline_overlap`` — the same items-mode workload
    through a SERIAL lane and a PIPELINED lane. The host featurize models
    a LATENCY-bound front-end (a tokenizer RPC / feature-store fetch with
    a fixed per-window service time plus light host assembly). Serial
    pays prep + upload + compute + deliver per window end-to-end; the
    staged pipeline runs window k+1's prep wait under window k's device
    compute, so sustained throughput approaches the bottleneck stage's
    standalone rate instead of the stages' sum.

    Per-stage standalone rates (1 / mean busy seconds, off the lane's own
    ``ServingMetrics``), min-rate ``bottleneck`` attribution, and
    ``overlap_efficiency`` = sustained window rate / bottleneck rate,
    asserted one-sided ``>= 0.8``. On hosts with >= 2 cores the row also
    asserts pipelined sustained >= 1.2x serial. Outputs are asserted
    BIT-identical between the two modes.

    On an H100 the floor is out of reach: the pipelined lane can hide
    only the serial lane's work beyond the prep (the upload, a replay of
    about 0.5 ms and the delivery: R of about 1.4 ms a window) behind the
    prep itself (the 10 ms wait and the assembly: P of about 11.9 ms), so
    it runs at most 1 + R/P, about 1.12x, of the serial lane there.
    ``serve-bench --no-pipeline-overlap`` leaves the row out."""
    import os

    from keystone_tpu_torch.serving.batching import MicroBatcher

    dev = resolve_device(device)
    window = max(buckets)
    rng = np.random.default_rng(6)
    scale = np.linspace(0.5, 1.5, d).astype(np.float32)
    items = rng.standard_normal((n_windows * window, d)).astype(np.float32)

    def featurize(raw):
        # items-mode front-end: fixed service latency (sleeps release the
        # GIL, like a real socket wait) + light host assembly
        time.sleep(prep_latency_ms / 1e3)
        return np.stack([np.asarray(r, np.float32) for r in raw]) * scale

    def drive(depth):
        engine = fitted.compiled(buckets=buckets, device=dev)
        engine.warmup(example=_zeros(d))
        with MicroBatcher(
            engine, max_delay_ms=200.0, max_batch=window,
            pipeline_depth=depth, host_featurize=featurize,
        ) as mb:
            # one unmeasured window warms the paths + pool buffers
            warm = rng.standard_normal((window, d)).astype(np.float32)
            for f in [mb.submit(x) for x in warm]:
                f.result(timeout=120)
            # best-of-2 sustained passes
            dt = float("inf")
            for _ in range(2):
                t0 = time.perf_counter()
                futures = [mb.submit(x) for x in items]
                rows = [np.asarray(f.result(timeout=300)) for f in futures]
                dt = min(dt, time.perf_counter() - t0)
        return engine, dt, rows

    serial_engine, serial_dt, serial_rows = drive(0)
    piped_engine, piped_dt, piped_rows = drive(pipeline_depth)

    for i, (a, b) in enumerate(zip(serial_rows, piped_rows)):
        if not np.array_equal(a, b):
            raise RuntimeError(f"row {i}: pipelined output differs from serial")

    m = piped_engine.metrics
    stage_rates = m.stage_rates()
    bottleneck = min(stage_rates, key=stage_rates.get)
    sustained = n_windows / piped_dt  # windows/sec, bench-timed
    serial_rate = n_windows / serial_dt
    efficiency = sustained / stage_rates[bottleneck]
    speedup = sustained / serial_rate
    cores = os.cpu_count() or 1
    if efficiency <= 0.8:
        raise RuntimeError(
            f"pipelined lane sustains {sustained:.1f} windows/s but "
            f"the bottleneck stage ({bottleneck}) alone does "
            f"{stage_rates[bottleneck]:.1f} — overlap is broken "
            f"(efficiency {efficiency:.2f} <= 0.8; stages: "
            + ", ".join(f"{s} {r:.1f}/s" for s, r in sorted(stage_rates.items())) + ")"
        )
    if cores >= 2 and speedup < 1.2:
        raise RuntimeError(
            f"pipelined lane is only {speedup:.2f}x the serial batcher "
            f"({sustained:.1f} vs {serial_rate:.1f} windows/s) on a "
            f"{cores}-core host — stage overlap buys nothing"
        )
    report = m.pipeline_report()
    emit(
        "serving_pipeline_overlap", sustained * window, "examples/sec",
        extra={
            "windows": n_windows,
            "window": window,
            "pipeline_depth": pipeline_depth,
            "host_cores": cores,
            "sustained_windows_per_sec": round(sustained, 2),
            "serial_windows_per_sec": round(serial_rate, 2),
            "speedup_vs_serial": round(speedup, 2),
            "stage_rates_per_sec": {s: round(r, 1) for s, r in sorted(stage_rates.items())},
            "bottleneck": bottleneck,
            "overlap_efficiency": round(efficiency, 3),
            "host_prep_mean_ms": report["stages"]["host_prep"]["mean_ms"],
            "compute_mean_ms": report["stages"]["compute"]["mean_ms"],
            "bit_identical": True,
        },
    )


def bench_goodput_mfu(
    emit, fitted, buckets: Sequence[int], d: int, passes: int = 2, device=None,
) -> None:
    """``serving_goodput_mfu`` — drive a mixed-size sweep and read the
    device-truth plane back: measured padding efficiency (live per-bucket
    goodput/padded counters), modeled FLOPs + rolling MFU, and the
    roofline class per bucket. The acceptance assert is measured
    efficiency >= the ``padding_waste``-model prediction for the same
    observed histogram minus tolerance."""
    from keystone_tpu_torch.serving.autoscale import predicted_efficiency

    engine = fitted.compiled(buckets=buckets, device=resolve_device(device))
    engine.warmup(example=_zeros(d))
    rng = np.random.default_rng(7)
    mb = engine.max_bucket
    sizes = sorted(set(int(s) for s in rng.integers(1, mb + 1, 16)) | {1, mb})
    xs = {n: rng.standard_normal((n, d)).astype(np.float32) for n in sizes}
    for _ in range(passes):
        for x in xs.values():
            engine.apply(x, sync=True)
    m = engine.metrics
    measured = m.padding_efficiency()
    predicted = predicted_efficiency(m.request_sizes.snapshot(), engine.buckets)
    if measured is None:
        raise RuntimeError("no dispatches recorded")
    if predicted is None:
        raise RuntimeError("no request-size histogram")
    if measured < predicted - 0.02:
        raise RuntimeError(
            f"measured padding efficiency {measured:.4f} fell below "
            f"the padding_waste-model prediction {predicted:.4f} — the "
            f"live goodput counters and the offline model disagree"
        )
    mfu = m.mfu()
    cost_model_buckets = sorted(m.cost_models)
    emit(
        "serving_goodput_mfu", measured, "padding_efficiency",
        extra={
            "predicted_efficiency": round(predicted, 4),
            "goodput_rows": m.examples.total,
            "padded_rows": m.padded_rows.total,
            "distinct_batch_sizes": len(xs),
            "buckets": list(engine.buckets),
            "device_flops_total": m.device_flops.total,
            "flops_per_dispatch": {
                str(b): m.cost_models[b].get("flops") for b in cost_model_buckets
            },
            "mfu": round(mfu, 8) if mfu is not None else None,
            "roofline": {str(b): m.roofline_bound(b) for b in engine.buckets},
            "cost_analysis_available": bool(cost_model_buckets),
        },
    )


# -- the featurize rows ------------------------------------------------------------


def _featurize_ab(featurize, model, feat_d, img, buckets, raws, check, n_threads,
                  names, dev, timeout):
    """The host-vs-device featurize A/B the two featurize rows share:
    ``host`` and ``device`` dicts of outputs on ``check``, sustained
    rate on ``raws`` (one unmeasured half pass, best of 2; both re-run
    once when the device path trails), H2D bytes per request and per
    staged row, bottleneck and captures; and the device engine."""
    from keystone_tpu_torch.gateway import Gateway

    def measure(gw, inputs):
        submit = _gateway_submit(gw, timeout)
        _clients(submit, inputs[: len(inputs) // 2], n_threads, gw.name)
        dt = float("inf")
        for _ in range(2):
            dt = min(dt, _clients(submit, inputs, n_threads, gw.name)[0])
        return len(inputs) / dt

    gw_host = Gateway(
        model, buckets=buckets, n_lanes=1, max_delay_ms=2.0,
        host_featurize=_host_hook(featurize, dev), warmup_example=_zeros(feat_d),
        name=names[0], device=dev,
    )
    gw_dev = Gateway(
        model, buckets=buckets, n_lanes=1, max_delay_ms=2.0,
        device_featurize=featurize,
        warmup_example=np.zeros((img, img, 3), np.uint8),
        name=names[1], device=dev,
    )
    try:
        host = {"outputs": _clients(_gateway_submit(gw_host, timeout), check, n_threads,
                                    gw_host.name)[1]}
        dev_ = {"outputs": _clients(_gateway_submit(gw_dev, timeout), check, n_threads,
                                    gw_dev.name)[1]}
        host["rate"] = measure(gw_host, raws)
        dev_["rate"] = measure(gw_dev, raws)
        if dev_["rate"] < host["rate"]:
            # one bounded re-measure of BOTH paths; best of all observed
            # passes per path, then the assert is final
            host["rate"] = max(host["rate"], measure(gw_host, raws))
            dev_["rate"] = max(dev_["rate"], measure(gw_dev, raws))
        for side, gw in ((host, gw_host), (dev_, gw_dev)):
            m = gw.pool.lanes[0].engine.metrics
            report = m.pipeline_report() or {}
            side["bytes_per_request"] = m.h2d_bytes.total / m.examples.total
            # padding-independent wire cost: every dispatch stages exactly
            # bucket * bytes-per-row
            side["bytes_per_row"] = m.h2d_bytes.total / sum(
                b * n for b, n in m.dispatches.snapshot().items()
            )
            side["bottleneck"] = report.get("bottleneck")
            side["compiles"] = m.compiles.total
        engine = gw_dev.pool.lanes[0].engine
    finally:
        gw_host.close()
        gw_dev.close()
    maxdiff = max(float(np.abs(a - b).max()) for a, b in zip(host["outputs"], dev_["outputs"]))
    return host, dev_, maxdiff, engine


def _assert_allclose(host, dev_, what):
    for i, (a, b) in enumerate(zip(host["outputs"], dev_["outputs"])):
        if not np.allclose(a, b, rtol=1e-4, atol=1e-5):
            raise RuntimeError(
                f"{what} output {i} diverges from the host "
                f"featurize path (max abs diff {np.abs(a - b).max():.3e})"
            )


def bench_device_featurize(
    emit,
    img: int = 16,
    hidden: int = 256,
    depth: int = 3,
    buckets: Sequence[int] = (8, 32),
    n_requests: int = 384,
    n_threads: int = 8,
    n_check: int = 32,
    min_h2d_reduction: float = 3.0,
    device=None,
) -> None:
    """``serving_device_featurize`` — the device-side featurization A/B:
    the SAME featurize chain (``build_featurize_pipeline``) and model
    served two ways through full gateways —

    - **host path**: the ``host_featurize`` seam — the prep stage
      featurizes each coalesced window through ``featurize.jit_batch()``
      and the engine stages the resulting float32 features;
    - **device path**: ``device_featurize`` — raw uint8 images stage
      into the pooled staging buffers, and cast + featurize + predict
      ride ONE CUDA graph per bucket.

    Asserted (raises, not asserts): outputs allclose, H2D bytes/request
    on the device path ≤ 1/3 of the host path (off the engines' own
    ``keystone_serving_h2d_bytes_total`` counters, padding included),
    sustained device-path examples/sec >= the host path (one bounded
    re-measure of both), and the device lane not bottlenecked on host
    prep or upload. Headline: device-path examples/sec."""
    from keystone_tpu_torch.serving.featurize import build_featurize_pipeline

    dev = resolve_device(device)
    featurize, feat_d = build_featurize_pipeline(img=img, device=dev)
    model = build_pipeline(d=feat_d, hidden=hidden, depth=depth, device=dev)
    rng = np.random.default_rng(11)
    check = list(rng.integers(0, 256, (n_check, img, img, 3), dtype=np.uint8))
    raws = list(rng.integers(0, 256, (n_requests, img, img, 3), dtype=np.uint8))
    host, dev_, maxdiff, _ = _featurize_ab(
        featurize, model, feat_d, img, buckets, raws, check, n_threads,
        ("bench-feat-host", "bench-feat-device"), dev, 120,
    )
    _assert_allclose(host, dev_, "device-featurize")
    reduction = host["bytes_per_request"] / dev_["bytes_per_request"]
    if reduction < min_h2d_reduction:
        raise RuntimeError(
            f"device path ships {dev_['bytes_per_request']:.0f} "
            f"H2D bytes/request vs the host path's "
            f"{host['bytes_per_request']:.0f} — only "
            f"{reduction:.2f}x fewer (need >= {min_h2d_reduction}x)"
        )
    if dev_["rate"] < host["rate"]:
        raise RuntimeError(
            f"device-featurize path sustains {dev_['rate']:.1f} ex/s "
            f"vs the host path's {host['rate']:.1f} — raw-on-the-wire "
            "must at least match the host featurize seam"
        )
    if dev_["bottleneck"] in ("host_prep", "upload"):
        raise RuntimeError(
            f"device-featurize lane still bottlenecks on "
            f"{dev_['bottleneck']} — the fused graph was supposed to "
            "move the limiting stage off host prep/H2D"
        )
    emit(
        "serving_device_featurize", dev_["rate"], "examples/sec",
        extra={
            "host_examples_per_sec": round(host["rate"], 1),
            "device_examples_per_sec": round(dev_["rate"], 1),
            "speedup_vs_host": round(dev_["rate"] / host["rate"], 3),
            "h2d_bytes_per_request_host": round(host["bytes_per_request"], 1),
            "h2d_bytes_per_request_device": round(dev_["bytes_per_request"], 1),
            "h2d_reduction": round(reduction, 2),
            "raw_shape": [img, img, 3],
            "feature_dim": feat_d,
            "buckets": list(buckets),
            "requests": n_requests,
            "client_threads": n_threads,
            "host_bottleneck": host["bottleneck"],
            "device_bottleneck": dev_["bottleneck"],
            "host_compiles": host["compiles"],
            "device_compiles": dev_["compiles"],
            "outputs_allclose": True,
            "max_abs_diff": maxdiff,
        },
    )


def bench_flagship_featurize(
    emit,
    img: int = 48,
    desc_dim: int = 64,
    vocab: int = 32,
    hidden: int = 256,
    depth: int = 3,
    buckets: Sequence[int] = (8, 32),
    n_requests: int = 192,
    n_threads: int = 8,
    n_check: int = 16,
    min_h2d_reduction: float = 3.0,
    device=None,
) -> None:
    """``serving_flagship_featurize`` — the device-featurize A/B on the
    paper's FLAGSHIP chain (``build_flagship_featurize_pipeline``): the
    branched SIFT+LCS → PCA → GMM Fisher Vector → Hellinger/L2 DAG, with
    the hot loops as the CUDA kernels B1 (``sift_bin_sample``), B2
    (``plane_sandwich``) and B3 (``fisher_vector_stats``, ``ks_fv_stats``),
    served two ways through full gateways:

    - **host path**: ``host_featurize`` runs the flagship batch
      featurize (``jit_batch``) per coalesced window and ships the
      ``(4·desc_dim·vocab,)`` float32 features;
    - **device path**: raw ``(img, img, 3)`` uint8 on the wire; cast +
      both branches + combine + predict ride ONE CUDA graph per bucket.

    Asserted (raises, not asserts): fused outputs allclose to the host
    path (rtol=1e-4/atol=1e-5); H2D bytes/row ≤ 1/3 of the host path off
    the engines' own counters (this row's geometry: 48²·3 raw uint8 =
    6912 B vs 8192 float32 features = 32 KiB, ~4.7× geometric; at 256²
    a raw row is larger than the features and the check fails by
    geometry); the device-truth series for the fused graph are PRESENT
    — every warmed bucket published a cost model, and when the hardware
    peaks are known (the H100's from the table) the rolling MFU and
    per-bucket roofline class are non-None; and sustained fused ex/s >=
    host (one bounded re-measure absorbs jitter). The structure checks
    come before the rate check. Headline: fused-path examples/sec."""
    from keystone_tpu_torch.ops.images.fisher_vector import FUSED_MIN_K
    from keystone_tpu_torch.serving.featurize import build_flagship_featurize_pipeline

    dev = resolve_device(device)
    featurize, feat_d = build_flagship_featurize_pipeline(
        img=img, desc_dim=desc_dim, vocab=vocab, device=dev
    )
    model = build_pipeline(d=feat_d, hidden=hidden, depth=depth, device=dev)
    rng = np.random.default_rng(13)
    check = list(rng.integers(0, 256, (n_check, img, img, 3), dtype=np.uint8))
    raws = list(rng.integers(0, 256, (n_requests, img, img, 3), dtype=np.uint8))
    host, dev_, maxdiff, engine = _featurize_ab(
        featurize, model, feat_d, img, buckets, raws, check, n_threads,
        ("bench-flagship-host", "bench-flagship-device"), dev, 300,
    )
    m_dev = engine.metrics
    cost_model_buckets = sorted(m_dev.cost_models)
    # whole-run window: the row's sustained passes all count
    mfu = m_dev.mfu(window=1e9)
    roofline = {str(b): m_dev.roofline_bound(b) for b in engine.buckets}
    peaks_known = bool(m_dev._peak_flops and m_dev._peak_membw)
    _assert_allclose(host, dev_, "flagship fused")
    # gate on the per-ROW footprint: per-request bytes fold in window
    # fill, a batching/arrival property
    reduction = host["bytes_per_row"] / dev_["bytes_per_row"]
    if reduction < min_h2d_reduction:
        raise RuntimeError(
            f"flagship device path stages {dev_['bytes_per_row']:.0f} "
            f"H2D bytes/bucket-row vs the host path's "
            f"{host['bytes_per_row']:.0f} — only "
            f"{reduction:.2f}x fewer (need >= {min_h2d_reduction}x)"
        )
    # MFU/roofline presence for the fused graph: cost models come from
    # the warm pass's count and must exist on every device; the derived
    # MFU/roofline additionally need known hardware peaks
    if not cost_model_buckets:
        raise RuntimeError(
            "the fused flagship graph published no cost model "
            "for any bucket — MFU/roofline series cannot exist"
        )
    if peaks_known and (mfu is None or any(v is None for v in roofline.values())):
        raise RuntimeError(
            f"device peaks are known but the derived series are "
            f"absent (mfu={mfu}, roofline={roofline}) — the fused "
            "graph's MFU/roofline must be present"
        )
    if dev_["rate"] < host["rate"]:
        raise RuntimeError(
            f"flagship fused path sustains {dev_['rate']:.1f} ex/s vs "
            f"the host path's {host['rate']:.1f} — raw-on-the-wire "
            "must at least match the host featurize seam"
        )
    emit(
        "serving_flagship_featurize", dev_["rate"], "examples/sec",
        extra={
            "host_examples_per_sec": round(host["rate"], 1),
            "device_examples_per_sec": round(dev_["rate"], 1),
            "speedup_vs_host": round(dev_["rate"] / host["rate"], 3),
            "h2d_bytes_per_request_host": round(host["bytes_per_request"], 1),
            "h2d_bytes_per_request_device": round(dev_["bytes_per_request"], 1),
            "h2d_bytes_per_row_host": round(host["bytes_per_row"], 1),
            "h2d_bytes_per_row_device": round(dev_["bytes_per_row"], 1),
            "h2d_reduction": round(reduction, 2),
            "raw_shape": [img, img, 3],
            "feature_dim": feat_d,
            "desc_dim": desc_dim,
            "vocab": vocab,
            # B3, the CUDA kernel, from FUSED_MIN_K mixtures on; plain
            # PyTorch products below
            "fv_kernel": "ks_fv_stats" if vocab >= FUSED_MIN_K else "plain",
            "buckets": list(buckets),
            "requests": n_requests,
            "client_threads": n_threads,
            "host_bottleneck": host["bottleneck"],
            "device_bottleneck": dev_["bottleneck"],
            "host_compiles": host["compiles"],
            "device_compiles": dev_["compiles"],
            "outputs_allclose": True,
            "max_abs_diff": maxdiff,
            "cost_model_buckets": cost_model_buckets,
            "mfu": round(mfu, 8) if mfu is not None else None,
            "roofline": roofline,
            "peaks_known": peaks_known,
        },
    )


# -- the chaos and lifecycle rows ----------------------------------------------------


def _run_chaos_experiment(
    fitted, buckets, d, *, fault_spec, rate, n_requests,
    fault_at_s, fault_for_s, settle_s, pipeline_depth=2,
    max_shed_rate=0.9, name="bench-chaos", device=None,
):
    """One chaos experiment over a full gateway: open-loop synthetic
    load, the fault armed mid-run, verdict from the invariant checker.
    Returns (verdict, injections)."""
    from keystone_tpu_torch.gateway import Gateway
    from keystone_tpu_torch.loadgen import faults, synthesize
    from keystone_tpu_torch.loadgen.invariants import InvariantChecker
    from keystone_tpu_torch.loadgen.runner import FaultPlan, InprocTarget, LoadGenerator

    point = fault_spec["point"]
    fired_before = faults.get_injector().fired_count(point)
    events = synthesize(n_requests, arrivals="poisson", rate=rate, shape=(d,), seed=11)
    with Gateway(
        fitted, buckets=buckets, n_lanes=2, max_delay_ms=2.0,
        pipeline_depth=pipeline_depth, warmup_example=_zeros(d), name=name,
        device=resolve_device(device),
    ) as gw:
        gen = LoadGenerator(InprocTarget(gw, default_shape=(d,)))
        report = gen.run(
            events,
            faults=[FaultPlan(spec=fault_spec, at_s=fault_at_s, for_s=fault_for_s)],
            settle_s=settle_s,
            recovery_probe_s=10.0,
        )
    verdict = InvariantChecker(
        p99_factor=1.5, recovery_within_s=10.0, max_shed_rate=max_shed_rate,
    ).check(report)
    injections = faults.get_injector().fired_count(point) - fired_before
    return verdict, injections


def _emit_chaos_row(emit, metric, verdict, injections, extra):
    # explicit raises, not asserts: a `python -O` run must not strip the
    # row's whole reason for existing and emit "green" unchecked
    if injections <= 0:
        raise RuntimeError(f"{metric}: the fault point never fired — the experiment proved nothing")
    if not verdict.passed:
        raise RuntimeError(f"{metric}: serving invariants violated under chaos:\n" + verdict.to_json())
    stats = verdict.stats
    pre = stats.get("pre_fault_p99_ms")
    # headline = recovered steady-state over pre-fault (the whole
    # post-window p99 rides in extra)
    post = stats.get("recovered_p99_ms")
    if post is None:
        post = stats.get("post_fault_p99_ms")
    ratio = round(post / pre, 3) if pre and post is not None else None
    emit(
        metric, ratio, "p99_post_over_pre",
        extra={
            "verdict": "green" if verdict.passed else "red",
            "invariants": [r.name for r in verdict.invariants],
            "injections": injections,
            "requests": stats["issued"],
            "resolved": stats["resolved"],
            "untyped_failures": stats["untyped_failures"],
            "lost": stats["lost"],
            "shed_rate": stats["shed_rate"],
            "pre_fault_p99_ms": pre,
            "during_fault_p99_ms": stats.get("during_fault_p99_ms"),
            "post_fault_p99_ms": stats.get("post_fault_p99_ms"),
            "recovered_p99_ms": stats.get("recovered_p99_ms"),
            "p99_recovery_s": stats.get("p99_recovery_s"),
            "ready_recovery_s": (
                round(stats["ready_recovery_s"], 2)
                if stats.get("ready_recovery_s") is not None else None
            ),
            **extra,
        },
    )


def bench_chaos_lane_kill(
    emit, fitted, buckets: Sequence[int], d: int,
    n_requests: int = 256, rate: float = 50.0, device=None,
) -> None:
    """``serving_chaos_lane_kill`` — sustained open-loop load with one
    lane KILLED mid-window (``gateway.lane.kill`` matched to lane 0 for
    1.5 s): the pool's retry + health charging must absorb every
    injected failure. Asserted: zero untyped failures, every admitted
    request resolves, readiness holds, p99 recovers to within 1.5x
    pre-fault within 10 s of the fault clearing."""
    verdict, injections = _run_chaos_experiment(
        fitted, buckets, d,
        fault_spec={"point": "gateway.lane.kill", "match": {"lane": 0}},
        rate=rate, n_requests=n_requests,
        fault_at_s=1.5, fault_for_s=1.5, settle_s=2.0,
        name="bench-chaos-kill", device=device,
    )
    _emit_chaos_row(
        emit, "serving_chaos_lane_kill", verdict, injections,
        {"fault": "gateway.lane.kill lane=0 for 1.5s"},
    )


def bench_chaos_prep_stall(
    emit, fitted, buckets: Sequence[int], d: int,
    n_requests: int = 256, rate: float = 50.0, stall_ms: float = 40.0, device=None,
) -> None:
    """``serving_chaos_prep_stall`` — the pipelined lanes' host-prep stage
    stalled ``stall_ms`` per window for 1.5 s mid-run
    (``pipeline.host_prep.stall``): latency degrades and backpressure may
    shed (typed!), but nothing is lost, nothing 500s, and the tail
    recovers once the stall clears."""
    verdict, injections = _run_chaos_experiment(
        fitted, buckets, d,
        fault_spec={"point": "pipeline.host_prep.stall", "delay_ms": stall_ms},
        rate=rate, n_requests=n_requests,
        fault_at_s=1.5, fault_for_s=1.5, settle_s=2.0,
        name="bench-chaos-stall", device=device,
    )
    _emit_chaos_row(
        emit, "serving_chaos_prep_stall", verdict, injections,
        {"fault": f"pipeline.host_prep.stall {stall_ms}ms for 1.5s"},
    )


def bench_online_refit(
    emit,
    d: int = 24,
    hidden: int = 32,
    depth: int = 3,
    buckets: Sequence[int] = (4, 16),
    n_threads: int = 4,
    max_ticks: int = 60,
    device=None,
) -> None:
    """``serving_online_refit`` — the full online-lifecycle loop, both
    directions, under open-loop load:

    1. PROMOTION: the gateway serves a STALE head (the teacher's final
       layer was redrawn); labeled feedback streams in; the controller
       solves a candidate and walks it shadow → canary → promoted
       (atomic engine swap) while client threads hammer predict.
       Asserted: ZERO failed requests across the whole rollout, the
       candidate's held-out error BEATS the stale incumbent's, and the
       promoted model now serves.
    2. ROLLBACK: ``lifecycle.refit.poison`` is armed, so the next
       feedback window folds garbage into the normal equations; the
       solved candidate must be caught by the held-out accuracy gate and
       auto-rolled back within ONE policy tick of entering shadow.

    The emitted value is the p99 client latency across phase 1."""
    from keystone_tpu_torch.gateway import Gateway
    from keystone_tpu_torch.lifecycle.controller import LifecycleController
    from keystone_tpu_torch.lifecycle.policy import PromotionConfig
    from keystone_tpu_torch.lifecycle.teacher import teacher_labels
    from keystone_tpu_torch.loadgen import faults

    dev = resolve_device(device)
    head_seed = 77  # the teacher the refit must catch up to
    base, head_w, head_b = build_split_pipeline(d=d, hidden=hidden, depth=depth, seed=0,
                                                device=dev)

    def head_builder(W, b):
        return affine_head(W, b, device=dev)

    stale = base.and_then(head_builder(head_w, head_b))
    rng = np.random.default_rng(11)
    examples = rng.standard_normal((256, d)).astype(np.float32)

    def labeled(n):
        xs = rng.standard_normal((n, d)).astype(np.float32)
        return xs, teacher_labels(xs, d, hidden, depth, seed=0, head_seed=head_seed)

    with Gateway(
        stale, buckets=buckets, n_lanes=2, max_delay_ms=2.0,
        warmup_example=_zeros(d), name="bench-lifecycle", device=dev,
    ) as gw:
        ctrl = LifecycleController(
            gw, base=base, head_builder=head_builder,
            feature_dim=hidden, out_dim=d, name="bench",
            config=PromotionConfig(
                min_shadow_pairs=8, min_canary_requests=8,
                promote_after_healthy_ticks=1,
            ),
            canary_fraction=0.25, min_refit_samples=128,
            interval_s=None, refit_chunk=32,
        )
        stop = threading.Event()
        lat: list = [[] for _ in range(n_threads)]
        fails = [0] * n_threads

        def client(tid):
            i = tid
            while not stop.is_set():
                t = time.perf_counter()
                try:
                    gw.predict(examples[i % len(examples)]).result(timeout=60)
                except Exception:
                    fails[tid] += 1
                lat[tid].append(time.perf_counter() - t)
                i += n_threads

        threads = [threading.Thread(target=client, args=(t,), daemon=True)
                   for t in range(n_threads)]
        try:
            # -- phase 1: promotion under load
            ctrl.add_feedback(*labeled(384))
            for t in threads:
                t.start()
            t0 = time.perf_counter()
            ticks = 0
            status = ctrl.status()
            while status["state"] != "promoted" and ticks < max_ticks:
                status = ctrl.tick()
                ticks += 1
                time.sleep(0.05)  # let mirrored/canary traffic flow
            promote_s = time.perf_counter() - t0
            cand_err = status["errors"]["candidate"]
            inc_err = status["errors"]["incumbent"]
            if status["state"] != "promoted":
                raise RuntimeError(f"candidate not promoted after {ticks} ticks: {status}")
            if not (cand_err is not None and inc_err is not None and cand_err < inc_err):
                raise RuntimeError(
                    "promoted candidate does not beat the stale "
                    f"incumbent on held-out labels: candidate="
                    f"{cand_err} incumbent={inc_err}"
                )
            # -- phase 2: poisoned refit must auto-roll back
            faults.get_injector().arm("lifecycle.refit.poison", count=8)
            try:
                ctrl.add_feedback(*labeled(384))
                status = ctrl.tick()  # solves v2, arms its shadow
                rb_ticks = 0
                while status["state"] != "rolled_back" and rb_ticks < 3:
                    status = ctrl.tick()
                    rb_ticks += 1
            finally:
                faults.get_injector().disarm("lifecycle.refit.poison")
            if status["state"] != "rolled_back":
                raise RuntimeError(f"poisoned candidate was not rolled back: {status}")
            if rb_ticks > 1:
                raise RuntimeError(
                    f"rollback took more than one policy tick after shadow start ({rb_ticks})"
                )
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=30)
            ctrl.close()
        failures = sum(fails)
        if failures:
            raise RuntimeError(f"{failures} requests failed across the live rollout")
        latencies = [x for sub in lat for x in sub]
        emit(
            "serving_online_refit", float(np.percentile(latencies, 99)) * 1e3, "ms",
            extra={
                "requests": len(latencies),
                "failures": failures,
                "ticks_to_promote": ticks,
                "promote_wall_s": round(promote_s, 2),
                "candidate_err": cand_err,
                "incumbent_err": inc_err,
                "rollback_reason": status["last_reason"],
                "rollback_ticks_after_shadow": rb_ticks,
                "promotions": status["promotions"],
            },
        )


# -- the fleet and zoo rows -------------------------------------------------------------


def bench_router_failover(
    emit, fitted, buckets: Sequence[int], d: int,
    n_requests: int = 300, rate: float = 30.0, device=None,
) -> None:
    """``serving_router_failover`` — the fleet tier's acceptance row: a
    ``RouterServer`` fronting TWO in-process gateway replicas (each on a
    private registry, scraped over real HTTP), open-loop load through the
    router, and replica #1's responses black-holed for 1.5 s mid-run
    (``router.replica.blackhole`` matched to its registration index).
    The router must route around it: invariant verdict asserted, the
    injection count audited, and the headline fleet p99 computed from
    the router's own federated ``/metrics`` by merging the two replicas'
    scraped ``le`` buckets — with both replicas required to have served."""
    import urllib.request

    from keystone_tpu_torch.fleet import RouterServer
    from keystone_tpu_torch.gateway import Gateway, GatewayServer
    from keystone_tpu_torch.loadgen import faults, synthesize
    from keystone_tpu_torch.loadgen.invariants import InvariantChecker
    from keystone_tpu_torch.loadgen.runner import FaultPlan, HttpTarget, LoadGenerator
    from keystone_tpu_torch.observability.prometheus import (
        histogram_buckets,
        merge_histograms,
        quantile_from_buckets,
    )
    from keystone_tpu_torch.observability.registry import MetricsRegistry

    dev = resolve_device(device)
    point = "router.replica.blackhole"
    fired_before = faults.get_injector().fired_count(point)
    replicas = []
    router = None
    try:
        for i in range(2):
            # private registry per replica: in one process the two
            # "hosts" must not share metric series
            reg = MetricsRegistry()
            gw = Gateway(
                fitted, buckets=buckets, n_lanes=2, max_delay_ms=2.0,
                warmup_example=_zeros(d), name=f"bench-fleet-r{i}", registry=reg,
                device=dev,
            )
            srv = GatewayServer(gw, port=0, registry=reg).start()
            replicas.append((gw, srv))
        router = RouterServer(
            [srv.url() for _, srv in replicas], port=0, name="bench-router",
            registry=MetricsRegistry(), probe_interval_s=0.25, recovery_after_s=1.0,
        ).start()
        router.fleet.probe_once()  # don't race the first probe tick
        # 10 s of traffic vs a 3.5 s fault window: the arrival tail is
        # what recovery is measured on
        events = synthesize(n_requests, arrivals="poisson", rate=rate, shape=(d,), seed=13)
        gen = LoadGenerator(HttpTarget(router.url(), default_shape=(d,)), max_outstanding=32)
        report = gen.run(
            events,
            faults=[FaultPlan(spec={"point": point, "match": {"index": 1}}, at_s=2.0, for_s=1.5)],
            settle_s=3.0,
            recovery_probe_s=10.0,
        )
        verdict = InvariantChecker(
            p99_factor=1.5, recovery_within_s=10.0, max_shed_rate=0.9,
        ).check(report)
        injections = faults.get_injector().fired_count(point) - fired_before
        with urllib.request.urlopen(router.url("/metrics"), timeout=15) as resp:
            federated = resp.read().decode("utf-8")
        with urllib.request.urlopen(router.url("/fleetz"), timeout=15) as resp:
            roster = json.loads(resp.read())
        retries = router.metrics.retry_count()
    finally:
        if router is not None:
            router.stop()
        for gw, srv in replicas:
            gw.close()
            srv.stop()
    per_replica = [
        histogram_buckets(federated, "keystone_gateway_request_latency_seconds",
                          {"gateway": f"bench-fleet-r{i}"})
        for i in range(2)
    ]
    served_per = [b[-1][1] if b else 0.0 for b in per_replica]
    if min(served_per) <= 0:
        raise RuntimeError(
            "serving_router_failover: a replica served nothing "
            f"(per-replica request counts {served_per}) — the fleet "
            "number would be one replica's, not a federation"
        )
    fleet_p99 = quantile_from_buckets(0.99, merge_histograms(per_replica))
    if fleet_p99 is None:
        raise RuntimeError(
            "serving_router_failover: the router's federated /metrics had no "
            "latency buckets:\n" + federated
        )
    if injections <= 0:
        raise RuntimeError(
            "serving_router_failover: router.replica.blackhole never fired — "
            "the experiment proved nothing"
        )
    if not verdict.passed:
        raise RuntimeError(
            "serving_router_failover: serving invariants violated under replica "
            "loss:\n" + verdict.to_json()
        )
    stats = verdict.stats
    pre = stats.get("pre_fault_p99_ms")
    post = stats.get("recovered_p99_ms")
    if post is None:
        post = stats.get("post_fault_p99_ms")
    emit(
        "serving_router_failover", fleet_p99 * 1e3, "ms",
        extra={
            "source": "router's federated /metrics "
                      "(merge_histograms over per-replica le buckets)",
            "verdict": "green" if verdict.passed else "red",
            "invariants": [r.name for r in verdict.invariants],
            "fault": "router.replica.blackhole index=1 for 1.5s",
            "injections": injections,
            "router_retries": int(retries),
            "requests": stats["issued"],
            "resolved": stats["resolved"],
            "untyped_failures": stats["untyped_failures"],
            "lost": stats["lost"],
            "shed_rate": stats["shed_rate"],
            "pre_fault_p99_ms": pre,
            "during_fault_p99_ms": stats.get("during_fault_p99_ms"),
            "recovered_p99_ms": stats.get("recovered_p99_ms"),
            "p99_post_over_pre": round(post / pre, 3) if pre and post is not None else None,
            "per_replica_requests": served_per,
            "per_replica_p99_ms": [
                round(q * 1e3, 3) if q is not None else None
                for q in (quantile_from_buckets(0.99, b) for b in per_replica)
            ],
            "fleet_states": roster.get("counts"),
        },
    )


def bench_router_trace_overhead(
    emit, fitted, buckets: Sequence[int], d: int,
    n_pairs: int = 250, max_ratio: float = 1.05, device=None,
) -> None:
    """``serving_router_trace_overhead`` — the distributed-tracing cost
    contract: the same router + replica serving the same serial request
    stream with fleet tracing OFF and ON, asserted ``p99(on) <= 1.05 x
    p99(off)``. Requests alternate off/on PAIRWISE, pairs where EITHER
    side exceeds 3x the pooled median are dropped symmetrically (the
    drop count is reported), and a red ratio gets ONE fresh measurement
    round before the row fails."""
    import urllib.request

    from keystone_tpu_torch.fleet import RouterServer
    from keystone_tpu_torch.gateway import Gateway, GatewayServer
    from keystone_tpu_torch.observability import tracing
    from keystone_tpu_torch.observability.registry import MetricsRegistry

    tracer = tracing.get_tracer()
    was_enabled = tracer.enabled
    reg = MetricsRegistry()
    gw = Gateway(
        fitted, buckets=buckets, n_lanes=1, max_delay_ms=1.0,
        warmup_example=_zeros(d), name="bench-trace-r0", registry=reg,
        device=resolve_device(device),
    )
    srv = GatewayServer(gw, port=0, registry=reg).start()
    # probes quieted to one-per-30s: a concurrent /metrics render is
    # exactly the kind of hiccup the filter exists for
    router = RouterServer(
        [srv.url()], port=0, name="bench-trace-router",
        registry=MetricsRegistry(), probe_interval_s=30.0,
    ).start()
    try:
        router.fleet.probe_once()
        body = json.dumps({"instances": [[0.0] * d]}).encode("utf-8")

        def one() -> float:
            req = urllib.request.Request(
                router.url("/predict"), data=body,
                headers={"Content-Type": "application/json"}, method="POST",
            )
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=30) as resp:
                resp.read()
            return time.perf_counter() - t0

        def measure():
            off, on = [], []
            for _ in range(n_pairs):
                tracing.disable_tracing()
                off.append(one())
                tracing.enable_tracing()
                on.append(one())
            tracing.disable_tracing()
            a, b = np.asarray(off), np.asarray(on)
            hiccup = 3.0 * float(np.median(np.concatenate([a, b])))
            keep = (a <= hiccup) & (b <= hiccup)
            p99_off = float(np.percentile(a[keep], 99))
            p99_on = float(np.percentile(b[keep], 99))
            return p99_off, p99_on, p99_on / p99_off, int((~keep).sum())

        for _ in range(10):  # let both paths warm before measuring
            one()
        rounds = 1
        p99_off, p99_on, ratio, dropped = measure()
        if ratio > max_ratio:
            rounds = 2
            p99_off, p99_on, ratio, dropped = measure()
    finally:
        tracer.enabled = was_enabled
        router.stop()
        gw.close()
        srv.stop()
    if ratio > max_ratio:
        raise RuntimeError(
            "serving_router_trace_overhead: tracing-on p99 "
            f"{p99_on * 1e3:.2f}ms > {max_ratio}x tracing-off p99 "
            f"{p99_off * 1e3:.2f}ms (ratio {ratio:.3f}) on both "
            "measurement rounds — the span plane is no longer hot-path-cheap"
        )
    emit(
        "serving_router_trace_overhead", ratio, "x",
        extra={
            "p99_off_ms": round(p99_off * 1e3, 3),
            "p99_on_ms": round(p99_on * 1e3, 3),
            "pairs": n_pairs,
            "hiccup_pairs_dropped": dropped,
            "rounds": rounds,
            "bound": f"p99_on <= {max_ratio} x p99_off",
            "verdict": "green" if ratio <= max_ratio else "red",
            "method": "pairwise-interleaved serial requests through "
                      "router + 1 HTTP replica (off/on alternating "
                      "per request; pairs with a >3x-median host "
                      "stall on either side dropped symmetrically)",
        },
    )


def bench_zoo(
    emit,
    img: int = 34,
    hidden: int = 128,
    depth: int = 2,
    buckets: Sequence[int] = (4, 16),
    n_requests: int = 96,
    n_threads: int = 8,
    n_check: int = 12,
    min_speedup: float = 1.5,
    device=None,
) -> None:
    """``serving_zoo`` — the cross-model featurize CSE A/B: TWO models
    sharing the flagship SIFT+LCS→FV featurize prefix with different
    heads, served two ways at equal device count —

    - **baseline**: two independent gateways, so every request pays the
      shared featurize prefix TWICE, once per model;
    - **zoo**: one ``ModelZoo`` whose CSE grouping co-hosts both heads
      behind ONE ``SharedPrefixEngine`` — the prefix runs once per
      coalesced window and the features fan out to each head inside the
      same CUDA graph.

    Every request is an ensemble fan-out (one example → both models'
    predictions). Asserted: per-model zoo outputs allclose to the solo
    baselines (rtol=1e-4/atol=1e-5); the shared prefix is captured ONCE
    per bucket (zoo captures <= len(buckets), the baseline's >= 2x;
    both sides with the AOT store detached); the zoo side issues
    strictly fewer device dispatches; and sustained zoo ex/s >=
    ``min_speedup`` x the baseline, with bounded re-measures of BOTH
    sides before the row may fail."""
    from keystone_tpu_torch.gateway import Gateway
    from keystone_tpu_torch.serving.featurize import build_flagship_featurize_pipeline
    from keystone_tpu_torch.zoo import BuiltModel, ModelRegistry, ModelSpec, ModelZoo

    dev = resolve_device(device)
    featurize, feat_d = build_flagship_featurize_pipeline(img=img, device=dev)
    heads = {
        mid: build_pipeline(d=feat_d, hidden=hidden, depth=depth, seed=seed, device=dev)
        for mid, seed in (("alpha", 1), ("beta", 2))
    }
    model_ids = tuple(heads)
    rng = np.random.default_rng(17)
    check = list(rng.integers(0, 256, (n_check, img, img, 3), dtype=np.uint8))
    raws = list(rng.integers(0, 256, (n_requests, img, img, 3), dtype=np.uint8))
    warm = np.zeros((img, img, 3), np.uint8)

    def measure(submit, label):
        # unmeasured warm half-pass, then best-of-2 sustained passes
        _clients(submit, raws[: n_requests // 2], n_threads, f"zoo bench {label}")
        dt = float("inf")
        for _ in range(2):
            dt = min(dt, _clients(submit, raws, n_threads, f"zoo bench {label}")[0])
        return n_requests / dt

    def totals(gateways):
        compiles = dispatches = 0
        for gw in gateways:
            for lane in gw.pool.lanes:
                m = lane.engine.metrics
                compiles += m.compiles.total
                dispatches += m.dispatches.total
        return compiles, dispatches

    # baseline: two independent single-model gateways, AOT detached on
    # both sides (the shared engine refuses the store by construction)
    solo = {
        mid: Gateway(
            head, buckets=buckets, n_lanes=1, max_delay_ms=2.0,
            device_featurize=featurize, warmup_example=warm,
            aot_store=None, name=f"bench-zoo-solo-{mid}", device=dev,
        )
        for mid, head in heads.items()
    }
    reg = ModelRegistry()
    for mid, head in heads.items():
        reg.register(ModelSpec(
            model_id=mid,
            build=(lambda h=head: BuiltModel(fitted=h, featurize=featurize)),
            buckets=buckets,
            lanes=1,
            input_dtype=np.uint8,
            warmup_example=warm,
            max_delay_ms=2.0,
            default=(mid == model_ids[0]),
        ))
    zoo = ModelZoo(reg, cse=True, device=dev)

    def base_submit(x):
        futs = {m: solo[m].predict(x) for m in model_ids}
        return {m: np.asarray(f.result(timeout=120)) for m, f in futs.items()}

    def zoo_submit(x):
        out = zoo.predict_many(x, model_ids).result(timeout=120)
        return {m: np.asarray(out[m]) for m in model_ids}

    try:
        hosted = zoo.host()
        if not any(len(unit) == 2 for unit in hosted):
            raise RuntimeError(
                f"zoo did not CSE-group the two flagship heads "
                f"(hosted units: {hosted}) — identical featurize "
                "tokens must co-host behind one SharedPrefixEngine"
            )
        base_outs = _clients(base_submit, check, n_threads, "zoo bench baseline")[1]
        zoo_outs = _clients(zoo_submit, check, n_threads, "zoo bench zoo")[1]
        base_rate = measure(base_submit, "baseline")
        zoo_rate = measure(zoo_submit, "zoo")
        for _ in range(3):
            if zoo_rate >= min_speedup * base_rate:
                break
            # bounded re-measures of BOTH sides; best of all observed
            # passes per side, then the gate is final
            base_rate = max(base_rate, measure(base_submit, "baseline"))
            zoo_rate = max(zoo_rate, measure(zoo_submit, "zoo"))
        base_compiles, base_dispatches = totals(solo.values())
        zoo_compiles, zoo_dispatches = totals([zoo.gateway_for(model_ids[0])])
    finally:
        zoo.close()
        for gw in solo.values():
            gw.close()

    maxdiff = 0.0
    for i, (b, z) in enumerate(zip(base_outs, zoo_outs)):
        for mid in model_ids:
            maxdiff = max(maxdiff, float(np.abs(b[mid] - z[mid]).max()))
            if not np.allclose(b[mid], z[mid], rtol=1e-4, atol=1e-5):
                raise RuntimeError(
                    f"zoo output for model {mid!r} diverges from its "
                    f"solo gateway on example {i} (max abs diff "
                    f"{np.abs(b[mid] - z[mid]).max():.3e}) — the "
                    "shared prefix must not change any head's answer"
                )
    if zoo_compiles > len(buckets):
        raise RuntimeError(
            f"zoo side captured {zoo_compiles} graphs for "
            f"{len(buckets)} buckets — the shared prefix was supposed "
            "to be captured ONCE per bucket for the whole group"
        )
    if base_compiles < 2 * zoo_compiles:
        raise RuntimeError(
            f"baseline captured {base_compiles} graphs vs the zoo's "
            f"{zoo_compiles} — the two-gateway baseline must pay the "
            "featurize prefix per model for this A/B to mean anything"
        )
    if base_dispatches <= zoo_dispatches:
        raise RuntimeError(
            f"zoo issued {zoo_dispatches} device dispatches vs the "
            f"baseline's {base_dispatches} for the same request "
            "stream — one coalesced window must serve BOTH heads"
        )
    if zoo_rate < min_speedup * base_rate:
        raise RuntimeError(
            f"zoo sustains {zoo_rate:.1f} ensemble ex/s vs the "
            f"two-gateway baseline's {base_rate:.1f} — only "
            f"{zoo_rate / base_rate:.2f}x (need >= {min_speedup}x): "
            "sharing the featurize prefix did not pay for itself"
        )
    emit(
        "serving_zoo", zoo_rate, "examples/sec",
        extra={
            "baseline_examples_per_sec": round(base_rate, 1),
            "zoo_examples_per_sec": round(zoo_rate, 1),
            "speedup_vs_two_gateways": round(zoo_rate / base_rate, 3),
            "min_speedup": min_speedup,
            "models": list(model_ids),
            "cse_groups": [list(u) for u in hosted],
            "baseline_compiles": base_compiles,
            "zoo_compiles": zoo_compiles,
            "baseline_dispatches": base_dispatches,
            "zoo_dispatches": zoo_dispatches,
            "raw_shape": [img, img, 3],
            "feature_dim": feat_d,
            "buckets": list(buckets),
            "requests": n_requests,
            "client_threads": n_threads,
            "outputs_allclose": True,
            "max_abs_diff": maxdiff,
        },
    )


def bench_attribution_drift(
    emit,
    img: int = 16,
    hidden: int = 64,
    depth: int = 2,
    buckets: Sequence[int] = (2, 8, 32),
    n_per_model: int = 40,
    n_threads: int = 4,
    base_mix: str = "1:0.8,2:0.2",
    shift_mix: str = "24:1.0",
    max_p99_ratio: float = 1.05,
    sum_tolerance: float = 1e-6,
    device=None,
) -> None:
    """``serving_attribution_drift`` — the attribution & drift plane
    end-to-end: a two-model zoo (CSE-shared featurize prefix, so the
    fair-split rule is exercised, weighed by the shared engine's
    prefix/head cost split) planned against a small-size mixture, driven
    through a MID-RUN WORKLOAD SHIFT — ``alpha``'s request sizes swap
    from ``base_mix`` to ``shift_mix`` while ``beta`` stays on the
    planned mixture.

    Gates (raise, not assert): the **sum invariant** (per-model ledger
    totals sum to the engine-side counters within ``sum_tolerance``
    relative); **drift selectivity** (after the shift the PSI score trips
    for ``alpha`` ONLY, and nothing is flagged before it); the **re-plan
    audit** (``/driftz`` carries a recommendation whose proposed buckets
    for the shifted model cover the new size strictly tighter); and the
    **overhead** (client p99 with attribution attached <=
    ``max_p99_ratio`` x an identical zoo with the bindings detached, with
    bounded re-measures of both sides)."""
    from keystone_tpu_torch.loadgen.trace import parse_size_mix
    from keystone_tpu_torch.serving.featurize import build_featurize_pipeline
    from keystone_tpu_torch.zoo import BuiltModel, ModelRegistry, ModelSpec, ModelZoo
    from keystone_tpu_torch.zoo.optimizer import ChipBudget, plan_placement

    dev = resolve_device(device)
    featurize, feat_d = build_featurize_pipeline(img=img, device=dev)
    heads = {
        mid: build_pipeline(d=feat_d, hidden=hidden, depth=depth, seed=seed, device=dev)
        for mid, seed in (("alpha", 1), ("beta", 2))
    }
    model_ids = tuple(heads)
    warm = np.zeros((img, img, 3), np.uint8)
    rng = np.random.default_rng(23)
    pool = rng.integers(0, 256, (16, img, img, 3), dtype=np.uint8)

    def build_zoo():
        reg = ModelRegistry()
        for i, (mid, head) in enumerate(heads.items()):
            reg.register(ModelSpec(
                model_id=mid,
                build=(lambda h=head: BuiltModel(fitted=h, featurize=featurize)),
                buckets=buckets,
                lanes=1,
                input_dtype=np.uint8,
                warmup_example=warm,
                max_delay_ms=2.0,
                # the planner's assumed mixture — what base_mix's live
                # traffic matches and shift_mix's diverges from
                expected_sizes={
                    s: max(1, int(round(w * 100))) for s, w in parse_size_mix(base_mix)
                },
                default=(i == 0),
            ))
        return ModelZoo(reg, cse=True, device=dev)

    def sizes_from(mix_spec: str, n: int):
        mix = parse_size_mix(mix_spec)
        weights = np.asarray([w for _, w in mix], dtype=float)
        return [int(s) for s in rng.choice([s for s, _ in mix], size=n,
                                           p=weights / weights.sum())]

    def schedule_for(mix_by_model):
        requests = []
        for mid, mix_spec in mix_by_model.items():
            requests.extend((mid, s) for s in sizes_from(mix_spec, n_per_model))
        rng.shuffle(requests)
        return requests

    def drive(zoo, schedule):
        """One phase: per request, one drift observation + ``size``
        admitted instances; returns per-request client latencies."""
        def submit(item):
            mid, size = item
            zoo.observe_request(mid, size)
            t0 = time.perf_counter()
            futs = [zoo.predict(pool[j % len(pool)], mid) for j in range(size)]
            for f in futs:
                f.result(timeout=120)
            return time.perf_counter() - t0

        return _clients(submit, schedule, n_threads, "attribution bench")[1]

    def p99(latencies):
        return float(np.percentile(np.asarray(latencies), 99))

    def gateways_of(zoo):
        return {id(zoo.gateway_for(m)): zoo.gateway_for(m) for m in model_ids}.values()

    def engine_totals(zoo):
        out = {
            "goodput_rows": 0.0, "padded_rows": 0.0, "dispatches": 0.0,
            "device_flops": 0.0, "h2d_bytes": 0.0, "device_seconds": 0.0,
        }
        for gw in gateways_of(zoo):
            for lane in gw.pool.lanes:
                m = lane.engine.metrics
                out["goodput_rows"] += m.examples.total
                out["padded_rows"] += m.padded_rows.total
                out["dispatches"] += m.dispatches.total
                out["device_flops"] += m.device_flops.total
                out["h2d_bytes"] += m.h2d_bytes.total
                out["device_seconds"] += m.dispatch_latency.snapshot()["total"]
        return out

    base_schedule = schedule_for({m: base_mix for m in model_ids})
    shift_schedule = schedule_for({"alpha": shift_mix, "beta": base_mix})

    zoo = build_zoo()
    try:
        zoo.host()
        profiles = zoo.profiles(build=True)
        budget = ChipBudget(lane_budget=len(model_ids))
        zoo.apply_plan(plan_placement(profiles, budget), budget=budget, profiles=profiles)
        old_buckets = {m: zoo.plan.placement_for(m).buckets for m in model_ids}
        drive(zoo, base_schedule)  # matches the plan: nothing drifts
        pre_shift = zoo.driftz()
        on_latencies = drive(zoo, shift_schedule)
        doc = zoo.driftz()
        attr = zoo.attributionz()
        eng = engine_totals(zoo)
        led = zoo.attribution.totals()
    finally:
        zoo.close()

    # -- gate 1: the sum invariant (CSE fair-split included)
    rel_errs = {}
    for field, eng_total in eng.items():
        led_total = led[field]
        rel = abs(eng_total - led_total) / abs(eng_total) if eng_total else abs(led_total)
        rel_errs[field] = rel
        if rel > sum_tolerance:
            raise RuntimeError(
                f"attribution {field} totals diverge: engines "
                f"{eng_total} vs ledger {led_total} "
                f"({rel:.2e} rel > {sum_tolerance:.0e}) — per-model "
                "charges must sum exactly to engine totals"
            )
    # -- gate 2: drift fires on the shifted model only
    if pre_shift["drifted"]:
        raise RuntimeError(
            f"models {pre_shift['drifted']} flagged as drifted while "
            "traffic still matched the plan's mixture"
        )
    scores = doc["scores"]
    if "alpha" not in doc["drifted"]:
        raise RuntimeError(
            f"the shifted model never tripped the PSI threshold "
            f"(scores {scores}, threshold {doc['threshold']}) — "
            f"{base_mix} -> {shift_mix} is a full population swap"
        )
    if "beta" in doc["drifted"]:
        raise RuntimeError(
            f"beta flagged as drifted (scores {scores}) though its "
            "mixture never changed — drift must be per-model, not engine-wide"
        )
    if "beta" not in scores:
        raise RuntimeError(
            "beta produced no PSI score despite a baseline and "
            f"{n_per_model} windowed observations"
        )
    # -- gate 3: the re-plan audit
    rec = doc["recommendation"]
    if not rec or not rec.get("changes"):
        raise RuntimeError(
            f"drift tripped but /driftz carries no re-plan recommendation (got {rec!r})"
        )
    if "alpha" not in rec["changes"]:
        raise RuntimeError(
            f"re-plan changed {sorted(rec['changes'])} but not the "
            "shifted model — the recommendation must follow the drift"
        )
    proposed = {p["model"]: tuple(p["buckets"]) for p in rec["proposed_plan"]["placements"]}
    shift_size = max(s for s, _ in parse_size_mix(shift_mix))

    def covering(bucket_set):
        # what the shifted size actually pays under this bucket set
        fits = [b for b in bucket_set if b >= shift_size]
        return min(fits) if fits else max(bucket_set)

    if covering(proposed["alpha"]) >= covering(old_buckets["alpha"]):
        raise RuntimeError(
            f"shifted model's proposed buckets {proposed['alpha']} "
            f"don't cover size {shift_size} any tighter than the "
            f"applied plan's {old_buckets['alpha']} though live "
            f"sizes moved from {base_mix} to {shift_mix} — the "
            "re-plan is not directionally correct"
        )

    # -- gate 4: attribution overhead
    def measure(attached: bool):
        z = build_zoo()
        try:
            z.host()
            if not attached:
                for gw in gateways_of(z):
                    for lane in gw.pool.lanes:
                        # identical serving shape, ledger mirror detached
                        lane.engine.metrics.attach_attribution(None)
            drive(z, base_schedule)  # warm parity with the on side
            return p99(drive(z, shift_schedule))
        finally:
            z.close()

    p99_on = p99(on_latencies)
    p99_off = measure(False)
    for _ in range(2):
        if p99_on <= max_p99_ratio * p99_off:
            break
        # bounded re-measures; best observed per side is final
        p99_on = min(p99_on, measure(True))
        p99_off = min(p99_off, measure(False))
    if p99_on > max_p99_ratio * p99_off:
        raise RuntimeError(
            f"attribution-on p99 {p99_on * 1e3:.1f} ms vs off "
            f"{p99_off * 1e3:.1f} ms — {p99_on / p99_off:.3f}x exceeds "
            f"{max_p99_ratio}x: the ledger mirror is not allowed to tax the serving path"
        )
    emit(
        "serving_attribution_drift", scores.get("alpha"), "psi",
        extra={
            "scores": scores,
            "threshold": doc["threshold"],
            "drifted": doc["drifted"],
            "base_mix": base_mix,
            "shift_mix": shift_mix,
            "attribution_rel_err_max": max(rel_errs.values()),
            "attribution_totals": {k: round(v, 6) for k, v in led.items()},
            "per_model_device_seconds": {
                m: round(attr["models"][m]["device_seconds"], 6) for m in attr["models"]
            },
            "replan_changed_models": sorted(rec["changes"]),
            "buckets_before": {m: list(b) for m, b in old_buckets.items()},
            "buckets_proposed": {m: list(b) for m, b in proposed.items()},
            "p99_on_ms": round(p99_on * 1e3, 3),
            "p99_off_ms": round(p99_off * 1e3, 3),
            "p99_ratio": round(p99_on / p99_off, 3),
            "max_p99_ratio": max_p99_ratio,
            "requests_per_model_per_phase": n_per_model,
        },
    )


# -- the rows that span processes or devices ----------------------------------------


def bench_sharded_vs_replicated(
    emit,
    sizes: Sequence[int] = (128, 256, 512),
    big_d: int = 1024,
    depth: int = 3,
    buckets: Sequence[int] = (8, 32),
    n_requests: int = 192,
    n_threads: int = 8,
    n_check: int = 16,
    replicated_lanes: int = 2,
    device_budget_mb: float = 6.0,
    device=None,
) -> None:
    """``serving_sharded_vs_replicated`` — the model axis A/B: the same
    fitted model served

    - **replicated**: ``replicated_lanes`` shared-nothing lanes, each
      holding the FULL parameter set;
    - **sharded**: ONE lane whose engine runs ``param_sharding=True``
      over a ``(data=1, model=N)`` mesh spanning every card — the
      default rules split each weight matrix over the model axis and
      each card holds only its shard.

    Swept over ``sizes`` (square ``depth``-layer models) plus ``big_d``,
    sized to exceed the row's per-device parameter budget
    (``device_budget_mb``). Per size the row asserts (raises): sharded
    outputs allclose to the replicated path's; the big model's TOTAL
    parameter bytes exceed the budget (the replicated path is refused,
    ``over_budget``) while its measured per-device placed-parameter
    bytes (``sharding.placed_shard_bytes``) fit, and it SERVES; every
    size both paths can serve contributes a crossover-curve entry.
    Needs >= 2 cards: on one it raises, as the JAX row does on fewer
    than 2 devices."""
    from keystone_tpu_torch.gateway import Gateway
    from keystone_tpu_torch.serving import sharding as sharding_lib

    dev = resolve_device(device)
    n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n_devices < 2:
        raise RuntimeError(
            "serving_sharded_vs_replicated needs >= 2 devices; this host "
            f"has {n_devices} ({dev.type}), so the model axis cannot split"
        )
    budget = int(device_budget_mb * 1e6)
    mesh = sharding_lib.make_mesh(n_data=1, n_model=n_devices)

    def measure(gw, inputs):
        submit = _gateway_submit(gw, 120)
        _clients(submit, inputs[: len(inputs) // 2], n_threads, f"shard bench {gw.name}")
        dt = float("inf")
        for _ in range(2):
            dt = min(dt, _clients(submit, inputs, n_threads, f"shard bench {gw.name}")[0])
        return len(inputs) / dt

    curve = []
    rng = np.random.default_rng(17)
    for d in tuple(sizes) + (int(big_d),):
        model = build_pipeline(d=d, hidden=d, depth=depth, device=dev)
        total = sharding_lib.params_nbytes(sharding_lib.named_params(model))
        fits_one_device = total <= budget
        check = [rng.standard_normal((d,)).astype(np.float32) for _ in range(n_check)]
        raws = [rng.standard_normal((d,)).astype(np.float32) for _ in range(n_requests)]
        entry = {"d": d, "params_mb": round(total / 1e6, 2), "fits_one_device": fits_one_device}
        prev = sharding_lib.current_mesh()
        sharding_lib.set_mesh(mesh)
        try:
            gw_s = Gateway(
                model, buckets=buckets, n_lanes=1, max_delay_ms=2.0, param_sharding=True,
                warmup_example=_zeros(d), name=f"bench-shard-{d}", device=dev,
            )
        finally:
            sharding_lib.set_mesh(prev)
        gw_r = None
        if fits_one_device:
            gw_r = Gateway(
                model, buckets=buckets, n_lanes=replicated_lanes, max_delay_ms=2.0,
                warmup_example=_zeros(d), name=f"bench-repl-{d}", device=dev,
            )
        else:
            # the capability gap itself: a replicated lane needs the FULL
            # parameter set resident per device
            entry["replicated"] = "over_budget"
        try:
            engine = gw_s.pool.lanes[0].engine
            if not engine.model_sharded:
                raise RuntimeError(f"d={d}: the sharded gateway's engine is not model-sharded")
            per_dev = sharding_lib.placed_shard_bytes(engine._placed_params)
            max_dev = max(per_dev.values())
            entry["max_device_params_mb"] = round(max_dev / 1e6, 2)
            if max_dev > budget:
                raise RuntimeError(
                    f"d={d}: sharded per-device parameter bytes "
                    f"{max_dev} exceed the {budget}-byte budget — the "
                    "partition rules did not actually split the model"
                )
            outs_s = _clients(_gateway_submit(gw_s, 120), check, n_threads,
                              f"shard bench {gw_s.name}")[1]
            if gw_r is not None:
                outs_r = _clients(_gateway_submit(gw_r, 120), check, n_threads,
                                  f"shard bench {gw_r.name}")[1]
                for i, (a, b) in enumerate(zip(outs_s, outs_r)):
                    if not np.allclose(a, b, rtol=1e-4, atol=1e-5):
                        raise RuntimeError(
                            f"d={d}: sharded output {i} diverges from "
                            f"the replicated path (max abs diff {np.abs(a - b).max():.3e})"
                        )
                entry["outputs_allclose"] = True
                entry["replicated_examples_per_sec"] = round(measure(gw_r, raws), 1)
            entry["sharded_examples_per_sec"] = round(measure(gw_s, raws), 1)
        finally:
            gw_s.close()
            if gw_r is not None:
                gw_r.close()
        curve.append(entry)

    big = curve[-1]
    if big["fits_one_device"]:
        raise RuntimeError(
            f"big_d={big_d} fits the {device_budget_mb} MB device "
            "budget — the over-budget leg measured nothing; raise "
            "big_d or lower the budget"
        )
    if "sharded_examples_per_sec" not in big:
        raise RuntimeError("the over-budget model did not serve on the sharded path")
    if not all(e.get("outputs_allclose") for e in curve if e["fits_one_device"]):
        raise RuntimeError(f"parity missing from the curve: {curve}")
    emit(
        "serving_sharded_vs_replicated", big["sharded_examples_per_sec"], "examples/sec",
        extra={
            "n_devices": n_devices,
            "mesh": {"data": 1, "model": n_devices},
            "device_budget_mb": device_budget_mb,
            "replicated_lanes": replicated_lanes,
            "depth": depth,
            "buckets": list(buckets),
            "requests": n_requests,
            "crossover_curve": curve,
            "over_budget_d": big_d,
            "over_budget_params_mb": big["params_mb"],
            "over_budget_max_device_params_mb": big["max_device_params_mb"],
            "over_budget_served_sharded": True,
        },
    )


def _entry_argv(device) -> List[str]:
    """The interpreter arguments that run ``python -m keystone_tpu_torch``
    on ``device`` (the card by default)."""
    if device is None or torch.device(device).type == "cuda":
        return ["-m", "keystone_tpu_torch"]
    return ["-c", "import sys; from keystone_tpu_torch.__main__ import main; "
                  f"sys.exit(main(sys.argv[1:], device={str(torch.device(device))!r}))"]


def bench_cold_start_aot(
    emit,
    buckets: Sequence[int] = (4, 8, 16, 32, 64, 128),
    d: int = 128, hidden: int = 256, depth: int = 40,
    lanes: int = 4, min_speedup: float = 3.0,
    device=None,
) -> None:
    """``serving_cold_start_aot`` — the zero-cold-start acceptance row,
    measured CROSS-PROCESS: spawn a fresh ``serve-gateway`` subprocess
    twice — once with no AOT store (``--no-cache``), once with a store
    pre-populated by an untimed ``serve-aot-build`` subprocess — and time
    each from ``exec()`` to ``/readyz`` 200 and to the first successful
    ``/predict``. Both timed children get a FRESH empty kernel build
    directory (``KEYSTONE_CUDA_BUILD_DIR``), so what the warm one skips
    is attributable to the store alone, and
    ``keystone_aot_cache_hits_total`` is scraped off the warm child's
    own ``/metrics`` to prove the store served it.

    The pipeline is deliberately DEEPER than the other rows' (40 matmul
    nodes, 4 lanes, 6 buckets). The children share the card with this
    process (CUDA processes can; the JAX row skips on a device backend
    because a TPU cannot be shared)."""
    import collections
    import os
    import re
    import shutil
    import signal
    import subprocess
    import sys
    import tempfile
    import urllib.request

    from keystone_tpu_torch.observability import prometheus

    dev = resolve_device(device)
    workdir = tempfile.mkdtemp(prefix="keystone-aot-bench-")
    aot_dir = os.path.join(workdir, "aot")
    entry = _entry_argv(dev)
    shape_args = [
        "--d", str(d), "--hidden", str(hidden), "--depth", str(depth),
        "--buckets", ",".join(str(b) for b in buckets),
    ]

    def child_env(**caches):
        # explicit store env per child: this process's environment may
        # carry KEYSTONE_* pointers that would contaminate a run
        env = {k: v for k, v in os.environ.items() if not k.startswith("KEYSTONE_")}
        env.update(caches)
        return env

    def measure(args, env):
        """One fresh gateway process: wall seconds from spawn to /readyz
        200 and to the first /predict 200, plus its /metrics AOT-hit
        count."""
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, *entry, "serve-gateway", "--gateway-port", "0",
             "--lanes", str(lanes)] + shape_args + args,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        # watchdog: a wedged child must fail the row, not hang the bench
        watchdog = threading.Timer(600.0, proc.kill)
        watchdog.daemon = True
        watchdog.start()
        tail = collections.deque(maxlen=200)

        def tail_text():
            # snapshot first: the drainer thread appends concurrently
            return "".join(tail.copy())

        try:
            url = None
            for line in proc.stdout:
                tail.append(line)
                m = re.search(r"http://127\.0\.0\.1:\d+", line)
                if m:
                    url = m.group(0)
                    break
            if url is None:
                raise RuntimeError(
                    "serving_cold_start_aot: gateway subprocess died before binding:\n"
                    + tail_text()
                )
            # keep DRAINING the child's output: a full pipe would block
            # the child inside its own write
            threading.Thread(target=lambda: tail.extend(proc.stdout), daemon=True).start()
            deadline = time.perf_counter() + 600.0
            while True:
                if proc.poll() is not None:
                    raise RuntimeError(
                        "serving_cold_start_aot: gateway subprocess "
                        f"exited (rc {proc.returncode}) before /readyz went 200:\n"
                        + tail_text()
                    )
                if time.perf_counter() > deadline:
                    raise RuntimeError("serving_cold_start_aot: /readyz never went 200 within 600s")
                try:
                    if urllib.request.urlopen(url + "/readyz", timeout=5).status == 200:
                        break
                except Exception:
                    time.sleep(0.02)
            t_ready = time.perf_counter() - t0
            body = json.dumps({"instances": [[0.0] * d]}).encode()
            urllib.request.urlopen(
                urllib.request.Request(url + "/predict", data=body,
                                       headers={"Content-Type": "application/json"}),
                timeout=120,
            ).read()
            t_predict = time.perf_counter() - t0
            with urllib.request.urlopen(url + "/metrics", timeout=15) as resp:
                exposition = resp.read().decode("utf-8")
            hits = sum(
                value for name, _labels, value in prometheus.parse_samples(exposition)
                if name == "keystone_aot_cache_hits_total"
            )
        finally:
            watchdog.cancel()
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        return {"ready_s": t_ready, "predict_s": t_predict, "hits": hits}

    try:
        # untimed: populate the store the way a build/deploy step would
        build = subprocess.run(
            [sys.executable, *entry, "serve-aot-build"] + shape_args,
            env=child_env(KEYSTONE_AOT_CACHE=aot_dir,
                          KEYSTONE_CUDA_BUILD_DIR=os.path.join(workdir, "build-store")),
            capture_output=True, text=True, timeout=900,
        )
        if build.returncode != 0:
            raise RuntimeError(
                "serving_cold_start_aot: serve-aot-build failed:\n" + build.stdout + build.stderr
            )
        cold = measure(["--no-cache"], child_env(
            KEYSTONE_CUDA_BUILD_DIR=os.path.join(workdir, "build-cold")))
        warm = measure([], child_env(
            KEYSTONE_AOT_CACHE=aot_dir,
            KEYSTONE_CUDA_BUILD_DIR=os.path.join(workdir, "build-warm")))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    want_hits = lanes * len(buckets)
    if warm["hits"] < want_hits:
        raise RuntimeError(
            f"serving_cold_start_aot: warm gateway reported "
            f"{warm['hits']} AOT cache hits on /metrics, expected "
            f">= {want_hits} ({lanes} lanes x {len(buckets)} buckets) "
            "— the fast start is not attributable to the store"
        )
    speedup = cold["predict_s"] / warm["predict_s"]
    if speedup < min_speedup:
        raise RuntimeError(
            f"serving_cold_start_aot: fresh-process first-predict with "
            f"a warm AOT store was only {speedup:.2f}x faster than "
            f"without it ({warm['predict_s']:.2f}s vs "
            f"{cold['predict_s']:.2f}s); the acceptance floor is "
            f"{min_speedup:.1f}x"
        )
    emit(
        "serving_cold_start_aot", warm["predict_s"] * 1e3, "ms_to_first_predict",
        extra={
            "source": "fresh subprocess: exec() -> /readyz -> /predict",
            "speedup_vs_no_store": round(speedup, 2),
            "cold_first_predict_ms": round(cold["predict_s"] * 1e3, 1),
            "cold_ready_ms": round(cold["ready_s"] * 1e3, 1),
            "warm_ready_ms": round(warm["ready_s"] * 1e3, 1),
            "aot_cache_hits": int(warm["hits"]),
            "lanes": lanes,
            "buckets": list(buckets),
            "pipeline": {"d": d, "hidden": hidden, "depth": depth},
            "warm_compile_cache": "fresh empty kernel build dir (speedup is "
                                  "the AOT store alone)",
        },
    )


def bench_autoscale_ramp(
    emit, fitted, buckets: Sequence[int], d: int, max_replicas: int = 3, device=None,
) -> None:
    """``serving_autoscale_ramp`` — the elasticity acceptance row: a
    ``RouterServer`` + the ``autoscale/`` supervisor and control loop
    over in-process replicas, driven by a STEP-LOAD RAMP
    (``synthesize_steps``): a low baseline, a surge calibrated to ~4x one
    replica's measured sequential rate, and a drop back to baseline.
    Mid-surge — mid-SCALE-UP — ``router.replica.partition`` severs the
    original replica's forwards for 1.2 s.

    Asserted (raises): the fleet SCALES OUT (>= 2 replicas seen) and back
    DOWN to the 1-replica baseline once the load drops; the loadgen
    invariant verdict is GREEN across the whole run; the partition
    actually fired. Rates and the SLO are CALIBRATED against a measured
    sequential baseline latency; one bounded in-row retry."""
    import urllib.request

    from keystone_tpu_torch.autoscale.controller import Autoscaler, RouterScraper
    from keystone_tpu_torch.autoscale.policy import PolicyConfig, PolicyEngine
    from keystone_tpu_torch.autoscale.supervisor import InprocLauncher, Supervisor
    from keystone_tpu_torch.fleet import RouterServer
    from keystone_tpu_torch.gateway import Gateway, GatewayServer
    from keystone_tpu_torch.loadgen import faults
    from keystone_tpu_torch.loadgen.invariants import InvariantChecker
    from keystone_tpu_torch.loadgen.runner import FaultPlan, HttpTarget, LoadGenerator
    from keystone_tpu_torch.loadgen.trace import synthesize_steps
    from keystone_tpu_torch.observability import tracing
    from keystone_tpu_torch.observability.registry import MetricsRegistry

    dev = resolve_device(device)
    point = "router.replica.partition"
    # requests carry a full bucket of rows so coalescing cannot multiply
    # one replica's capacity past the calibration below
    n_rows = min(buckets)

    def run_once(attempt: int):
        tracer = tracing.get_tracer()
        was_enabled = tracer.enabled
        # phase evidence and the autoscale.decision spans ride the tracer
        tracing.enable_tracing()
        fired_before = faults.get_injector().fired_count(point)
        router = RouterServer(
            [], port=0, name=f"bench-autoscale-{attempt}", registry=MetricsRegistry(),
            probe_interval_s=0.25, recovery_after_s=1.0,
        ).start()

        def factory(index: int):
            reg = MetricsRegistry()
            gw = Gateway(
                fitted, buckets=buckets, n_lanes=1, max_delay_ms=2.0,
                warmup_example=_zeros(d), name=f"bench-as{attempt}-r{index}",
                registry=reg, device=dev,
            )
            srv = GatewayServer(gw, port=0, registry=reg).start()
            return gw, srv

        supervisor = Supervisor(
            InprocLauncher(factory), router.url(),
            startup_timeout_s=60.0, drain_timeout_s=15.0,
        )
        autoscaler = None
        try:
            supervisor.scale_to(1)
            for _ in range(40):  # don't race the first probe tick
                router.fleet.probe_once()
                if any(r.ready and r.healthy for r in router.fleet.replicas()):
                    break
                time.sleep(0.25)

            # -- calibration: one replica's sequential service time
            body = json.dumps({"instances": [[0.1] * d] * n_rows}).encode("utf-8")

            def one() -> float:
                req = urllib.request.Request(
                    router.url("/predict"), data=body,
                    headers={"Content-Type": "application/json"}, method="POST",
                )
                t0 = time.perf_counter()
                with urllib.request.urlopen(req, timeout=30) as resp:
                    resp.read()
                return time.perf_counter() - t0

            for _ in range(3):
                one()  # warm both hops
            lat = sorted(one() for _ in range(8))
            base_s = lat[len(lat) // 2]
            # the surge must EXCEED one replica's capacity on any host
            # speed; the SLO sits at 5x the unloaded baseline
            capacity_rps = 1.0 / max(base_s, 1e-3)
            low_rate = min(8.0, max(1.0, 0.1 * capacity_rps))
            high_rate = min(300.0, max(10.0, 4.0 * capacity_rps))
            slo_s = max(0.03, 5.0 * base_s)

            engine = PolicyEngine(PolicyConfig(
                min_replicas=1, max_replicas=max_replicas, slo_latency_s=slo_s,
                up_consecutive=2, down_consecutive=4, up_cooldown_s=2.0,
                down_cooldown_s=2.0, down_p99_headroom=0.5,
            ))
            autoscaler = Autoscaler(
                supervisor,
                RouterScraper(router.url(), p99_window_s=3.0, phase_samples_per_tick=2),
                engine, interval_s=0.5, registry=router.registry,
                name=f"bench-autoscale-{attempt}",
            ).start()

            # low 4s -> surge 10s -> low 10s; the partition severs the
            # ORIGINAL replica (index 0) mid-surge, mid-scale-up
            steps = [(low_rate, 4.0), (high_rate, 10.0), (low_rate, 10.0)]
            events = synthesize_steps(
                steps, arrivals="poisson", shape=(d,), size_mix=((n_rows, 1.0),), seed=29,
            )
            gen = LoadGenerator(HttpTarget(router.url(), default_shape=(d,)), max_outstanding=64)
            report = gen.run(
                events,
                faults=[FaultPlan(spec={"point": point, "match": {"index": 0}},
                                  at_s=9.0, for_s=1.2)],
                settle_s=6.0,
                recovery_probe_s=10.0,
            )
            verdict = InvariantChecker(
                p99_factor=2.0, recovery_within_s=12.0, max_shed_rate=0.9,
            ).check(report)
            injections = faults.get_injector().fired_count(point) - fired_before

            # scale-down back to baseline: the cold streak + cooldowns
            # need a few more ticks
            deadline = time.perf_counter() + 25.0
            while supervisor.target > 1 and time.perf_counter() < deadline:
                time.sleep(0.5)
            final_target = supervisor.target
            max_seen = autoscaler.max_replicas_seen
            decisions = [(d2.action, d2.reason) for d2 in autoscaler.decisions
                         if d2.action != "hold"]
            up_count = autoscaler.metrics.decision_count("scale_up")
            down_count = autoscaler.metrics.decision_count("scale_down")
        finally:
            if autoscaler is not None:
                autoscaler.stop()
            supervisor.stop()
            router.stop()
            tracer.enabled = was_enabled
        return {
            "verdict": verdict, "injections": injections, "max_seen": max_seen,
            "final_target": final_target, "decisions": decisions,
            "up_count": up_count, "down_count": down_count,
            "base_ms": base_s * 1e3, "slo_ms": slo_s * 1e3,
            "low_rate": low_rate, "high_rate": high_rate,
        }

    last_error = None
    for attempt in (1, 2):
        try:
            r = run_once(attempt)
        except Exception as e:
            if attempt == 1:
                # a host stall mid-calibration gets the same single
                # fresh chance a red verdict does
                last_error = f"attempt 1 raised {type(e).__name__}: {e}"
                continue
            raise
        problems = []
        if r["injections"] <= 0:
            problems.append(f"{point} never fired — the chaos leg proved nothing")
        if not r["verdict"].passed:
            problems.append("serving invariants violated:\n" + r["verdict"].to_json())
        if r["max_seen"] < 2:
            problems.append(f"fleet never scaled out (max {r['max_seen']} replica)")
        if r["final_target"] != 1:
            problems.append(
                "fleet did not scale back down to the 1-replica "
                f"baseline (final target {r['final_target']})"
            )
        if not problems:
            break
        last_error = "; ".join(problems)
        if attempt == 1:
            continue
        raise RuntimeError(f"serving_autoscale_ramp failed on both attempts: {last_error}")
    stats = r["verdict"].stats
    emit(
        "serving_autoscale_ramp",
        stats.get("recovered_p99_ms") or stats.get("post_fault_p99_ms"), "ms",
        extra={
            "verdict": "green",
            "invariants": [x.name for x in r["verdict"].invariants],
            "fault": f"{point} index=0 for 1.2s mid-surge",
            "injections": r["injections"],
            "max_replicas_seen": r["max_seen"],
            "final_target": r["final_target"],
            "scale_ups": r["up_count"],
            "scale_downs": r["down_count"],
            "decisions": r["decisions"],
            "calibrated_baseline_ms": round(r["base_ms"], 2),
            "slo_ms": round(r["slo_ms"], 2),
            "ramp_rps": [round(r["low_rate"], 1), round(r["high_rate"], 1),
                         round(r["low_rate"], 1)],
            "requests": stats["issued"],
            "resolved": stats["resolved"],
            "untyped_failures": stats["untyped_failures"],
            "lost": stats["lost"],
            "shed_rate": stats["shed_rate"],
            "pre_fault_p99_ms": stats.get("pre_fault_p99_ms"),
            "during_fault_p99_ms": stats.get("during_fault_p99_ms"),
            "recovered_p99_ms": stats.get("recovered_p99_ms"),
        },
    )


# -- the row groups and the entry ----------------------------------------------------


def run_autoscale_benches(
    emit, d: int = 64, hidden: int = 256, depth: int = 3,
    buckets: Sequence[int] = (8, 16), fitted=None, device=None,
) -> None:
    """The elasticity row (~45 s of ramped load through a live
    autoscaler). A smaller pipeline than the default bench shape: the
    row measures the CONTROL LOOP, and per-replica warmup stretches the
    scale-up reaction it asserts on."""
    if fitted is None:
        fitted = build_pipeline(d, hidden, depth, device=device)
    bench_autoscale_ramp(emit, fitted, buckets, d, device=device)


def run_fleet_benches(
    emit, d: int = 256, hidden: int = 512, depth: int = 4,
    buckets: Sequence[int] = (8, 32, 128), fitted=None, rows: str = "all", device=None,
) -> None:
    """The fleet-tier rows (~10 s of sustained load through a router +
    two HTTP replicas, then the tracing-overhead A/B). ``rows`` narrows
    to one row ("failover" / "trace") so that each can run in its own
    process."""
    if fitted is None:
        fitted = build_pipeline(d, hidden, depth, device=device)
    if rows in ("all", "failover"):
        bench_router_failover(emit, fitted, buckets, d, device=device)
    if rows in ("all", "trace"):
        bench_router_trace_overhead(emit, fitted, buckets, d, device=device)


def run_featurize_benches(emit, device=None) -> None:
    """The device-side featurization A/Bs: the demo conv-chain row and
    the flagship SIFT+LCS→FV row. Each row owns its pipeline shape — the
    geometry (raw uint8 bytes vs featurized float32 bytes) is what the
    H2D assertion prices."""
    bench_device_featurize(emit, device=device)
    bench_flagship_featurize(emit, device=device)


def run_zoo_benches(emit, device=None) -> None:
    """The model-zoo CSE row alone (``--zoo-only``)."""
    bench_zoo(emit, device=device)


def run_attribution_benches(emit, device=None) -> None:
    """The attribution & drift row alone (``--attribution-only``)."""
    bench_attribution_drift(emit, device=device)


def run_lifecycle_benches(emit, device=None) -> None:
    """The online-lifecycle row alone (``--lifecycle-only``)."""
    bench_online_refit(emit, device=device)


def run_shard_benches(emit, device=None) -> None:
    """The model-axis A/B alone (``--shard-only``)."""
    bench_sharded_vs_replicated(emit, device=device)


def run_chaos_benches(
    emit, d: int = 256, hidden: int = 512, depth: int = 4,
    buckets: Sequence[int] = (8, 32, 128), fitted=None, device=None,
) -> None:
    """The chaos rows alone (each a ~10 s sustained-load experiment).
    Callers that already built the bench pipeline pass it via
    ``fitted``."""
    if fitted is None:
        fitted = build_pipeline(d, hidden, depth, device=device)
    bench_chaos_lane_kill(emit, fitted, buckets, d, device=device)
    bench_chaos_prep_stall(emit, fitted, buckets, d, device=device)


def run_serving_benches(
    emit,
    d: int = 256,
    hidden: int = 512,
    depth: int = 4,
    buckets: Sequence[int] = (8, 32, 128),
    chaos: bool = False,
    cold_start: bool = True,
    fleet: bool = False,
    autoscale: bool = False,
    featurize: bool = False,
    shard: bool = False,
    zoo: bool = False,
    lifecycle: bool = False,
    attribution: bool = False,
    pipeline_overlap: bool = True,
    device=None,
) -> None:
    fitted = build_pipeline(d, hidden, depth, device=device)
    for row in (bench_cold_vs_warm, bench_bucketed_throughput, bench_microbatch,
                bench_gateway, bench_swap_blip, bench_pipeline_overlap, bench_goodput_mfu):
        if row is bench_pipeline_overlap and not pipeline_overlap:
            continue
        row(emit, fitted, buckets, d, device=device)
    if cold_start:
        # cross-process row with its own (heavier) pipeline config; the
        # children share the card with this process
        bench_cold_start_aot(emit, device=device)
    if chaos:
        run_chaos_benches(emit, d=d, hidden=hidden, depth=depth, buckets=buckets,
                          fitted=fitted, device=device)
    if fleet:
        run_fleet_benches(emit, d=d, hidden=hidden, depth=depth, buckets=buckets,
                          fitted=fitted, device=device)
    if featurize:
        run_featurize_benches(emit, device=device)
    if shard:
        run_shard_benches(emit, device=device)
    if zoo:
        run_zoo_benches(emit, device=device)
    if lifecycle:
        run_lifecycle_benches(emit, device=device)
    if attribution:
        run_attribution_benches(emit, device=device)
    if autoscale:
        # its own (smaller) pipeline: scale-up reaction time includes
        # per-replica warmup
        run_autoscale_benches(emit, device=device)


def main(argv=None, device=None) -> int:
    """``python -m keystone_tpu_torch serve-bench [--buckets 8,32,128] ...``
    on the card (``device=None``; tests pass ``"cpu"``)."""
    import argparse

    from keystone_tpu_torch import _cuda

    ap = argparse.ArgumentParser(prog="keystone_tpu_torch serve-bench", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--buckets", default="8,32,128", help="comma-separated row buckets")
    ap.add_argument("--d", type=int, default=256, help="feature dim of the bench pipeline")
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--depth", type=int, default=4,
                    help="number of matmul nodes in the bench pipeline")
    ap.add_argument("--no-cache", action="store_true",
                    help="run with NO persistence: no AOT store (the port "
                    "has no compile cache; serving_cold_vs_warm_latency "
                    "additionally detaches the store in-row)")
    ap.add_argument("--aot-cache", default=None, metavar="DIR",
                    help="AOT store dir (default: $KEYSTONE_AOT_CACHE, then "
                    "~/.cache/keystone_tpu_torch/aot). Ignored under --no-cache")
    ap.add_argument("--chaos", action="store_true",
                    help="also run the chaos rows (serving_chaos_lane_kill / "
                    "serving_chaos_prep_stall): sustained open-loop load with a "
                    "fault injected mid-run, invariant verdict asserted (~10s each)")
    ap.add_argument("--chaos-only", action="store_true", help="run ONLY the chaos rows")
    ap.add_argument("--fleet", action="store_true",
                    help="also run the fleet-tier row (serving_router_failover): "
                    "open-loop load through the router + two in-process HTTP "
                    "replicas with one black-holed mid-run, the fleet p99 read "
                    "from the router's federated /metrics (~10s)")
    ap.add_argument("--fleet-only", action="store_true",
                    help="run ONLY the fleet-tier rows (serving_router_failover + "
                    "serving_router_trace_overhead)")
    ap.add_argument("--fleet-rows", default="all", choices=("all", "failover", "trace"),
                    help="with --fleet-only: narrow to one fleet row")
    ap.add_argument("--featurize", action="store_true",
                    help="also run the device-side featurization rows "
                    "(serving_device_featurize, serving_flagship_featurize): "
                    "host_featurize vs device_featurize, asserting matching "
                    "outputs, >=3x fewer H2D bytes and device examples/sec >= host")
    ap.add_argument("--featurize-only", action="store_true",
                    help="run ONLY the device-side featurization rows")
    ap.add_argument("--zoo", action="store_true",
                    help="also run the model-zoo CSE row (serving_zoo): two "
                    "models sharing the flagship featurize prefix through one "
                    "ModelZoo vs two gateways (~60s)")
    ap.add_argument("--zoo-only", action="store_true", help="run ONLY the model-zoo CSE row")
    ap.add_argument("--lifecycle", action="store_true",
                    help="also run the online-lifecycle row (serving_online_refit): "
                    "refit -> shadow -> canary -> swap under load with zero failed "
                    "requests, then a poisoned refit rolled back (~30s)")
    ap.add_argument("--lifecycle-only", action="store_true",
                    help="run ONLY the online-lifecycle row")
    ap.add_argument("--attribution", action="store_true",
                    help="also run the attribution & drift row "
                    "(serving_attribution_drift): a two-model CSE zoo through a "
                    "mid-run size-mixture shift (~60s)")
    ap.add_argument("--attribution-only", action="store_true",
                    help="run ONLY the attribution & drift row")
    ap.add_argument("--shard", action="store_true",
                    help="also run the model-axis A/B (serving_sharded_vs_"
                    "replicated); needs >= 2 cards")
    ap.add_argument("--shard-only", action="store_true", help="run ONLY the model-axis A/B")
    ap.add_argument("--autoscale", action="store_true",
                    help="also run the elasticity row (serving_autoscale_ramp): a "
                    "step-load ramp through a live router + autoscale loop with "
                    "router.replica.partition fired mid-scale-up (~45s)")
    ap.add_argument("--autoscale-only", action="store_true",
                    help="run ONLY the elasticity row")
    ap.add_argument("--no-cold-start", action="store_true",
                    help="skip the serving_cold_start_aot row (it spawns fresh "
                    "gateway subprocesses; the in-process rows are unaffected)")
    ap.add_argument("--no-pipeline-overlap", action="store_true",
                    help="skip the serving_pipeline_overlap row (on a CUDA card its "
                    "1.2x floor is out of reach: the pipelined lane hides only the "
                    "serial lane's work beyond the prep, 1 + R/P of about 1.12x on an "
                    "H100's host; see the row's docstring)")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="wrap the whole bench run in a Kineto trace "
                    "written to DIR (a Chrome trace for Perfetto)")
    args = ap.parse_args(argv)
    if not args.no_cache:
        from keystone_tpu_torch.serving.aot import setup_aot_cache

        setup_aot_cache(args.aot_cache)
    buckets = tuple(int(b) for b in args.buckets.split(","))

    def emit(metric, value, unit, vs=None, extra=None):
        row = {
            "metric": metric,
            "value": round(value, 2) if value is not None else None,
            "unit": unit,
            "vs_baseline": round(vs, 2) if vs else None,
        }
        if extra:
            row.update(extra)
        print(json.dumps(row), flush=True)

    shape = dict(d=args.d, hidden=args.hidden, depth=args.depth, buckets=buckets, device=device)

    def run():
        if args.shard_only:
            run_shard_benches(emit, device=device)
        elif args.featurize_only:
            run_featurize_benches(emit, device=device)
        elif args.zoo_only:
            run_zoo_benches(emit, device=device)
        elif args.lifecycle_only:
            run_lifecycle_benches(emit, device=device)
        elif args.attribution_only:
            run_attribution_benches(emit, device=device)
        elif args.autoscale_only:
            run_autoscale_benches(emit, device=device)
        elif args.fleet_only:
            run_fleet_benches(emit, rows=args.fleet_rows, **shape)
        elif args.chaos_only:
            run_chaos_benches(emit, **shape)
        else:
            run_serving_benches(
                emit, chaos=args.chaos, cold_start=not args.no_cold_start,
                pipeline_overlap=not args.no_pipeline_overlap,
                fleet=args.fleet, autoscale=args.autoscale, featurize=args.featurize,
                shard=args.shard, zoo=args.zoo, lifecycle=args.lifecycle,
                attribution=args.attribution, **shape,
            )

    if args.profile_dir:
        from keystone_tpu_torch.utils.profiling import trace

        with trace(args.profile_dir):
            run()
        print(json.dumps({"profile_dir": args.profile_dir}), flush=True)
    else:
        run()
    # the hand-written kernels' launches in this process (graph replays
    # included), for a caller that checks the rows went through them
    print(json.dumps({"kernel_launches": dict(_cuda.LAUNCHES)}), flush=True)
    return 0
