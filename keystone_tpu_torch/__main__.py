"""Single CLI entry: ``python -m keystone_tpu_torch <AppName> [app args...]``
(counterpart of ``keystone_tpu/__main__.py``).

Reference: bin/run-pipeline.sh selects the pipeline class by fully
qualified name as argv[1]; here short app names map to the app modules'
``main``, which run on ``cuda`` (StupidBackoffPipeline is host work).
``torchrun --nproc-per-node N -m keystone_tpu_torch <App>`` (or JAX's
COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID) runs an app as one
process per card, joined before the app is imported
(``parallel/runtime.py``).

The request plane's front door, fleet tier, load generator and online
lifecycle are ported: ``--admin-port N`` (the observability endpoint),
``--otlp-endpoint URL`` with ``--otlp-service`` and ``--otlp-replica``
(OTLP/HTTP span export), ``--gateway-port N`` and ``serve-gateway`` (the
HTTP gateway over the demo model, with ``--refit`` its online lifecycle,
over the flagship's CUDA-graph engines with ``--device-featurize
flagship``, or over a model zoo with ``--zoo``;
``keystone_tpu_torch/gateway/http.py``), ``serve-router`` (the fleet
router over ``serve-gateway`` replicas, host-only;
``keystone_tpu_torch/fleet/router.py``), ``serve-loadgen`` (open-loop
replay, chaos and the invariant verdict; ``loadgen/cli.py``) and
``serve-lifecycle`` (status, tick and rollback over HTTP, stdlib only;
``lifecycle/cli.py``), ``serve-aot-build`` (fill the AOT store;
``serving/aot.py``), ``serve-autoscale`` (router, supervised
``serve-gateway`` replicas and the autoscale loop; ``autoscale/cli.py``)
and ``serve-capacity-plan`` (``autoscale/planner.py``) and ``serve-bench``
(the serving benchmark rows, one JSON line each; ``serving/bench.py``).
The tools ``keystone-lint`` (``analysis/``) and ``bench-diff``
(``bench_diff.py``) are stdlib only and load no torch.
"""

from __future__ import annotations

import importlib
import sys

APPS = {
    "MnistRandomFFT": "keystone_tpu_torch.pipelines.images.mnist_random_fft",
    "RandomPatchCifar": "keystone_tpu_torch.pipelines.images.random_patch_cifar",
    "ImageNetSiftLcsFV": "keystone_tpu_torch.pipelines.images.imagenet_sift_lcs_fv",
    "VOCSIFTFisher": "keystone_tpu_torch.pipelines.images.voc_sift_fisher",
    "TimitPipeline": "keystone_tpu_torch.pipelines.speech.timit",
    "NewsgroupsPipeline": "keystone_tpu_torch.pipelines.text.newsgroups",
    "AmazonReviewsPipeline": "keystone_tpu_torch.pipelines.text.amazon_reviews",
    "StupidBackoffPipeline": "keystone_tpu_torch.pipelines.nlp.stupid_backoff_pipeline",
}

def _otlp(argv) -> int:
    """Peel ``--otlp-endpoint URL`` (and ``--otlp-service``,
    ``--otlp-replica``) off ``argv`` and install an OTLP/HTTP span
    exporter over the global tracer (tracing on). Returns 0, or 2 for a
    malformed flag."""
    i = argv.index("--otlp-endpoint")
    try:
        endpoint = argv[i + 1]
        if endpoint.startswith("-"):
            raise ValueError(endpoint)
    except (IndexError, ValueError):
        print("--otlp-endpoint requires a collector URL "
              "(e.g. http://127.0.0.1:4318)")
        return 2
    del argv[i : i + 2]

    def peel_value(flag, default):
        if flag not in argv:
            return default
        j = argv.index(flag)
        try:
            value = argv[j + 1]
            if value.startswith("-"):
                raise ValueError(value)
        except (IndexError, ValueError):
            raise SystemExit(f"{flag} requires a value") from None
        del argv[j : j + 2]
        return value

    import os
    import socket

    # resource identity: which SERVICE (router vs gateway vs app) and
    # which REPLICA this process is, so that a collector lays the fleet's
    # halves of one trace out as the router's stitched /debugz does
    default_service = (
        f"keystone-{argv[0].removeprefix('serve-')}"
        if argv and not argv[0].startswith("-")
        else "keystone-tpu"
    )
    service = peel_value("--otlp-service", default_service)
    replica = peel_value("--otlp-replica", f"{socket.gethostname()}:{os.getpid()}")
    from keystone_tpu_torch.observability import OtlpSpanExporter, enable_tracing

    enable_tracing()
    exporter = OtlpSpanExporter(
        endpoint, service_name=service, resource_attrs={"replica": replica}
    )
    exporter.install()
    print(f"otlp export: {exporter.endpoint} "
          f"(service.name={service} replica={replica})", flush=True)
    return 0


def main(argv=None, device=None) -> int:
    """Run ``argv``'s app. ``device`` goes to ``serve-gateway``,
    ``serve-loadgen``, ``serve-aot-build``, ``serve-capacity-plan``,
    ``serve-bench`` and ``serve-autoscale``'s replicas, and picks the
    backend of an app's process group (``runtime.initialize``: NCCL on
    ``cuda``, gloo on ``"cpu"``) (``None`` means ``cuda``; rehearsals on
    the CPU pass ``"cpu"``)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--admin-port" in argv:
        # observability plane: /metrics, /varz, /healthz, /tracez, /slz,
        # /debugz and /profilez on a background thread, span tracing on.
        # Peeled before app dispatch so every app is scrapeable.
        i = argv.index("--admin-port")
        try:
            port = int(argv[i + 1])
        except (IndexError, ValueError):
            print("--admin-port requires an integer port (0 = ephemeral)")
            return 2
        del argv[i : i + 2]
        from keystone_tpu_torch.observability import enable_tracing, start_admin_server

        enable_tracing()
        server = start_admin_server(port=port)
        print(f"admin endpoint: {server.url()} "
              "(/metrics /varz /healthz /tracez /profilez)", flush=True)
    if "--otlp-endpoint" in argv:
        # OTLP/HTTP span export on a background thread (stdlib urllib);
        # peeled before app dispatch like --admin-port
        rc = _otlp(argv)
        if rc:
            return rc
    gateway_port = None
    if "--gateway-port" in argv:
        # request plane: `python -m keystone_tpu_torch --gateway-port N`
        # alone stands up the serve-gateway demo; with an explicit
        # serve-gateway app the port rides along
        i = argv.index("--gateway-port")
        try:
            gateway_port = int(argv[i + 1])
        except (IndexError, ValueError):
            print("--gateway-port requires an integer port (0 = ephemeral)")
            return 2
        del argv[i : i + 2]
        if not argv or argv[0].startswith("-"):
            # no app named: everything left is serve-gateway options
            argv = ["serve-gateway"] + argv
        if argv[0] != "serve-gateway":
            print("--gateway-port only applies to the serve-gateway app")
            return 2
    if "--debug-optimizer" in argv:
        # per-rule optimizer trace, as the JAX package's flag gives it
        argv.remove("--debug-optimizer")
        import logging

        logging.basicConfig()
        for mod in ("keystone_tpu_torch.workflow.rules",
                    "keystone_tpu_torch.workflow.auto_cache"):
            logging.getLogger(mod).setLevel(logging.DEBUG)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m keystone_tpu_torch [--debug-optimizer] "
              "[--admin-port N] [--otlp-endpoint URL [--otlp-service S] "
              "[--otlp-replica R]] [--gateway-port N] <AppName> [app args...]")
        print("apps:")
        for name in sorted(APPS):
            print(f"  {name}")
        print("  serve-gateway  (HTTP request plane over the demo model, "
              "with --device-featurize flagship over the flagship's CUDA-graph "
              "engines, or with --zoo over a model zoo; --register ROUTER_URL "
              "joins a fleet; keystone_tpu_torch/gateway/)")
        print("  serve-router   (the fleet router over serve-gateway replicas: "
              "least-loaded routing with retry, /fleetz, federated /metrics, "
              "stitched /debugz; keystone_tpu_torch/fleet/)")
        print("  serve-loadgen  (open-loop trace replay or synthetic arrivals "
              "against a gateway, chaos timelines, the invariant verdict; "
              "keystone_tpu_torch/loadgen/)")
        print("  serve-lifecycle (status, tick or rollback of a serve-gateway "
              "--refit lifecycle over HTTP; keystone_tpu_torch/lifecycle/)")
        print("  serve-aot-build  (fill the AOT store: kernel libraries and "
              "each bucket's entry; keystone_tpu_torch/serving/aot.py)")
        print("  serve-autoscale  (a router, supervised serve-gateway replicas "
              "and the autoscale loop; keystone_tpu_torch/autoscale/)")
        print("  serve-capacity-plan  (replay a workload against 1..K replicas, "
              "fit per-replica capacity, write the plan serve-autoscale --plan "
              "loads)")
        print("  keystone-lint  (the port's contract lint over keystone_tpu_torch/; "
              "--json, --list-rules; keystone_tpu_torch/analysis/)")
        print("  serve-bench    (the serving benchmark rows, one JSON line each: "
              "engine, batcher, gateway, featurize, chaos, fleet, zoo, lifecycle, "
              "cold start, autoscale; keystone_tpu_torch/serving/bench.py)")
        print("  bench-diff     (compare two bench rounds' rows, exit 1 on a "
              "regression; keystone_tpu_torch/bench_diff.py)")
        print("options:")
        print("  --gateway-port N shorthand for `serve-gateway --gateway-port N` "
              "(N=0 picks an ephemeral port)")
        print("  --admin-port N   serve /metrics /varz /healthz /tracez /slz "
              "/debugz /profilez on http://127.0.0.1:N (N=0: ephemeral)")
        print("  --otlp-endpoint URL  export finished spans to an OTLP/HTTP "
              "collector's /v1/traces (--otlp-service and --otlp-replica name "
              "the process)")
        return 0 if argv else 2
    app = argv[0]
    if app == "serve-gateway":
        from keystone_tpu_torch.gateway.http import main as serve_gateway_main

        rest = argv[1:]
        if gateway_port is not None:
            rest = ["--gateway-port", str(gateway_port)] + rest
        return serve_gateway_main(rest, device=device)
    if app == "serve-router":
        from keystone_tpu_torch.fleet.router import main as serve_router_main

        return serve_router_main(argv[1:])
    if app == "serve-loadgen":
        from keystone_tpu_torch.loadgen.cli import main as serve_loadgen_main

        return serve_loadgen_main(argv[1:], device=device)
    if app == "serve-lifecycle":
        # stdlib-only HTTP client: no torch import for operator controls
        from keystone_tpu_torch.lifecycle.cli import main as lifecycle_main

        return lifecycle_main(argv[1:])
    if app == "serve-aot-build":
        from keystone_tpu_torch.serving.aot import build_main

        return build_main(argv[1:], device=device)
    if app == "serve-autoscale":
        from keystone_tpu_torch.autoscale.cli import main as autoscale_main

        return autoscale_main(argv[1:], device=device)
    if app == "serve-capacity-plan":
        from keystone_tpu_torch.autoscale.planner import main as plan_main

        return plan_main(argv[1:], device=device)
    if app == "serve-bench":
        from keystone_tpu_torch.serving.bench import main as serve_bench_main

        return serve_bench_main(argv[1:], device=device)
    if app == "bench-diff":
        # stdlib-only like the linter: regression gating runs in CI
        # hooks without paying the torch import
        from keystone_tpu_torch.bench_diff import main as bench_diff_main

        return bench_diff_main(argv[1:])
    if app == "keystone-lint":
        # stdlib-only path by design: the linter must run in hooks and
        # CI without paying the torch import (analysis/ never imports it)
        from keystone_tpu_torch.analysis.cli import main as lint_main

        return lint_main(argv[1:])
    if app not in APPS:
        print(f"unknown app {app!r}; run with --help for the list")
        return 2
    # join the process group when launched as one process per card
    # (torchrun, or JAX's COORDINATOR_ADDRESS / NUM_PROCESSES /
    # PROCESS_ID); one process otherwise (parallel/runtime.py)
    from keystone_tpu_torch.parallel.runtime import initialize

    initialize(device=device)
    module = importlib.import_module(APPS[app])
    return module.main(argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
