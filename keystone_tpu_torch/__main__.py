"""Single CLI entry: ``python -m keystone_tpu_torch <AppName> [app args...]``
(counterpart of ``keystone_tpu/__main__.py``).

Reference: bin/run-pipeline.sh selects the pipeline class by fully
qualified name as argv[1]; here short app names map to the app modules'
``main``, which run on ``cuda`` (StupidBackoffPipeline is host work).

The request plane's front door is ported: ``--admin-port N`` (the
observability endpoint), ``--gateway-port N`` and ``serve-gateway`` (the
HTTP gateway over the demo model or, with ``--device-featurize
flagship``, over the flagship's CUDA-graph engines;
``keystone_tpu_torch/gateway/http.py``). The rest of the plane — the
``--otlp-*`` flags and the other ``serve-*``, ``bench-diff`` and
``keystone-lint`` subcommands — is not ported yet: given one, the entry
says so and exits 2.
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

# the JAX package's request-plane flags and subcommands not ported yet
PLANE_FLAGS = ("--otlp-endpoint", "--otlp-service", "--otlp-replica")
PLANE_APPS = ("serve-bench", "serve-router", "serve-loadgen",
              "serve-autoscale", "serve-capacity-plan", "serve-lifecycle",
              "serve-aot-build", "bench-diff", "keystone-lint")


def _not_ported(what: str) -> int:
    print(f"{what} is not ported yet: keystone_tpu_torch runs the apps, "
          "serve-gateway and the admin endpoint")
    return 2


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    for flag in PLANE_FLAGS:
        if flag in argv:
            return _not_ported(flag)
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
              "[--admin-port N] [--gateway-port N] <AppName> [app args...]")
        print("apps:")
        for name in sorted(APPS):
            print(f"  {name}")
        print("  serve-gateway  (HTTP request plane over the demo model, or "
              "with --device-featurize flagship over the flagship's CUDA-graph "
              "engines; keystone_tpu_torch/gateway/)")
        print("options:")
        print("  --gateway-port N shorthand for `serve-gateway --gateway-port N` "
              "(N=0 picks an ephemeral port)")
        print("  --admin-port N   serve /metrics /varz /healthz /tracez /slz "
              "/debugz /profilez on http://127.0.0.1:N (N=0: ephemeral)")
        print("not ported yet: " + ", ".join(PLANE_APPS + PLANE_FLAGS))
        return 0 if argv else 2
    app = argv[0]
    if app == "serve-gateway":
        from keystone_tpu_torch.gateway.http import main as serve_gateway_main

        rest = argv[1:]
        if gateway_port is not None:
            rest = ["--gateway-port", str(gateway_port)] + rest
        return serve_gateway_main(rest)
    if app in PLANE_APPS:
        return _not_ported(app)
    if app not in APPS:
        print(f"unknown app {app!r}; run with --help for the list")
        return 2
    # the JAX package joins its multi-host runtime here; one card has none
    module = importlib.import_module(APPS[app])
    return module.main(argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
