"""Single CLI entry: ``python -m keystone_tpu_torch <AppName> [app args...]``
(counterpart of ``keystone_tpu/__main__.py``).

Reference: bin/run-pipeline.sh selects the pipeline class by fully
qualified name as argv[1]; here short app names map to the app modules'
``main``, which run on ``cuda`` (StupidBackoffPipeline is host work).
The request plane — the ``--admin-port``, ``--otlp-endpoint`` and
``--gateway-port`` flags and the ``serve-*``, ``bench-diff`` and
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

# the JAX package's request-plane flags and subcommands
PLANE_FLAGS = ("--admin-port", "--otlp-endpoint", "--otlp-service", "--otlp-replica",
               "--gateway-port")
PLANE_APPS = ("serve-bench", "serve-gateway", "serve-router", "serve-loadgen",
              "serve-autoscale", "serve-capacity-plan", "serve-lifecycle",
              "serve-aot-build", "bench-diff", "keystone-lint")


def _not_ported(what: str) -> int:
    print(f"{what} is not ported yet: keystone_tpu_torch runs the apps only "
          "(the request plane is the JAX package's)")
    return 2


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    for flag in PLANE_FLAGS:
        if flag in argv:
            return _not_ported(flag)
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
              "<AppName> [app args...]")
        print("apps:")
        for name in sorted(APPS):
            print(f"  {name}")
        print("not ported yet: " + ", ".join(PLANE_APPS + PLANE_FLAGS))
        return 0 if argv else 2
    app = argv[0]
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
