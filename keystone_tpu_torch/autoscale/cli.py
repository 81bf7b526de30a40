"""``python -m keystone_tpu_torch serve-autoscale`` — the elastic fleet in
one command (counterpart of ``keystone_tpu/autoscale/cli.py``).

Stands up the whole closed loop:

1. a ``RouterServer`` in this process (the fleet front door:
   ``/predict`` routing, federated ``/metrics``, the fleet latency
   SLO at ``/slz`` — clients and the load generator point HERE);
2. a ``Supervisor`` spawning ``serve-gateway`` replicas as
   subprocesses (``--gateway-port 0`` + the ``{"listening": ...}``
   handshake, ``--register`` self-registration, a shared
   ``--aot-cache`` so scale-out replicas start warm);
3. an ``Autoscaler`` control loop: scrape the router, decide from
   fleet p99 / SLO burn / per-replica load / the phase
   decomposition, and converge the fleet — scale-out under real
   pressure, drain-based scale-down when idle, kill -9'd replicas
   replaced on the next tick.

Every decision prints as a structured JSON event line (the smoke
script parses these), exports ``keystone_autoscale_*`` series on the
router's ``/metrics``, and traces as ``autoscale.*`` spans.

With ``--plan plan.json`` (a ``serve-capacity-plan`` artifact) the
policy's per-replica capacity is MEASURED: scale-up jumps straight to
the replica count the fitted curve says the offered load needs.

The first stdout line is the machine-parseable
``{"listening": <router url>, "role": "autoscaler"}`` handshake,
same contract as serve-gateway/serve-router.
"""

from __future__ import annotations

import json
import logging
import threading
from typing import List, Optional

logger = logging.getLogger(__name__)


def build_parser():
    import argparse

    ap = argparse.ArgumentParser(
        prog="keystone_tpu_torch serve-autoscale",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--router-port", "--port", dest="port", type=int,
                    default=0, help="router bind port (0 = ephemeral)")
    ap.add_argument("--host", default="127.0.0.1")

    pol = ap.add_argument_group("policy")
    pol.add_argument("--min-replicas", type=int, default=1)
    pol.add_argument("--max-replicas", type=int, default=4)
    pol.add_argument("--slo-latency-ms", type=float, required=True,
                     help="the fleet latency objective the loop "
                     "holds (declared on the router's /slz too)")
    pol.add_argument("--slo-target", type=float, default=0.99)
    pol.add_argument("--plan", default=None, metavar="FILE",
                     help="a serve-capacity-plan artifact: fitted "
                     "per-replica capacity seeds the policy (explicit "
                     "flags here still win)")
    pol.add_argument("--interval", type=float, default=2.0,
                     help="control-loop tick seconds")
    pol.add_argument("--up-burn", type=float, default=1.5)
    pol.add_argument("--down-burn", type=float, default=0.5)
    pol.add_argument("--up-consecutive", type=int, default=2)
    pol.add_argument("--down-consecutive", type=int, default=4)
    pol.add_argument("--up-cooldown", type=float, default=15.0)
    pol.add_argument("--down-cooldown", type=float, default=30.0)
    pol.add_argument("--slo-fast-window", type=float, default=30.0,
                     help="fast burn window seconds (short for "
                     "drills, minutes in production)")
    pol.add_argument("--slo-sample-interval", type=float, default=1.0)

    gw = ap.add_argument_group("replicas")
    gw.add_argument("--d", type=int, default=64)
    gw.add_argument("--hidden", type=int, default=64)
    gw.add_argument("--depth", type=int, default=2)
    gw.add_argument("--buckets", default="4,16")
    gw.add_argument("--lanes", type=int, default=1)
    gw.add_argument("--max-delay-ms", type=float, default=2.0)
    gw.add_argument("--aot-cache", default=None, metavar="DIR",
                    help="shared AOT executable store for the "
                    "replicas (scale-out starts warm; strongly "
                    "recommended)")
    gw.add_argument("--replica-log-dir", default=None, metavar="DIR",
                    help="where replica stdout logs land (default: "
                    "$TMPDIR/keystone-autoscale)")
    gw.add_argument("--gateway-arg", action="append", default=[],
                    metavar="ARG",
                    help="extra raw argument passed to every spawned "
                    "serve-gateway (repeatable)")
    gw.add_argument("--startup-timeout", type=float, default=180.0)
    gw.add_argument("--drain-timeout", type=float, default=30.0)
    return ap


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """Run the elastic fleet until SIGTERM/SIGINT, then retire every
    replica and exit 0. ``device`` is where the replicas serve (``None``:
    their entry's default, ``cuda``; tests pass ``"cpu"``)."""
    import signal

    from keystone_tpu_torch.autoscale.controller import (
        Autoscaler,
        RouterScraper,
    )
    from keystone_tpu_torch.autoscale.policy import PolicyConfig, PolicyEngine
    from keystone_tpu_torch.autoscale.supervisor import (
        SubprocessLauncher,
        Supervisor,
    )
    from keystone_tpu_torch.fleet import RouterServer
    from keystone_tpu_torch.observability import enable_tracing

    args = build_parser().parse_args(argv)
    # the decision spans + the phase stitching the policy consumes
    # both ride the tracer
    enable_tracing()

    overrides = dict(
        min_replicas=args.min_replicas,
        max_replicas=args.max_replicas,
        slo_latency_s=args.slo_latency_ms / 1e3,
        up_burn=args.up_burn,
        down_burn=args.down_burn,
        up_consecutive=args.up_consecutive,
        down_consecutive=args.down_consecutive,
        up_cooldown_s=args.up_cooldown,
        down_cooldown_s=args.down_cooldown,
    )
    if args.plan:
        config = PolicyConfig.from_plan(args.plan, **overrides)
    else:
        config = PolicyConfig(**overrides)

    router = RouterServer(
        port=args.port,
        host=args.host,
        name="autoscaler",
        probe_interval_s=min(1.0, args.interval),
        slo_latency_s=args.slo_latency_ms / 1e3,
        slo_target=args.slo_target,
        slo_fast_window_s=args.slo_fast_window,
        slo_slow_window_s=max(
            args.slo_fast_window * 10, args.slo_fast_window + 1.0
        ),
        slo_sample_interval_s=args.slo_sample_interval,
    ).start()

    gw_args = [
        "--d", str(args.d), "--hidden", str(args.hidden),
        "--depth", str(args.depth), "--buckets", args.buckets,
        "--lanes", str(args.lanes),
        "--max-delay-ms", str(args.max_delay_ms),
        # replicas adopt the router's traceparent so the phase
        # decomposition the policy reads has both halves to stitch
        "--trace",
        *args.gateway_arg,
    ]
    if args.aot_cache:
        gw_args += ["--aot-cache", args.aot_cache]

    def emit_event(doc):
        print(json.dumps(doc), flush=True)

    supervisor = Supervisor(
        SubprocessLauncher(
            router.url(), gw_args, log_dir=args.replica_log_dir,
            device=None if device is None else str(device),
        ),
        router.url(),
        startup_timeout_s=args.startup_timeout,
        drain_timeout_s=args.drain_timeout,
        on_event=emit_event,
    )
    autoscaler = Autoscaler(
        supervisor,
        RouterScraper(
            router.url(), p99_window_s=args.slo_fast_window
        ),
        PolicyEngine(config),
        interval_s=args.interval,
        name="autoscaler",
        on_event=emit_event,
    )

    # the machine-parseable handshake FIRST (smoke scripts read it),
    # then the human summary
    print(
        json.dumps(
            {
                "listening": router.url().rstrip("/"),
                "role": "autoscaler",
                "min_replicas": config.min_replicas,
                "max_replicas": config.max_replicas,
            }
        ),
        flush=True,
    )
    print(
        f"autoscaler: router {router.url()} — POST /predict, "
        f"GET /fleetz /metrics /slz; policy "
        f"[{config.min_replicas}..{config.max_replicas}] replicas, "
        f"SLO p99 <= {args.slo_latency_ms:g}ms"
        + (f", plan {args.plan}" if args.plan else ""),
        flush=True,
    )

    # signal handlers BEFORE the initial scale-up: the first replica
    # cold start can take minutes, and a SIGTERM landing inside it
    # must still reach the graceful path below — the default
    # disposition would kill this process and leak the half-started
    # serve-gateway child
    stop = threading.Event()

    def handle(signum, frame):
        logger.info("autoscaler: signal %d, stopping", signum)
        stop.set()

    signal.signal(signal.SIGTERM, handle)
    signal.signal(signal.SIGINT, handle)

    try:
        supervisor.scale_to(config.min_replicas)
        autoscaler.start()
        while not stop.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        # on a signal and on a failure alike: no replica outlives this
        # process (each holds a CUDA context on the card)
        autoscaler.stop()
        supervisor.stop()  # drain-based retirement of every replica
        router.stop()
    return 0


__all__ = ["build_parser", "main"]
