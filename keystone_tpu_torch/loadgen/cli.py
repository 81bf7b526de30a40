"""``python -m keystone_tpu_torch serve-loadgen`` — the experiment driver
(counterpart of ``keystone_tpu/loadgen/cli.py``, every flag of it).

Replays a workload (recorded ``--trace`` JSONL or ``--synthetic``)
open-loop against a gateway (``--target URL``, or ``--self-gateway``
to stand one up in-process over the demo model on the card), optionally arms
a chaos timeline mid-run (``--fault``, armed over ``POST /chaosz``
for HTTP targets so the fault fires in the SERVER process), runs the
invariant checker over the result, prints the structured verdict, and
exits nonzero when the verdict is red.

``--target`` takes a fleet ROUTER's URL just as well as a single
gateway's: the router serves the same ``/predict`` / ``/readyz`` /
``/chaosz`` surface, so cross-host drills (kill a replica process
mid-load, black-hole one replica's responses via
``router.replica.blackhole``) run through the identical harness.

Examples::

    # replay a recorded trace at 4x against a live gateway
    python -m keystone_tpu_torch serve-loadgen --target http://127.0.0.1:8000 \\
        --trace requests.jsonl --speed 4

    # synthetic heavy-tail load with a lane killed mid-run, verdict
    # must be green
    python -m keystone_tpu_torch serve-loadgen --target http://127.0.0.1:8000 \\
        --synthetic 400 --arrivals lognormal --rate 80 \\
        --fault 'gateway.lane.kill=lane:0' --fault-at 1.5 --fault-for 1.5

    # no server handy: drive an in-process gateway on the card
    python -m keystone_tpu_torch serve-loadgen --self-gateway --synthetic 200
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np

from keystone_tpu_torch.loadgen import faults as faults_mod
from keystone_tpu_torch.loadgen import trace as trace_mod
from keystone_tpu_torch.loadgen.invariants import (
    InvariantChecker,
    InvariantResult,
)
from keystone_tpu_torch.loadgen.runner import (
    FaultPlan,
    FeedbackSender,
    HttpTarget,
    InprocTarget,
    LoadGenerator,
)


def _parse_teacher(spec: str) -> dict:
    """``hidden=H,depth=N[,seed=S][,head_seed=S2]`` -> kwargs for
    ``lifecycle/teacher.teacher_labels`` (all integers)."""
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, _, value = part.partition("=")
        key = key.strip()
        if key not in ("hidden", "depth", "seed", "head_seed"):
            raise SystemExit(
                f"--teacher: unknown key {key!r} (want hidden/depth/"
                "seed/head_seed)"
            )
        try:
            out[key] = int(value)
        except ValueError:
            raise SystemExit(f"--teacher: {key} wants an integer")
    if "hidden" not in out or "depth" not in out:
        raise SystemExit("--teacher needs at least hidden=H,depth=N")
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="keystone_tpu_torch serve-loadgen",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    tgt = ap.add_argument_group("target")
    tgt.add_argument("--target", default=None, metavar="URL",
                     help="base URL of a running gateway frontend")
    tgt.add_argument("--self-gateway", action="store_true",
                     help="stand up an in-process gateway over the "
                     "demo model (on cuda) instead of --target")
    tgt.add_argument("--d", type=int, default=64,
                     help="feature dim of the --self-gateway pipeline "
                     "(and the default replay example shape)")
    tgt.add_argument("--lanes", type=int, default=2)
    tgt.add_argument("--buckets", default="4,16")
    tgt.add_argument("--payload-dtype", choices=("float32", "uint8"),
                     default="float32",
                     help="instances' dtype against --target: float32 "
                     "normals (the default), or uint8 bytes, the raw "
                     "images a --device-featurize gateway takes (a flag "
                     "of the port)")
    tgt.add_argument("--payload-shape", default=None, metavar="D,...",
                     help="one instance's shape against --target, e.g. "
                     "256,256,3 (default: (--d,); a flag of the port)")

    wl = ap.add_argument_group("workload")
    wl.add_argument("--trace", default=None, metavar="FILE",
                    help="replay this --request-log JSONL recording")
    wl.add_argument("--no-collapse", action="store_true",
                    help="replay one request per recorded line instead "
                    "of collapsing per-instance lines back into their "
                    "originating POSTs")
    wl.add_argument("--synthetic", type=int, default=None, metavar="N",
                    help="synthesize N requests instead of --trace")
    wl.add_argument("--ramp", default=None, metavar="RATE:DUR,...",
                    help="synthesize a STEP/RAMP offered-load shape "
                    "instead of --trace/--synthetic: comma-separated "
                    "rate:duration_s steps (e.g. '5:4,40:8,5:6' = 4s "
                    "at 5 rps, an 8s surge at 40 rps, 6s back at 5) "
                    "— the deterministic load staircase the "
                    "autoscale/capacity drills use; --arrivals names "
                    "the within-step process")
    wl.add_argument("--arrivals", default="poisson",
                    choices=trace_mod.ARRIVALS)
    wl.add_argument("--rate", type=float, default=100.0,
                    help="mean arrival rate, requests/sec")
    wl.add_argument("--sigma", type=float, default=1.0,
                    help="lognormal arrival shape")
    wl.add_argument("--alpha", type=float, default=1.5,
                    help="pareto arrival tail index (> 1)")
    wl.add_argument("--size-mix", default="1:1.0", metavar="R:W,...",
                    help="instance-count mixture, e.g. 1:0.8,4:0.2 — "
                    "replaying a SHIFTED mixture against a planned "
                    "--zoo gateway is the drift-detector drill: "
                    "keystone_drift_score rises and /driftz ships a "
                    "re-plan recommendation")
    wl.add_argument("--deadline-ms", type=float, default=None)
    wl.add_argument("--deadline-sigma", type=float, default=0.0,
                    help="lognormal jitter on --deadline-ms")
    wl.add_argument("--seed", type=int, default=0)
    wl.add_argument("--speed", type=float, default=1.0,
                    help="replay speed factor (2 = twice as fast)")
    wl.add_argument("--settle-s", type=float, default=0.0,
                    help="keep the run open this long past the last "
                    "arrival (lets post-fault recovery be measured)")
    wl.add_argument("--max-outstanding", type=int, default=128)

    fb = ap.add_argument_group("lifecycle feedback")
    fb.add_argument("--feedback-fraction", type=float, default=0.0,
                    metavar="F",
                    help="also label this deterministic fraction of "
                    "issued payloads with the --teacher model and "
                    "POST them to the gateway's /feedback (the "
                    "online-lifecycle label stream; off the load "
                    "path, bounded queue, drop-newest). Needs "
                    "--target and --teacher")
    fb.add_argument("--teacher", default=None,
                    metavar="hidden=H,depth=N[,seed=S][,head_seed=S2]",
                    help="synthetic ground truth for --feedback-"
                    "fraction: lifecycle/teacher.teacher_labels over "
                    "the --d input shape — the demo pipeline's exact "
                    "forward math; head_seed redraws the final layer "
                    "so the served model is a STALE teacher the "
                    "streaming refit must catch up to")

    ch = ap.add_argument_group("chaos")
    ch.add_argument("--fault", action="append", default=[],
                    metavar="POINT[=k:v,...]",
                    help="arm this fault point mid-run (same grammar "
                    "as KEYSTONE_FAULTS; repeatable, paired "
                    "positionally with --fault-at/--fault-for)")
    ch.add_argument("--fault-at", action="append", type=float,
                    default=[], metavar="T",
                    help="seconds into the run to arm the matching "
                    "--fault (default 0)")
    ch.add_argument("--fault-for", action="append", type=float,
                    default=[], metavar="S",
                    help="clear the matching --fault after S seconds "
                    "(default: stays armed until the run ends)")

    inv = ap.add_argument_group("invariants")
    inv.add_argument("--p99-factor", type=float, default=1.5,
                     help="post-fault p99 must recover to within this "
                     "factor of the pre-fault p99")
    inv.add_argument("--recovery-s", type=float, default=10.0,
                     help="seconds after the fault clears within which "
                     "p99 (and readiness) must recover")
    inv.add_argument("--max-shed-rate", type=float, default=None)
    inv.add_argument("--max-p99-ms", type=float, default=None)

    out = ap.add_argument_group("output")
    out.add_argument("--report", default=None, metavar="FILE",
                     help="also write the JSON verdict here")
    out.add_argument("--no-verdict", action="store_true",
                     help="replay only; skip invariant checking (exit "
                     "0 regardless)")
    return ap


def build_workload(args) -> List[trace_mod.TraceEvent]:
    """One workload builder for every replaying CLI (``serve-loadgen``,
    and the JAX package's ``serve-capacity-plan`` once ported): exactly
    one of ``--trace FILE``,
    ``--synthetic N``, or ``--ramp RATE:DUR,...`` becomes the event
    list. Reads optional shaping flags (``sigma``/``alpha``/
    ``deadline_sigma``/``no_collapse``) off the namespace when the
    caller's parser defines them, library defaults otherwise — so the
    two CLIs can't drift apart on what a workload spec means."""
    trace = getattr(args, "trace", None)
    synthetic = getattr(args, "synthetic", None)
    ramp = getattr(args, "ramp", None)
    chosen = sum(x is not None for x in (trace, synthetic, ramp))
    if chosen != 1:
        raise SystemExit(
            "pass exactly one of --trace FILE, --synthetic N, or "
            "--ramp RATE:DUR,..."
        )
    if trace is not None:
        events = trace_mod.load_trace(
            trace, collapse=not getattr(args, "no_collapse", False)
        )
        if not events:
            raise SystemExit(
                f"--trace {trace}: no replayable records found"
            )
        return events
    shaping = dict(
        arrivals=args.arrivals,
        sigma=getattr(args, "sigma", 1.0),
        alpha=getattr(args, "alpha", 1.5),
        size_mix=trace_mod.parse_size_mix(args.size_mix),
        shape=_payload_shape(args),
        deadline_ms=args.deadline_ms,
        deadline_sigma=getattr(args, "deadline_sigma", 0.0),
        seed=args.seed,
    )
    if ramp is not None:
        return trace_mod.synthesize_steps(
            trace_mod.parse_steps(ramp), **shaping
        )
    return trace_mod.synthesize(synthetic, rate=args.rate, **shaping)


# the historical private name (serve-loadgen's own entry point)
_build_events = build_workload


def _payload_shape(args) -> tuple:
    """One instance's shape: ``--payload-shape``, else ``(--d,)``."""
    spec = getattr(args, "payload_shape", None)
    return tuple(int(n) for n in spec.split(",")) if spec else (args.d,)


def _build_fault_plans(args) -> List[FaultPlan]:
    plans = []
    for i, clause in enumerate(args.fault):
        spec = faults_mod.parse_fault_spec(clause)
        at = args.fault_at[i] if i < len(args.fault_at) else 0.0
        dur = args.fault_for[i] if i < len(args.fault_for) else None
        plans.append(FaultPlan(spec=spec, at_s=at, for_s=dur))
    return plans


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """Run one experiment; 0 on a green verdict (or ``--no-verdict``),
    1 on a red one. ``device`` is where ``--self-gateway`` serves
    (``None`` means ``cuda``, which raises when it is missing; tests pass
    ``device="cpu"``)."""
    args = build_parser().parse_args(argv)
    events = _build_events(args)
    print(
        json.dumps({"workload": trace_mod.summarize(events)}),
        flush=True,
    )

    gateway = None
    if args.self_gateway:
        import torch

        from keystone_tpu_torch.gateway import Gateway
        from keystone_tpu_torch.serving.bench import build_pipeline

        fitted = build_pipeline(d=args.d, hidden=args.d, depth=2, device=device)
        gateway = Gateway(
            fitted,
            buckets=tuple(int(b) for b in args.buckets.split(",")),
            n_lanes=args.lanes,
            warmup_example=torch.zeros((args.d,), dtype=torch.float32),
            device=device,
            name="loadgen",
        )
        target = InprocTarget(gateway, default_shape=(args.d,))
    elif args.target:
        target = HttpTarget(args.target, default_shape=_payload_shape(args),
                            dtype=np.dtype(args.payload_dtype))
    else:
        raise SystemExit("pass --target URL or --self-gateway")
    feedback = None
    if args.feedback_fraction > 0.0:
        if not args.target:
            raise SystemExit(
                "--feedback-fraction needs --target URL (the "
                "/feedback route lives on the HTTP frontend)"
            )
        if not args.teacher:
            raise SystemExit(
                "--feedback-fraction needs --teacher "
                "hidden=H,depth=N[,seed=S][,head_seed=S2]"
            )
        from keystone_tpu_torch.lifecycle.teacher import teacher_labels

        teacher_kw = _parse_teacher(args.teacher)
        d = args.d
        feedback = FeedbackSender(
            args.target,
            lambda xs: teacher_labels(xs, d, **teacher_kw),
            fraction=args.feedback_fraction,
        )
        target.feedback = feedback
    # env-armed faults (KEYSTONE_FAULTS) arm AFTER the gateway exists:
    # trigger points disarm instantly when nothing has registered for
    # them, so arming earlier would silently no-op gateway.swap.force
    faults_mod.arm_from_env()

    plans = _build_fault_plans(args)
    settle = args.settle_s
    if plans and settle == 0.0:
        # recovery can only be asserted on traffic that ARRIVES after
        # the fault clears; warn rather than silently under-measure
        print(
            json.dumps({
                "note": "faults armed with --settle-s 0; if the trace "
                "ends before the fault clears, recovery has no "
                "traffic to measure"
            }),
            flush=True,
        )
    gen = LoadGenerator(target, max_outstanding=args.max_outstanding)
    # snapshot lifetime fire counts so a green verdict can never mean
    # "the fault silently failed to arm/fire and nothing was tested"
    fault_points = sorted({p.spec["point"] for p in plans})
    fired_before = {p: target.fired_count(p) for p in fault_points}
    try:
        report = gen.run(
            events,
            speed=args.speed,
            faults=plans,
            recovery_probe_s=args.recovery_s,
            settle_s=settle,
        )
        fired_after = {p: target.fired_count(p) for p in fault_points}
    finally:
        if feedback is not None:
            # flush BEFORE any verdict: the lifecycle drill's asserts
            # read these counts off this one JSON line
            print(
                json.dumps({"feedback": feedback.close()}), flush=True
            )
        if gateway is not None:
            gateway.close()

    if args.no_verdict:
        print(json.dumps({"stats": report.stats()}, indent=1))
        return 0
    checker = InvariantChecker(
        p99_factor=args.p99_factor,
        recovery_within_s=args.recovery_s,
        max_shed_rate=args.max_shed_rate,
        max_p99_s=(
            args.max_p99_ms / 1e3 if args.max_p99_ms is not None else None
        ),
    )
    verdict = checker.check(report)
    for point in fault_points:
        before, after = fired_before[point], fired_after[point]
        fired = (
            None if before is None or after is None else after - before
        )
        ok = fired is None or fired > 0
        verdict.invariants.append(InvariantResult(
            "requested_fault_actually_fired", ok,
            f"{point}: "
            + (f"{fired} injection(s)" if fired is not None
               else "fire count unavailable (taken on trust)"),
        ))
        if not ok:
            # an unfired fault means the run proved nothing — red
            verdict.passed = False
        verdict.stats.setdefault("injections", {})[point] = fired
    doc = verdict.to_json(indent=1)
    print(doc, flush=True)
    if not verdict.passed and args.target:
        # a red verdict names its exemplar requests; print each known
        # trace id as a ready-to-curl /debugz URL — against a fleet
        # router that is the STITCHED cross-process tree with the
        # phase decomposition, against a lone gateway the flight
        # record / live span tree
        _print_forensic_urls(
            args.target, verdict.stats.get("exemplars") or {}
        )
    if args.report:
        with open(args.report, "w", encoding="utf-8") as f:
            f.write(doc + "\n")
    return 0 if verdict.passed else 1


def _print_forensic_urls(base_url: str, exemplars: dict) -> None:
    base = base_url.rstrip("/")
    entries = []
    worst = exemplars.get("worst_latency")
    if worst is not None:
        entries.append(("worst-latency", worst))
    entries.extend(("lost", e) for e in exemplars.get("lost", ()))
    entries.extend(("untyped", e) for e in exemplars.get("untyped", ()))
    seen = set()
    for kind, e in entries:
        tid = e.get("trace_id")
        label = f"{kind} (request #{e.get('index')})"
        if not tid:
            print(
                f"forensics: {label}: no trace id "
                "(no response reached the client)",
                flush=True,
            )
            continue
        if tid in seen:
            continue
        seen.add(tid)
        print(
            f"forensics: {label}: "
            f"curl '{base}/debugz?trace_id={tid}'",
            flush=True,
        )


if __name__ == "__main__":
    sys.exit(main())
