"""Capacity planning: replay the recorded peak, fit the curve, derive
the policy (counterpart of ``keystone_tpu/autoscale/planner.py``).

``serve-capacity-plan`` answers the question the reactive loop can't:
*how many replicas does a given offered load actually need?* It
replays a workload (a recorded ``--request-log`` trace or a synthetic
spec) through a real router at ×1..×N speed against 1..K supervised
replicas — the same open-loop discipline as ``serve-loadgen``, so
overload actually overloads — and records, per (replicas, speed)
cell: offered rate, achieved p99, shed rate, and whether the SLO
held. From the grid it derives:

- ``capacity(k)`` — the highest offered rate at which ``k`` replicas
  held the SLO (p99 under threshold, sheds under the tolerance);
- a least-squares-through-origin fit ``capacity(k) ≈ per_replica_rps
  × k`` — the replicas-vs-offered-load curve;
- the policy block a ``PolicyConfig.from_plan`` consumes
  (``per_replica_rps``, ``target_utilization``, the SLO) — so the
  autoscaler's thresholds are measured, not guessed.

The artifact is one JSON file (``--out``); the control loop loads it
with ``serve-autoscale --plan plan.json``.

Replicas come from the same ``Supervisor`` the autoscaler uses:
``--mode subprocess`` spawns real ``serve-gateway`` processes (share
an AOT store to keep the K legs warm); the default ``--mode inproc``
builds them as in-process threads over the demo pipeline on ``device``
(``main(argv, device=)``; ``None`` means ``cuda``) — what the tests run
on the CPU, same measurement harness, no process per replica.

On one card every replica shares the H100 (and the host's cores): a
fitted ``per_replica_rps`` there measures how the host's request path
(HTTP, JSON) scales with processes or threads on one device, not what
another card would add. The artifact keeps the JAX package's fields.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from typing import Any, Dict, List, Optional, Sequence

from keystone_tpu_torch.autoscale.supervisor import Supervisor

logger = logging.getLogger(__name__)

# shed tolerance for an "SLO held" cell: a capacity point where the
# gateway is already shedding isn't capacity, it's the cliff edge
DEFAULT_MAX_SHED_RATE = 0.01


def fit_capacity(
    capacity_by_replicas: Dict[int, float],
) -> Optional[float]:
    """Least-squares slope THROUGH THE ORIGIN of (k, capacity(k)) —
    zero replicas serve zero rps, so the intercept is not a free
    parameter. Only cells with measured capacity > 0 contribute;
    None when nothing held the SLO anywhere (the plan then carries
    the grid but derives no rate)."""
    pts = [
        (k, c) for k, c in capacity_by_replicas.items() if c > 0
    ]
    if not pts:
        return None
    num = sum(k * c for k, c in pts)
    den = sum(k * k for k, c in pts)
    return num / den if den else None


def derive_policy(
    per_replica_rps: Optional[float],
    slo_latency_s: float,
    target_utilization: float = 0.7,
) -> Dict[str, Any]:
    """The ``policy`` block of the artifact — exactly the fields
    ``PolicyConfig.from_plan`` understands."""
    policy: Dict[str, Any] = {
        "slo_latency_s": slo_latency_s,
        "target_utilization": target_utilization,
    }
    if per_replica_rps is not None:
        policy["per_replica_rps"] = round(per_replica_rps, 3)
    return policy


def run_grid(
    supervisor: Supervisor,
    target_url: str,
    events,
    *,
    replica_counts: Sequence[int],
    speeds: Sequence[float],
    slo_latency_s: float,
    max_shed_rate: float = DEFAULT_MAX_SHED_RATE,
    max_outstanding: int = 64,
    default_shape: Sequence[int] = (8,),
    wait_ready,
    emit=None,
) -> List[Dict[str, Any]]:
    """The measurement grid: for each replica count (ascending — the
    supervisor scales up between legs, reusing warm replicas), replay
    ``events`` at each speed through ``target_url`` and record the
    cell. ``wait_ready(k)`` blocks until the fleet reports ``k``
    ready replicas (the caller owns the router handle)."""
    from keystone_tpu_torch.loadgen.runner import HttpTarget, LoadGenerator

    if not events:
        raise ValueError("capacity plan needs a non-empty workload")
    base_duration = max(e.ts for e in events) or 1.0
    rows: List[Dict[str, Any]] = []
    for k in sorted(set(int(k) for k in replica_counts)):
        supervisor.scale_to(k)
        wait_ready(k)
        for speed in speeds:
            gen = LoadGenerator(
                HttpTarget(target_url, default_shape=default_shape),
                max_outstanding=max_outstanding,
            )
            report = gen.run(
                events, speed=float(speed), recovery_probe_s=0.0
            )
            stats = report.by_status()
            total = len(report.records)
            shed = stats.get("shed", 0)
            lost = stats.get("lost", 0)
            errors = stats.get("error", 0)
            p99 = report.p99()
            offered_rps = len(events) / (base_duration / float(speed))
            ok = (
                lost == 0
                and errors == 0
                and p99 is not None
                and p99 <= slo_latency_s
                and (shed / total if total else 1.0) <= max_shed_rate
            )
            row = {
                "replicas": k,
                "speed": float(speed),
                "offered_rps": round(offered_rps, 2),
                "p99_ms": (
                    round(p99 * 1e3, 3) if p99 is not None else None
                ),
                "shed_rate": round(shed / total, 4) if total else None,
                "lost": lost,
                "errors": errors,
                "slo_held": ok,
            }
            rows.append(row)
            if emit is not None:
                emit({"cell": row})
    return rows


def build_artifact(
    rows: List[Dict[str, Any]],
    slo_latency_s: float,
    slo_target: float,
    target_utilization: float = 0.7,
) -> Dict[str, Any]:
    """Grid rows -> the plan artifact (capacity curve + fit + derived
    policy)."""
    capacity: Dict[int, float] = {}
    for row in rows:
        k = row["replicas"]
        capacity.setdefault(k, 0.0)
        if row["slo_held"]:
            capacity[k] = max(capacity[k], row["offered_rps"])
    per_replica = fit_capacity(capacity)
    return {
        "kind": "keystone-capacity-plan",
        "slo": {"latency_s": slo_latency_s, "target": slo_target},
        "rows": rows,
        "capacity_rps_by_replicas": {
            str(k): round(c, 2) for k, c in sorted(capacity.items())
        },
        "fit": {
            "per_replica_rps": (
                round(per_replica, 3) if per_replica is not None else None
            ),
            "model": "capacity(k) = per_replica_rps * k "
                     "(least squares through origin)",
        },
        "policy": derive_policy(
            per_replica, slo_latency_s, target_utilization
        ),
    }


def _parse_list(spec: str, cast) -> List:
    return [cast(part) for part in spec.split(",") if part.strip()]


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """``python -m keystone_tpu_torch serve-capacity-plan`` — see module
    docstring."""
    ap = argparse.ArgumentParser(
        prog="keystone_tpu_torch serve-capacity-plan",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    wl = ap.add_argument_group("workload")
    wl.add_argument("--trace", default=None, metavar="FILE",
                    help="replay this --request-log JSONL recording "
                    "(the recorded peak)")
    wl.add_argument("--synthetic", type=int, default=None, metavar="N",
                    help="synthesize N requests instead of --trace")
    wl.add_argument("--ramp", default=None, metavar="RATE:DUR,...",
                    help="synthesize a STEP/RAMP staircase instead of "
                    "--trace/--synthetic (same grammar as "
                    "serve-loadgen --ramp) — note each grid cell "
                    "replays the whole staircase at its speed")
    wl.add_argument("--arrivals", default="poisson")
    wl.add_argument("--rate", type=float, default=20.0,
                    help="mean synthetic arrival rate at speed x1")
    wl.add_argument("--size-mix", default="1:1.0")
    wl.add_argument("--deadline-ms", type=float, default=None)
    wl.add_argument("--seed", type=int, default=0)

    grid = ap.add_argument_group("grid")
    grid.add_argument("--replicas", default="1,2", metavar="K,...",
                      help="replica counts to measure (ascending)")
    grid.add_argument("--speeds", default="1,2,4", metavar="X,...",
                      help="replay speed multipliers per replica count")
    grid.add_argument("--slo-latency-ms", type=float, required=True,
                      help="the latency objective a cell must hold")
    grid.add_argument("--slo-target", type=float, default=0.99)
    grid.add_argument("--max-shed-rate", type=float,
                      default=DEFAULT_MAX_SHED_RATE)
    grid.add_argument("--target-utilization", type=float, default=0.7,
                      help="fraction of fitted capacity the derived "
                      "policy plans replicas for")
    grid.add_argument("--max-outstanding", type=int, default=64)

    fleet = ap.add_argument_group("fleet under test")
    fleet.add_argument("--mode", choices=("inproc", "subprocess"),
                       default="inproc",
                       help="inproc: replicas as in-process threads "
                       "over the bench pipeline (CI-friendly); "
                       "subprocess: real serve-gateway processes "
                       "(share --aot-cache for warm legs)")
    fleet.add_argument("--d", type=int, default=64)
    fleet.add_argument("--hidden", type=int, default=64)
    fleet.add_argument("--depth", type=int, default=2)
    fleet.add_argument("--buckets", default="4,16")
    fleet.add_argument("--lanes", type=int, default=1)
    fleet.add_argument("--aot-cache", default=None, metavar="DIR",
                       help="shared AOT store for subprocess replicas")
    fleet.add_argument("--startup-timeout", type=float, default=180.0)

    out = ap.add_argument_group("output")
    out.add_argument("--out", default=None, metavar="FILE",
                     help="write the JSON plan artifact here "
                     "(default: stdout only)")
    args = ap.parse_args(argv)

    # the ONE workload builder serve-loadgen uses too — a capacity
    # plan must measure exactly the workload a drill would replay
    from keystone_tpu_torch.loadgen.cli import build_workload

    events = build_workload(args)
    replica_counts = _parse_list(args.replicas, int)
    speeds = _parse_list(args.speeds, float)
    slo_latency_s = args.slo_latency_ms / 1e3

    def emit(doc):
        print(json.dumps(doc), flush=True)

    from keystone_tpu_torch.fleet import RouterServer
    from keystone_tpu_torch.observability.registry import MetricsRegistry

    router = RouterServer(
        [], port=0, name="capacity-plan",
        registry=MetricsRegistry(), probe_interval_s=0.5,
    ).start()
    supervisor = _build_supervisor(args, router.url(), device)
    try:

        def wait_ready(k: int) -> None:
            deadline = time.perf_counter() + args.startup_timeout
            while time.perf_counter() < deadline:
                ready = sum(
                    1
                    for r in router.fleet.replicas()
                    if r.healthy and r.ready
                )
                if ready >= k:
                    return
                router.fleet.probe_once()
                time.sleep(0.25)
            raise SystemExit(
                f"fleet never reached {k} ready replicas within "
                f"{args.startup_timeout:.0f}s"
            )

        rows = run_grid(
            supervisor,
            router.url(),
            events,
            replica_counts=replica_counts,
            speeds=speeds,
            slo_latency_s=slo_latency_s,
            max_shed_rate=args.max_shed_rate,
            max_outstanding=args.max_outstanding,
            default_shape=(args.d,),
            wait_ready=wait_ready,
            emit=emit,
        )
    finally:
        supervisor.stop()
        router.stop()
    artifact = build_artifact(
        rows, slo_latency_s, args.slo_target,
        target_utilization=args.target_utilization,
    )
    doc = json.dumps(artifact, indent=1)
    print(doc, flush=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(doc + "\n")
        print(json.dumps({"plan_written": args.out}), flush=True)
    # a plan with no fitted rate is a failed measurement, not a plan
    return 0 if artifact["fit"]["per_replica_rps"] is not None else 1


def _build_supervisor(args, router_url: str, device=None) -> Supervisor:
    from keystone_tpu_torch.autoscale.supervisor import (
        InprocLauncher,
        SubprocessLauncher,
    )

    if args.mode == "subprocess":
        gw_args = [
            "--d", str(args.d), "--hidden", str(args.hidden),
            "--depth", str(args.depth), "--buckets", args.buckets,
            "--lanes", str(args.lanes),
        ]
        if args.aot_cache:
            gw_args += ["--aot-cache", args.aot_cache]
        return Supervisor(
            SubprocessLauncher(router_url, gw_args, device=None if device is None else str(device)),
            router_url,
            startup_timeout_s=args.startup_timeout,
        )

    # inproc: replicas over the demo pipeline, private registries
    import torch

    from keystone_tpu_torch.gateway import Gateway, GatewayServer
    from keystone_tpu_torch.observability.registry import MetricsRegistry
    from keystone_tpu_torch.serving.bench import build_pipeline

    fitted = build_pipeline(d=args.d, hidden=args.hidden, depth=args.depth, device=device)
    buckets = tuple(int(b) for b in args.buckets.split(","))

    def factory(index: int):
        reg = MetricsRegistry()
        gw = Gateway(
            fitted,
            buckets=buckets,
            n_lanes=args.lanes,
            warmup_example=torch.zeros((args.d,), dtype=torch.float32),
            device=device,
            name=f"plan-r{index}",
            registry=reg,
        )
        srv = GatewayServer(gw, port=0, registry=reg).start()
        return gw, srv

    return Supervisor(
        InprocLauncher(factory),
        router_url,
        startup_timeout_s=args.startup_timeout,
    )


__all__ = [
    "DEFAULT_MAX_SHED_RATE",
    "build_artifact",
    "derive_policy",
    "fit_capacity",
    "main",
    "run_grid",
]
