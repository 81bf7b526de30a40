"""Invariant checking: turn a chaos experiment into a verdict
(counterpart of ``keystone_tpu/loadgen/invariants.py``).

The serving stack's robustness claims become machine-checked
assertions over a ``LoadReport``:

- **every admitted request resolves** — zero ``lost`` records. A
  future that never resolves is the worst serving bug there is: the
  client hangs, the SLO clock keeps running, and no counter shows it.
- **failures are typed sheds only** — zero untyped failures. Under
  chaos the gateway may 429/503/504 with a typed ``Overloaded``
  reason (that IS the design), but a naked 500 (or an injected fault
  escaping to a caller) means the retry/health plane leaked.
- **readiness recovers** — after the last fault clears, ``/readyz``
  must go green again within the probe bound (the runner measures it;
  this checks it happened).
- **p99 recovers** — tail latency of traffic sent after the fault
  cleared must return to within ``p99_factor`` × the pre-fault p99
  (plus a small absolute slack so microsecond baselines don't turn
  scheduler jitter into a red verdict) within ``recovery_within_s``.
  The checker slides the window start across the recovery bound and
  reports the earliest second at which the tail is back in bounds.
- **shed rate bounded** (optional) — the experiment's declared
  shed-rate ceiling.
- **p99 bounded** (optional) — an absolute tail ceiling over the
  whole run.

A checker is only trustworthy if it can fail: the tier-1 suite feeds
it stub gateways that lose futures, return untyped 500s, and never
recover readiness, and asserts each produces a red verdict."""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

from keystone_tpu_torch.loadgen.runner import LoadReport

# absolute slack added to the p99 recovery bound: a 2 ms pre-fault
# baseline must not fail the 1.5x rule over 1 ms of scheduler noise
DEFAULT_P99_SLACK_S = 0.005


@dataclasses.dataclass
class InvariantResult:
    name: str
    passed: bool
    detail: str

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Verdict:
    passed: bool
    invariants: List[InvariantResult]
    stats: Dict[str, Any]

    def as_dict(self) -> Dict[str, Any]:
        return {
            "passed": self.passed,
            "invariants": [r.as_dict() for r in self.invariants],
            "stats": self.stats,
        }

    def to_json(self, indent: Optional[int] = 1) -> str:
        return json.dumps(self.as_dict(), indent=indent)

    def failures(self) -> List[InvariantResult]:
        return [r for r in self.invariants if not r.passed]


class InvariantChecker:
    """Declared bounds for one experiment; ``check`` renders the
    verdict. Bounds are per-experiment state (not per-call args) so a
    bench row / CLI invocation states its contract once, up front."""

    def __init__(
        self,
        *,
        p99_factor: float = 1.5,
        p99_slack_s: float = DEFAULT_P99_SLACK_S,
        recovery_within_s: float = 10.0,
        max_shed_rate: Optional[float] = None,
        max_p99_s: Optional[float] = None,
        require_readiness_recovery: bool = True,
    ):
        self.p99_factor = float(p99_factor)
        self.p99_slack_s = float(p99_slack_s)
        self.recovery_within_s = float(recovery_within_s)
        self.max_shed_rate = max_shed_rate
        self.max_p99_s = max_p99_s
        self.require_readiness_recovery = require_readiness_recovery

    def check(self, report: LoadReport) -> Verdict:
        results = [
            self._all_resolved(report),
            self._typed_only(report),
        ]
        if report.fault_windows:
            if self.require_readiness_recovery:
                results.append(self._readiness(report))
            results.append(self._p99_recovery(report))
        if self.max_shed_rate is not None:
            results.append(self._shed_rate(report))
        if self.max_p99_s is not None:
            results.append(self._p99_bound(report))
        stats = report.stats()
        stats.update(self._recovery_stats(report))
        stats["exemplars"] = self._exemplars(report)
        return Verdict(
            passed=all(r.passed for r in results),
            invariants=results,
            stats=stats,
        )

    # -- forensic exemplars --------------------------------------------------

    @staticmethod
    def _exemplars(report: LoadReport, limit: int = 16) -> Dict[str, Any]:
        """Trace ids a human (or the CLI) can chase into
        ``/debugz?trace_id=``: the worst-latency success plus every
        lost and untyped request (capped) — a red verdict names the
        exact requests that broke it, not just counts. Lost requests
        usually have no trace id (no response came back); they are
        listed anyway so the verdict shows what IS unattributable."""

        def entry(r) -> Dict[str, Any]:
            return {
                "index": r.index,
                "trace_id": r.trace_id,
                "latency_ms": (
                    round(r.latency_s * 1e3, 3)
                    if r.latency_s is not None else None
                ),
                "code": r.code,
                "reason": r.reason,
            }

        oks = [
            r for r in report.records
            if r.status == "ok" and r.latency_s is not None
        ]
        worst = max(oks, key=lambda r: r.latency_s) if oks else None
        lost = [r for r in report.records if r.status == "lost"]
        untyped = [r for r in report.records if r.untyped]
        return {
            "worst_latency": entry(worst) if worst is not None else None,
            "lost": [entry(r) for r in lost[:limit]],
            "untyped": [entry(r) for r in untyped[:limit]],
        }

    # -- the invariants ----------------------------------------------------

    def _all_resolved(self, report: LoadReport) -> InvariantResult:
        lost = [r for r in report.records if r.status == "lost"]
        unaccounted = report.issued - len(report.records)
        ok = not lost and unaccounted == 0
        detail = (
            f"{report.issued} issued, {len(report.records)} resolved, "
            f"{len(lost)} lost"
        )
        if unaccounted:
            detail += f", {unaccounted} vanished without a record"
        if lost:
            detail += (
                "; first: " + (lost[0].reason or "no terminal outcome")
            )
        return InvariantResult("every_admitted_request_resolves", ok, detail)

    def _typed_only(self, report: LoadReport) -> InvariantResult:
        untyped = [r for r in report.records if r.untyped]
        detail = f"{len(untyped)} untyped failures"
        if untyped:
            first = untyped[0]
            detail += (
                f"; first: status={first.status} code={first.code} "
                f"reason={first.reason!r}"
            )
        return InvariantResult(
            "failures_are_typed_sheds_only", not untyped, detail
        )

    def _readiness(self, report: LoadReport) -> InvariantResult:
        if not report.ready_probed:
            return InvariantResult(
                "readiness_recovers_after_fault", False,
                "fault windows ran but readiness was never probed",
            )
        ok = report.ready_recovery_s is not None
        detail = (
            f"/readyz green {report.ready_recovery_s:.2f}s after the "
            "last fault cleared (observed upper bound)"
            if ok
            else "/readyz never recovered within the probe bound"
        )
        return InvariantResult("readiness_recovers_after_fault", ok, detail)

    def _p99_recovery(self, report: LoadReport) -> InvariantResult:
        fault_start = min(w.t_arm for w in report.fault_windows)
        cleared = max(
            w.t_clear if w.t_clear is not None else w.t_arm
            for w in report.fault_windows
        )
        pre = report.p99(0.0, fault_start)
        if pre is None:
            return InvariantResult(
                "p99_recovers_after_fault", False,
                "no pre-fault completions to baseline against "
                "(arm the fault later into the run)",
            )
        bound = pre * self.p99_factor + self.p99_slack_s
        rec_at = self._recovery_second(report, cleared, bound)
        if rec_at is None:
            post = report.p99(cleared + self.recovery_within_s)
            return InvariantResult(
                "p99_recovers_after_fault", False,
                f"p99 never returned under {bound * 1e3:.1f}ms "
                f"({self.p99_factor}x pre-fault {pre * 1e3:.1f}ms "
                f"+ slack) within "
                f"{self.recovery_within_s:.0f}s of the fault "
                f"clearing; tail-window p99 "
                + (f"{post * 1e3:.1f}ms" if post is not None else "n/a"),
            )
        post = report.p99(cleared + rec_at)
        return InvariantResult(
            "p99_recovers_after_fault", True,
            f"p99 {post * 1e3:.1f}ms within {rec_at:.0f}s of the fault "
            f"clearing (bound {bound * 1e3:.1f}ms = "
            f"{self.p99_factor}x pre-fault {pre * 1e3:.1f}ms "
            f"+ {self.p99_slack_s * 1e3:.0f}ms slack)",
        )

    def _recovery_second(
        self, report: LoadReport, cleared: float, bound: float
    ) -> Optional[float]:
        """Earliest whole second k <= recovery_within_s such that the
        p99 of ok-requests SENT after cleared+k is within bound (and
        at least one such request exists)."""
        k = 0.0
        while k <= self.recovery_within_s:
            p99 = report.p99(cleared + k)
            if p99 is not None and p99 <= bound:
                return k
            k += 1.0
        return None

    def _recovery_stats(self, report: LoadReport) -> Dict[str, Any]:
        if not report.fault_windows:
            return {}
        fault_start = min(w.t_arm for w in report.fault_windows)
        cleared = max(
            w.t_clear if w.t_clear is not None else w.t_arm
            for w in report.fault_windows
        )
        pre = report.p99(0.0, fault_start)
        during = report.p99(fault_start, cleared)
        post = report.p99(cleared)
        stats = {
            "pre_fault_p99_ms": (
                round(pre * 1e3, 3) if pre is not None else None
            ),
            "during_fault_p99_ms": (
                round(during * 1e3, 3) if during is not None else None
            ),
            "post_fault_p99_ms": (
                round(post * 1e3, 3) if post is not None else None
            ),
            "p99_recovery_s": None,
            "recovered_p99_ms": None,
        }
        if pre is not None:
            # the whole-post-window p99 above includes the backlog
            # drain right after the fault clears; the RECOVERED number
            # (from the earliest in-bounds second the recovery
            # invariant found) is the steady-state the row reports
            bound = pre * self.p99_factor + self.p99_slack_s
            rec_at = self._recovery_second(report, cleared, bound)
            if rec_at is not None:
                recovered = report.p99(cleared + rec_at)
                stats["p99_recovery_s"] = rec_at
                stats["recovered_p99_ms"] = round(recovered * 1e3, 3)
        return stats

    def _shed_rate(self, report: LoadReport) -> InvariantResult:
        total = len(report.records)
        shed = report.by_status().get("shed", 0)
        rate = shed / total if total else 0.0
        ok = rate <= self.max_shed_rate
        return InvariantResult(
            "shed_rate_bounded", ok,
            f"shed {shed}/{total} ({rate:.1%}) vs bound "
            f"{self.max_shed_rate:.1%}",
        )

    def _p99_bound(self, report: LoadReport) -> InvariantResult:
        p99 = report.p99()
        if p99 is None:
            return InvariantResult(
                "p99_bounded", False, "no successful requests to measure"
            )
        ok = p99 <= self.max_p99_s
        return InvariantResult(
            "p99_bounded", ok,
            f"whole-run p99 {p99 * 1e3:.1f}ms vs bound "
            f"{self.max_p99_s * 1e3:.1f}ms",
        )


__all__ = [
    "DEFAULT_P99_SLACK_S",
    "InvariantChecker",
    "InvariantResult",
    "Verdict",
]
