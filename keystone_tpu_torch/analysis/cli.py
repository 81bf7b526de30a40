"""``keystone-lint``: the command-line front end (counterpart of
``keystone_tpu/analysis/cli.py``, over ``keystone_tpu_torch/``).

    python -m keystone_tpu_torch keystone-lint [paths...]
        [--root DIR] [--json] [--baseline FILE] [--write-baseline]
        [--changed-only] [--list-rules]

Exit codes: 0 = clean (every finding suppressed or baselined and no
stale baseline entries), 1 = unbaselined findings (or stale baseline
entries — the baseline only shrinks; an unparseable linted file
surfaces as a `parse-error` finding here, so one broken file fails
the gate without killing the report), 2 = usage trouble (bad flags,
missing paths, unreadable baseline).

Kept argparse-free on purpose: the other serving CLIs hand-peel argv
the same way, and the lint entry must start fast enough to sit in a
pre-commit hook (no torch or jax import anywhere on this path).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import List, Optional, Sequence

from keystone_tpu_torch.analysis.core import (
    Baseline,
    build_project,
    run_analysis,
)
from keystone_tpu_torch.analysis.rules import ALL_RULES, default_rules

# the port's own baseline (the root LINT_BASELINE.json is the JAX
# package's), relative to the root
DEFAULT_BASELINE = "keystone_tpu_torch/analysis/LINT_BASELINE.json"
DEFAULT_PATHS = ("keystone_tpu_torch",)

# files that feed the cross-file drift rules: touching any of them in
# --changed-only mode re-runs the project-level pass
_PROJECT_RULE_TRIGGERS = (
    "keystone_tpu_torch/loadgen/faults.py",
    "README.md",
)


def _detect_root(explicit: Optional[str]) -> str:
    if explicit:
        return os.path.abspath(explicit)
    cwd = os.getcwd()
    if os.path.isdir(os.path.join(cwd, "keystone_tpu_torch")):
        return cwd
    # fall back to the checkout this module was imported from, so the
    # CLI works from any working directory
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(here))


def _changed_files(root: str) -> Optional[List[str]]:
    """``git diff --name-only HEAD`` + untracked — the fast local
    loop. None when git is unavailable (caller falls back to full)."""
    try:
        diff = subprocess.run(
            ["git", "-C", root, "diff", "--name-only", "HEAD"],
            capture_output=True, text=True, timeout=30,
        )
        if diff.returncode != 0:
            return None
        untracked = subprocess.run(
            ["git", "-C", root, "ls-files", "--others",
             "--exclude-standard"],
            capture_output=True, text=True, timeout=30,
        )
        names = diff.stdout.splitlines()
        if untracked.returncode == 0:
            names += untracked.stdout.splitlines()
        return sorted({n.strip() for n in names if n.strip()})
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    as_json = False
    write_baseline = False
    changed_only = False
    baseline_path: Optional[str] = None
    root_arg: Optional[str] = None
    paths: List[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            print(__doc__)
            return 0
        if a == "--list-rules":
            for cls in ALL_RULES:
                print(f"{cls.name:24s} {cls.description}")
            return 0
        if a == "--json":
            as_json = True
        elif a == "--write-baseline":
            write_baseline = True
        elif a == "--changed-only":
            changed_only = True
        elif a == "--baseline":
            i += 1
            if i >= len(argv):
                print("--baseline requires a path", file=sys.stderr)
                return 2
            baseline_path = argv[i]
        elif a == "--root":
            i += 1
            if i >= len(argv):
                print("--root requires a directory", file=sys.stderr)
                return 2
            root_arg = argv[i]
        elif a.startswith("-"):
            print(f"unknown option {a!r}", file=sys.stderr)
            return 2
        else:
            paths.append(a)
        i += 1

    if changed_only and paths:
        # explicit paths already narrow the run; silently honoring one
        # and not the other (and skipping the stale-baseline check)
        # made full-looking runs weaker than they claimed
        print(
            "--changed-only and explicit paths are mutually "
            "exclusive", file=sys.stderr,
        )
        return 2
    if write_baseline and (changed_only or paths):
        # regenerating from a slice would rewrite the file with only
        # the slice's findings, silently dropping every other file's
        # grandfathered entries — the baseline is a full-run artifact
        print(
            "--write-baseline requires a full run (no explicit "
            "paths, no --changed-only)", file=sys.stderr,
        )
        return 2

    root = _detect_root(root_arg)
    if baseline_path is None:
        baseline_path = os.path.join(root, DEFAULT_BASELINE)
    elif not os.path.isabs(baseline_path):
        baseline_path = os.path.join(root, baseline_path)

    rules = default_rules()
    run_project_rules = True
    if not paths:
        paths = list(DEFAULT_PATHS)
        if changed_only:
            changed = _changed_files(root)
            if changed is None:
                print(
                    "keystone-lint: --changed-only needs git; "
                    "linting everything", file=sys.stderr,
                )
            else:
                paths = [
                    c for c in changed
                    if c.endswith(".py")
                    and c.startswith("keystone_tpu_torch/")
                    and os.path.exists(os.path.join(root, c))
                ]
                run_project_rules = any(
                    c in _PROJECT_RULE_TRIGGERS
                    or c.startswith("tests/")
                    for c in changed
                ) or bool(paths)
                if not paths and not run_project_rules:
                    if as_json:
                        print(json.dumps({
                            "version": 1, "root": root, "clean": True,
                            "changed_only": True, "files": 0,
                            "counts": {
                                "findings": 0, "baselined": 0,
                                "suppressed": 0, "stale_baseline": 0,
                            },
                            "findings": [],
                        }, indent=2))
                    else:
                        print("keystone-lint: no changed files to lint")
                    return 0
    if not run_project_rules:
        from keystone_tpu_torch.analysis.rules import FaultPointDriftRule

        rules = [
            r for r in rules
            if not isinstance(r, FaultPointDriftRule)
        ]

    # a typo'd path must not become a gate that silently checks
    # nothing and exits 0 forever
    missing = [
        p for p in paths
        if not os.path.exists(
            p if os.path.isabs(p) else os.path.join(root, p)
        )
    ]
    if missing:
        print(
            f"keystone-lint: no such path(s): {', '.join(missing)}",
            file=sys.stderr,
        )
        return 2

    try:
        project = build_project(root, paths)
        result = run_analysis(root, paths, rules, project=project)
    except OSError as e:
        print(f"keystone-lint: {e}", file=sys.stderr)
        return 2

    if write_baseline:
        os.makedirs(os.path.dirname(baseline_path), exist_ok=True)
        Baseline.from_findings(result.findings).save(baseline_path)
        print(
            f"keystone-lint: wrote {len(result.findings)} finding(s) "
            f"to {baseline_path} — replace every 'TODO: justify or "
            "fix' justification before committing"
        )
        return 0

    try:
        baseline = Baseline.load(baseline_path)
    except (ValueError, json.JSONDecodeError) as e:
        print(f"keystone-lint: bad baseline: {e}", file=sys.stderr)
        return 2
    live = result.unbaselined(baseline)
    baselined = len(result.findings) - len(live)
    # stale entries fail the run in full mode only: a --changed-only
    # slice legitimately misses files whose baselined findings live on
    stale = (
        baseline.stale_entries(result.findings)
        if not changed_only else []
    )

    if as_json:
        doc = {
            "version": 1,
            "root": root,
            "clean": not live and not stale,
            "changed_only": changed_only,
            "files": len(project.files),
            "rules": [cls.name for cls in ALL_RULES],
            "counts": {
                "findings": len(live),
                "baselined": baselined,
                "suppressed": result.suppressed,
                "stale_baseline": len(stale),
            },
            "findings": [f.to_dict() for f in live],
            "stale_baseline": stale,
        }
        print(json.dumps(doc, indent=2))
    else:
        for f in live:
            print(f.render())
        for e in stale:
            print(
                f"stale baseline entry (fixed or line changed — "
                f"delete it): {e.get('path')}: {e.get('rule')}: "
                f"{e.get('line_text', '')!r}"
            )
        print(
            f"keystone-lint: {len(live)} finding(s), "
            f"{baselined} baselined, {result.suppressed} suppressed"
            + (f", {len(stale)} stale baseline entr(y/ies)" if stale
               else "")
        )
    return 1 if (live or stale) else 0


if __name__ == "__main__":
    raise SystemExit(main())
