"""``serve-lifecycle``: operator controls for a live gateway's
lifecycle plane over HTTP (counterpart of
``keystone_tpu/lifecycle/cli.py``; stdlib only).

    python -m keystone_tpu_torch serve-lifecycle status   --url http://host:port
    python -m keystone_tpu_torch serve-lifecycle tick     --url ... [--model m]
    python -m keystone_tpu_torch serve-lifecycle rollback --url ... [--model m]

``status`` GETs ``/lifecyclez``; ``tick`` forces one policy tick on
every controller (what the background interval does on its own);
``rollback`` forces a rollback — mid-cycle it kills the candidate,
after a promotion it swaps the engines back to the retained
incumbent. All three print the server's JSON verbatim (exit 1 on a
transport/HTTP error), so they compose with jq the way the other
``/…z`` surfaces do."""

from __future__ import annotations

import argparse
import json
import sys
import urllib.error
import urllib.request


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="keystone_tpu_torch serve-lifecycle", description=__doc__
    )
    ap.add_argument(
        "action", choices=("status", "tick", "rollback"),
        help="status: GET /lifecyclez; tick: force one policy tick; "
             "rollback: force a rollback (candidate killed, or a "
             "promotion un-promoted)",
    )
    ap.add_argument("--url", required=True, metavar="BASE",
                    help="gateway base URL, e.g. http://127.0.0.1:8300")
    ap.add_argument("--model", default=None,
                    help="target one model (rollback only; default: "
                    "the server's default lifecycle model)")
    ap.add_argument("--timeout", type=float, default=30.0)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    base = args.url.rstrip("/")
    try:
        if args.action == "status":
            req = urllib.request.Request(base + "/lifecyclez")
        else:
            body = {"tick": True} if args.action == "tick" else \
                {"rollback": True}
            if args.model:
                body["model"] = args.model
            req = urllib.request.Request(
                base + "/lifecyclez",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"},
            )
        with urllib.request.urlopen(req, timeout=args.timeout) as resp:
            doc = json.loads(resp.read())
    except urllib.error.HTTPError as e:
        try:
            detail = e.read().decode()
        except Exception:
            detail = ""
        print(f"HTTP {e.code}: {detail}", file=sys.stderr)
        return 1
    except Exception as e:
        print(f"request failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps(doc, indent=2))
    return 0


__all__ = ["build_parser", "main"]
