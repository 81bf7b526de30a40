"""Fleet roster client: the ONE implementation of the ``/registerz``
and ``/deregisterz`` wire calls (counterpart of
``keystone_tpu/fleet/client.py``, copied as it is).

The gateway (``--register`` self-registration + deregister-on-drain)
and the autoscale supervisor (registering in-process replicas,
deregistering retired/dead ones) speak the same two routes with the
same ``{"url": ...}`` body; this module is that call once, so the
payload can never drift between the two sides. Retry POLICY stays at
the call sites — startup registration may wait patiently for a
router that is still binding, a process-exit deregistration must
not — which is why ``post_roster`` raises on failure instead of
swallowing it."""

from __future__ import annotations

import json
import logging
import urllib.request

logger = logging.getLogger(__name__)

REGISTER_ROUTE = "/registerz"
DEREGISTER_ROUTE = "/deregisterz"


def post_roster(
    router_url: str,
    route: str,
    replica_url: str,
    timeout_s: float = 5.0,
    models=None,
) -> None:
    """POST one replica URL to a router roster route (``/registerz``
    or ``/deregisterz``). Raises on any transport/HTTP failure — the
    caller owns the retry policy. ``models`` (an iterable of model
    ids) advertises which zoo models the replica serves: the router
    only forwards ``/predict/<model>`` to replicas advertising that
    id. Omitted entirely when empty, so pre-zoo routers keep parsing
    the same ``{"url": ...}`` body they always did."""
    doc = {"url": replica_url.rstrip("/")}
    if models:
        doc["models"] = sorted(str(m) for m in models)
    body = json.dumps(doc).encode("utf-8")
    req = urllib.request.Request(
        router_url.rstrip("/") + route,
        data=body,
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout_s):
        pass


def try_deregister(
    router_url: str, replica_url: str, timeout_s: float = 5.0
) -> bool:
    """One best-effort ``/deregisterz`` (idempotent — an unknown URL
    is a no-op success). Returns False on failure instead of raising:
    every caller is mid-retirement or mid-exit and must proceed to
    the drain either way, and a dead router's roster entry dies with
    it anyway."""
    try:
        post_roster(
            router_url, DEREGISTER_ROUTE, replica_url,
            timeout_s=timeout_s,
        )
        logger.info(
            "deregistered %s from router %s", replica_url, router_url
        )
        return True
    except Exception as e:
        logger.warning(
            "could not deregister %s from router %s: %s",
            replica_url, router_url, e,
        )
        return False


__all__ = [
    "DEREGISTER_ROUTE",
    "REGISTER_ROUTE",
    "post_roster",
    "try_deregister",
]
