"""Shared stdlib-HTTP scaffolding for the background endpoints (counterpart
of ``keystone_tpu/observability/httpd.py``, copied as it is).

The admin plane (``observability/admin.py``), the gateway frontend
(``gateway/http.py``), and the fleet router (``fleet/router.py``) are
all the same shape: a ``ThreadingHTTPServer`` on a daemon thread, bound
to localhost by default, ``port=0`` for an ephemeral port, JSON/text
responses with explicit Content-Length, and a clean
``start()``/``stop()``/context-manager lifecycle. This module is that
shape, once — a fix to binding, shutdown, or response framing lands in
every endpoint.

``RequestLogWriter`` is the shared ``--request-log`` sink: one JSON
line per request, stdout or a line-buffered JSONL file, concurrent
handler threads kept whole under one lock. The gateway and the router
both write the same schema through it, which is what keeps fleet
recordings replayable by the same ``loadgen/trace.py`` parser.
"""

from __future__ import annotations

import itertools
import json
import logging
import random
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

logger = logging.getLogger(__name__)

# per-POST identity for request logs: concurrent handler threads
# interleave their lines, so a replayer can't rely on adjacency —
# lines from one POST share a post_seq instead (next() on
# itertools.count is atomic under the GIL). The random per-process
# prefix keeps ids unique across restarts: request logs open in
# APPEND mode, and a counter restarting at 1 would make a second
# session's posts dedupe away against the first's.
_POST_NONCE = "%08x" % random.getrandbits(32)
_POST_SEQ = itertools.count(1)


def next_post_seq() -> str:
    """A process-unique per-POST id for ``--request-log`` lines."""
    return f"{_POST_NONCE}-{next(_POST_SEQ)}"


class JsonHandler(BaseHTTPRequestHandler):
    """Response helpers + quiet logging shared by the endpoint
    handlers (scrapes/probes hit every few seconds; request logs go to
    DEBUG instead of stderr)."""

    def _send(
        self,
        code: int,
        body: bytes,
        content_type: str,
        headers: Optional[dict] = None,
    ) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for name, value in (headers or {}).items():
            self.send_header(name, str(value))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(
        self,
        obj,
        code: int = 200,
        indent: Optional[int] = None,
        headers: Optional[dict] = None,
    ) -> None:
        self._send(
            code,
            json.dumps(obj, indent=indent, default=str).encode("utf-8"),
            "application/json; charset=utf-8",
            headers=headers,
        )

    def _send_text(
        self, code: int, text: str, headers: Optional[dict] = None
    ) -> None:
        self._send(
            code,
            text.encode("utf-8"),
            "text/plain; charset=utf-8",
            headers=headers,
        )

    def log_message(self, format, *args):  # noqa: A002 (stdlib API)
        logger.debug("%s: " + format, type(self).__module__, *args)


class _QueueingHTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with a real listen backlog.
    socketserver's default ``request_queue_size`` of 5 drops bursty
    connection attempts with a client-side connection reset the
    moment more arrive in one scheduler quantum than ``accept()``
    drains — which the open-loop load generator at fleet rates (and
    a router fanning out to replicas) does routinely. A reset on an
    otherwise-healthy endpoint would be indistinguishable from a
    LOST request to the invariant checker."""

    request_queue_size = 128


class BackgroundServer:
    """A ``ThreadingHTTPServer`` + daemon serve thread behind
    ``start()``/``stop()``. Subclasses set ``handler_cls`` and
    ``thread_name`` and attach their routing state to the live server
    object in ``_configure()``."""

    handler_cls = JsonHandler
    thread_name = "keystone-http"

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._requested = (host, port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def _configure(self, httpd: ThreadingHTTPServer) -> None:
        """Attach handler-visible state (registries, gateways, ...) to
        ``httpd`` before the serve thread starts."""

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError(f"{type(self).__name__} not started")
        return self._httpd.server_address[1]

    @property
    def host(self) -> str:
        return self._requested[0]

    def url(self, path: str = "/") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def start(self) -> "BackgroundServer":
        if self._httpd is not None:
            return self
        httpd = _QueueingHTTPServer(self._requested, self.handler_cls)
        httpd.daemon_threads = True
        self._configure(httpd)
        self._httpd = httpd
        self._thread = threading.Thread(
            target=httpd.serve_forever,
            name=self.thread_name,
            daemon=True,
        )
        self._thread.start()
        logger.info("%s serving on %s", type(self).__name__, self.url())
        return self

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._httpd = None
        self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class RequestLogWriter:
    """The ``--request-log`` sink shared by the gateway frontend and
    the fleet router: falsy = disabled, True = one JSON line per
    request on stdout, a path = append line-buffered JSONL there (the
    loadgen record/replay path — no process-output scraping)."""

    def __init__(self, request_log) -> None:
        self.enabled = bool(request_log)
        # the stop() close race: a straggler handler
        # thread must re-check this under the lock, never write to a
        # closed file — the guarded-by rule keeps it that way
        self._file = None  # guarded-by: _lock
        self._lock = threading.Lock()
        self._to_file = isinstance(request_log, (str, bytes)) or hasattr(
            request_log, "__fspath__"
        )
        if self._to_file:
            self._file = open(  # noqa: SIM115 (held open for the
                # server's lifetime; close() closes it)
                request_log, "a", buffering=1, encoding="utf-8",
            )

    def write(self, line: dict) -> None:
        """One record to the log (stdout or the file). Handler threads
        are concurrent; the lock keeps lines whole."""
        text = json.dumps(line)
        if not self._to_file:
            with self._lock:
                # one write() call for text+newline, under the lock:
                # print() issues two writes and concurrent handler
                # threads would interleave mid-line, producing merged
                # lines the trace parser drops
                sys.stdout.write(text + "\n")
                sys.stdout.flush()
            return
        with self._lock:
            # re-read under the lock: daemon handler threads are not
            # joined by stop(), so a straggler can race the close —
            # it must drop its line, not write to a closed file
            out = self._file
            if out is not None:
                out.write(text + "\n")

    def close(self) -> None:
        if self._file is not None:
            with self._lock:
                self._file.close()
                self._file = None
