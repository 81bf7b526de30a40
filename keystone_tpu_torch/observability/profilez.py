"""On-demand device profiling: ``GET /profilez?seconds=N`` (counterpart of
``keystone_tpu/observability/profilez.py``).

Arms ``utils/profiling.trace`` (a Kineto capture of the host
and, on the card, its kernels) around whatever live traffic flows for
the next N seconds, then answers with the trace directory listing — a
Chrome trace, loadable in Perfetto or chrome://tracing. Served by BOTH
the admin endpoint and the gateway frontend through the shared
``profilez_document`` below, so a single-port deployment can still grab
a device trace.

One capture at a time: ``torch.profiler`` is process-wide on the device
side, so a second concurrent request gets a typed **409** instead of
corrupting the first capture. The handler thread blocks for the capture
window (the endpoint servers are threading servers — scrapes keep
flowing on other threads). Only the newest ``MAX_RETAINED_CAPTURES``
capture dirs are kept on disk.
"""

from __future__ import annotations

import itertools
import os
import shutil
import tempfile
import threading
import time
from typing import Dict, Optional, Tuple

# hard ceiling on one capture window: profiling holds buffers and the
# capture lock; an operator typo ("?seconds=3600") must not wedge the
# endpoint for an hour
MAX_CAPTURE_SECONDS = 60.0
DEFAULT_CAPTURE_SECONDS = 1.0
# bounded retention (the flight-recorder ring convention): a probe
# hitting /profilez periodically on a long-lived server must not fill
# the disk — only the newest captures survive
MAX_RETAINED_CAPTURES = 8

# process-global: torch.profiler takes one device trace per process
_capture_lock = threading.Lock()
_capture_ids = itertools.count()


def default_base_dir() -> str:
    return os.path.join(
        tempfile.gettempdir(), f"keystone-profilez-{os.getpid()}"
    )


def _prune_captures(
    base_dir: str, keep: int = MAX_RETAINED_CAPTURES
) -> None:
    """Best-effort delete of all but the ``keep`` newest capture dirs
    (also sweeps the empty dir a failed capture leaves behind)."""
    try:
        dirs = [
            path
            for name in os.listdir(base_dir)
            if name.startswith("trace-")
            and os.path.isdir(path := os.path.join(base_dir, name))
        ]
        dirs.sort(key=os.path.getmtime)
        for stale in dirs[:-keep] if keep > 0 else dirs:
            shutil.rmtree(stale, ignore_errors=True)
    except OSError:
        pass


def _sweep_dead_process_dirs(current_base: str) -> None:
    """Best-effort removal of ``keystone-profilez-<pid>`` trees left
    by dead server processes: per-pid retention alone would let a
    restart-looping host accumulate 8 captures per dead pid forever.
    Dirs whose pid is still alive (or not ours to signal) are kept."""
    parent = os.path.dirname(current_base)
    try:
        names = os.listdir(parent)
    except OSError:
        return
    for name in names:
        path = os.path.join(parent, name)
        if (
            not name.startswith("keystone-profilez-")
            or path == current_base
            or not os.path.isdir(path)
        ):
            continue
        pid_s = name.rsplit("-", 1)[-1]
        if not pid_s.isdigit():
            continue
        try:
            os.kill(int(pid_s), 0)
        except ProcessLookupError:
            shutil.rmtree(path, ignore_errors=True)
        except OSError:
            pass  # alive under another uid (EPERM etc.) — keep


def _listing(trace_dir: str, limit: int = 200) -> Tuple[list, int]:
    """Relative paths of the capture's files (bounded) + total count."""
    files = []
    for root, _dirs, names in os.walk(trace_dir):
        for name in names:
            files.append(
                os.path.relpath(os.path.join(root, name), trace_dir)
            )
    files.sort()
    return files[:limit], len(files)


def profilez_document(
    seconds_raw: Optional[str], base_dir: Optional[str] = None
) -> Tuple[int, Dict]:
    """One ``/profilez`` request -> ``(status_code, json_doc)``.

    400 on a malformed/out-of-range ``seconds``, 409 while another
    capture is running, 500 when the profiler itself fails, else 200
    with the trace directory + file listing."""
    try:
        seconds = (
            float(seconds_raw) if seconds_raw is not None
            else DEFAULT_CAPTURE_SECONDS
        )
    except (TypeError, ValueError):
        return 400, {
            "error": "bad_request",
            "detail": f"seconds must be a number, got {seconds_raw!r}",
        }
    if not seconds > 0 or seconds > MAX_CAPTURE_SECONDS:
        return 400, {
            "error": "bad_request",
            "detail": f"seconds must be in (0, {MAX_CAPTURE_SECONDS:g}], "
                      f"got {seconds:g}",
        }
    if not _capture_lock.acquire(blocking=False):
        return 409, {
            "error": "capture_in_progress",
            "detail": "another /profilez capture is running; "
                      "torch.profiler takes one trace per process",
        }
    base = base_dir or default_base_dir()
    try:
        from keystone_tpu_torch.utils.profiling import trace

        trace_dir = os.path.join(
            base,
            time.strftime("trace-%Y%m%d-%H%M%S")
            + f"-{next(_capture_ids)}",
        )
        os.makedirs(trace_dir, exist_ok=True)
        t0 = time.perf_counter()
        with trace(trace_dir):
            # live traffic keeps flowing on the serving threads; this
            # handler just holds the capture window open
            time.sleep(seconds)
        captured_s = time.perf_counter() - t0
        files, total = _listing(trace_dir)
        return 200, {
            "trace_dir": trace_dir,
            "seconds": seconds,
            "captured_s": round(captured_s, 3),
            "file_count": total,
            "files": files,
            "view": "load the trace file in Perfetto or "
                    "chrome://tracing",
        }
    except Exception as e:  # profiler failure must answer, not raise
        return 500, {"error": "profiler_failed", "detail": str(e)}
    finally:
        # the dir just written is the newest -> always retained; runs
        # under the capture lock, so pruning never races a capture
        _prune_captures(base)
        if base_dir is None:  # default per-pid layout only
            _sweep_dead_process_dirs(base)
        _capture_lock.release()


__all__ = [
    "DEFAULT_CAPTURE_SECONDS",
    "MAX_CAPTURE_SECONDS",
    "MAX_RETAINED_CAPTURES",
    "profilez_document",
]
