"""The supervisor: replica processes as a managed, elastic set
(counterpart of ``keystone_tpu/autoscale/supervisor.py``).

``Supervisor`` owns N replica handles and converges them to a target
count (``scale_to``), the way ``EnginePool`` owns lanes — except a
"lane" here is a whole ``serve-gateway`` PROCESS and the membership
protocol is the fleet tier's:

- **launch** — a ``Launcher`` produces handles. The production one
  (``SubprocessLauncher``) spawns ``python -m keystone_tpu_torch
  serve-gateway --gateway-port 0 --register <router> ...`` (on the
  card, which every replica of one host shares) and reads
  the machine-parseable ``{"listening": ...}`` first-stdout-line
  handshake for the bound address (the same contract the smoke
  drills use — port 0 means no port races, and the replica
  self-registers with the router on its own). ``InprocLauncher``
  runs the same topology as in-process threads over a caller-supplied
  factory — what the bench row and the unit tests use, so the
  supervisor's logic is exercised without paying a process start per
  replica.
- **retire** (graceful drain) — scale-down is the three-step
  fleet-exit protocol, in order: (1) the replica leaves the router's
  roster, so NO new forwards land on it; (2) it drains (SIGTERM for
  subprocesses — the gateway's handler stops admitting, finishes
  in-flight windows and exits); (3) bounded wait, then kill as the last
  resort. Retirement runs on its own daemon thread so a slow drain
  never stalls the control loop. Step (1) is done once: the port's
  ``serve-gateway`` deregisters itself from its routers on SIGTERM
  before it drains (a departure from the JAX gateway, which drains
  first), so for a ``self_deregistering`` launcher the SIGTERM is the
  deregistration and the supervisor does not post its own; for the
  others (in-process replicas) the supervisor posts ``/deregisterz``
  before the drain, as the JAX supervisor does for every replica. A
  replica killed after a drain that timed out is deregistered by the
  supervisor, since it could not do it itself.
- **reap** (repair) — a handle whose process died without being
  retired (kill -9, OOM, crash) is detected by ``reap()``, removed
  from the roster (its stale URL deregistered), and REPLACED to hold
  the target — repair is not subject to the policy's cooldowns, it
  is not a scaling decision.

The supervisor never decides anything: the policy engine decides,
the controller calls ``scale_to``/``reap``. Lock discipline follows
the fleet tier's: the lock guards only the handle list — every HTTP
call, process wait, and launch happens outside it.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)

# how long a spawned replica gets from exec() to its {"listening"}
# handshake line (a start pays the torch import, the CUDA context, a
# profiler session and the captures; nvcc too on a host without the
# kernel libraries built or in the AOT store)
STARTUP_TIMEOUT_S = 180.0

# graceful-drain bound before a retiring replica is killed outright
DRAIN_TIMEOUT_S = 30.0


def deregister_replica(
    router_url: str, replica_url: str, timeout_s: float = 5.0
) -> bool:
    """``POST /deregisterz`` one replica URL off a router's roster —
    the shared best-effort client (``fleet/client.py``), re-exported
    here because it is half of the supervisor's retirement
    protocol."""
    from keystone_tpu_torch.fleet.client import try_deregister

    return try_deregister(router_url, replica_url, timeout_s=timeout_s)


class SubprocessReplica:
    """One spawned ``serve-gateway`` process. A reader thread tees the
    child's stdout/stderr into a log file and parses the FIRST
    ``{"listening": ...}`` JSON line — the handshake the supervisor
    blocks on before counting the replica toward the fleet."""

    def __init__(self, proc: subprocess.Popen, name: str, log_path: str):
        self.proc = proc
        self.name = name
        self.log_path = log_path
        self.pid = proc.pid
        self._url: Optional[str] = None
        self._url_event = threading.Event()
        self._reader = threading.Thread(
            target=self._read_output,
            name=f"keystone-{name}-output",
            daemon=True,
        )
        self._reader.start()

    def _read_output(self) -> None:
        try:
            with open(
                self.log_path, "a", buffering=1, encoding="utf-8"
            ) as log:
                for raw in self.proc.stdout:
                    line = raw.decode("utf-8", "replace") if isinstance(
                        raw, bytes
                    ) else raw
                    log.write(line)
                    if self._url is None and line.lstrip().startswith("{"):
                        try:
                            doc = json.loads(line)
                        except ValueError:
                            continue
                        url = doc.get("listening")
                        if isinstance(url, str):
                            self._url = url.rstrip("/")
                            self._url_event.set()
        except Exception:
            logger.exception(
                "replica %s: output reader failed", self.name
            )
        finally:
            # a child that exits without ever printing the handshake
            # must not strand wait_listening for the whole timeout
            self._url_event.set()

    @property
    def url(self) -> Optional[str]:
        return self._url

    def wait_listening(self, timeout_s: float) -> Optional[str]:
        """Block until the handshake line arrives (or the child dies /
        the bound expires). Returns the bound base URL or None."""
        deadline = time.perf_counter() + timeout_s
        while time.perf_counter() < deadline:
            remaining = deadline - time.perf_counter()
            self._url_event.wait(min(1.0, max(0.0, remaining)))
            if self._url is not None:
                return self._url
            if self.proc.poll() is not None:
                return None  # died before binding
            self._url_event.clear()
        return self._url

    def alive(self) -> bool:
        return self.proc.poll() is None

    def drain(self) -> None:
        """Ask for a graceful exit: SIGTERM -> the gateway's handler
        drains (stop admitting, finish in-flight, deregister) and the
        process exits on its own."""
        if self.alive():
            try:
                self.proc.terminate()
            except OSError:
                pass

    def kill(self) -> None:
        if self.alive():
            try:
                self.proc.kill()
            except OSError:
                pass

    def wait(self, timeout_s: float) -> bool:
        try:
            self.proc.wait(timeout=timeout_s)
            return True
        except subprocess.TimeoutExpired:
            return False

    def status(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "url": self._url,
            "pid": self.pid,
            "alive": self.alive(),
            "log": self.log_path,
        }


class SubprocessLauncher:
    """Spawn real ``serve-gateway`` replica processes (the production
    path — one process per replica, self-registering against the
    router, sharing the AOT store so scale-out is warm). ``device``
    ``"cpu"`` runs the replicas on the CPU (tests, rehearsals); the
    default is the entry's, ``cuda``."""

    # serve-gateway --register handles its own roster entry; the
    # supervisor must not double-register
    self_registering = True
    # and on SIGTERM the replica deregisters before it drains; the
    # supervisor must not double-deregister
    self_deregistering = True

    def __init__(
        self,
        router_url: str,
        gateway_args: Sequence[str] = (),
        *,
        log_dir: Optional[str] = None,
        env: Optional[Dict[str, str]] = None,
        python: Optional[str] = None,
        device: Optional[str] = None,
    ):
        self.router_url = router_url.rstrip("/")
        self.gateway_args = list(gateway_args)
        self.log_dir = log_dir or os.path.join(
            os.environ.get("TMPDIR", "/tmp"), "keystone-autoscale"
        )
        self.env = env
        self.python = python or sys.executable
        self.device = device

    def launch(self, index: int) -> SubprocessReplica:
        os.makedirs(self.log_dir, exist_ok=True)
        name = f"replica-{index}"
        log_path = os.path.join(self.log_dir, f"{name}.log")
        entry = ["-m", "keystone_tpu_torch"] if self.device is None else [
            "-c", "import sys; from keystone_tpu_torch.__main__ import main; "
                  f"sys.exit(main(sys.argv[1:], device={str(self.device)!r}))"]
        cmd = [
            self.python, *entry, "serve-gateway",
            "--gateway-port", "0",
            "--register", self.router_url,
            *self.gateway_args,
        ]
        env = dict(os.environ if self.env is None else self.env)
        proc = subprocess.Popen(
            cmd,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
        )
        logger.info(
            "supervisor: spawned %s (pid %d) -> %s",
            name, proc.pid, log_path,
        )
        return SubprocessReplica(proc, name, log_path)


class InprocReplica:
    """A replica that is a (gateway, server) pair of in-process
    threads — same lifecycle surface as ``SubprocessReplica``, no
    process. ``kill()`` stops the HTTP listener WITHOUT draining,
    which is as close to kill -9 as one process can get (in-flight
    futures resolve, but the 'host' vanishes from the network)."""

    def __init__(self, gateway, server, name: str):
        self.gateway = gateway
        self.server = server
        self.name = name
        self.pid = None
        self.log_path = None
        self._killed = False
        self._cached_url: Optional[str] = None

    @property
    def url(self) -> Optional[str]:
        # cached at first read: a kill()'d listener can no longer say
        # where it WAS bound, and reap() must still deregister that
        # URL off the router's roster
        if self._cached_url is None:
            try:
                self._cached_url = self.server.url().rstrip("/")
            except RuntimeError:
                return None  # stopped before ever read
        return self._cached_url

    def wait_listening(self, timeout_s: float) -> Optional[str]:
        return self.url

    def alive(self) -> bool:
        return not self._killed and self.gateway.ready

    def drain(self) -> None:
        def run():
            self.gateway.close()
            self.server.stop()
            self._killed = True

        threading.Thread(
            target=run, name=f"keystone-{self.name}-drain", daemon=True
        ).start()

    def kill(self) -> None:
        self._killed = True
        self.server.stop()
        self.gateway.close(timeout=1.0)

    def wait(self, timeout_s: float) -> bool:
        deadline = time.perf_counter() + timeout_s
        while time.perf_counter() < deadline:
            if self._killed:
                return True
            time.sleep(0.05)
        return self._killed

    def status(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "url": self.url,
            "pid": None,
            "alive": self.alive(),
            "log": None,
        }


class InprocLauncher:
    """Build replicas in-process via a caller-supplied
    ``factory(index) -> (gateway, server)`` (server already started).
    The bench row's path: the supervisor/policy/controller machinery
    runs for real while replicas cost threads, not processes. The
    factory owns registration semantics; by default the supervisor
    POSTs ``/registerz`` and ``/deregisterz`` for these replicas."""

    self_registering = False
    self_deregistering = False

    def __init__(self, factory: Callable[[int], tuple]):
        self.factory = factory

    def launch(self, index: int) -> InprocReplica:
        gateway, server = self.factory(index)
        return InprocReplica(gateway, server, f"replica-{index}")


class Supervisor:
    """Converge a replica set to a target count over one launcher.

    Thread-safety: ``scale_to``/``reap``/``stop`` are called from the
    controller's single loop thread (plus ``stop`` from shutdown);
    the lock guards only the handle list and the target — launches,
    drains, HTTP, and process waits all run outside it."""

    def __init__(
        self,
        launcher,
        router_url: Optional[str] = None,
        *,
        startup_timeout_s: float = STARTUP_TIMEOUT_S,
        drain_timeout_s: float = DRAIN_TIMEOUT_S,
        on_event: Optional[Callable[[Dict[str, Any]], None]] = None,
    ):
        self.launcher = launcher
        self.router_url = (
            router_url.rstrip("/") if router_url else None
        )
        self.startup_timeout_s = float(startup_timeout_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self._on_event = on_event
        self._lock = threading.Lock()
        self._handles: List = []  # guarded-by: _lock
        self._target = 0  # guarded-by: _lock
        self._next_index = 0  # guarded-by: _lock
        self._replaced_total = 0  # guarded-by: _lock
        self._stopped = False  # guarded-by: _lock

    # -- introspection ------------------------------------------------------

    @property
    def target(self) -> int:
        with self._lock:
            return self._target

    def replicas(self) -> List:
        with self._lock:
            return list(self._handles)

    @property
    def replaced_total(self) -> int:
        with self._lock:
            return self._replaced_total

    def status(self) -> Dict[str, Any]:
        handles = self.replicas()
        return {
            "target": self.target,
            "running": sum(1 for h in handles if h.alive()),
            "replaced_total": self.replaced_total,
            "replicas": [h.status() for h in handles],
        }

    def _event(self, event: str, **fields: Any) -> None:
        doc = {"event": event, **fields}
        logger.info("supervisor: %s", json.dumps(doc))
        if self._on_event is not None:
            try:
                self._on_event(doc)
            except Exception:
                logger.exception("supervisor event sink failed")

    # -- growth -------------------------------------------------------------

    def _launch_one(self) -> Optional[Any]:
        """Launch + handshake + (maybe) register ONE replica; returns
        the handle once it's a routable fleet member, None on a
        launch that never bound (the dead handle is reaped away)."""
        with self._lock:
            if self._stopped:
                return None
            index = self._next_index
            self._next_index += 1
        t0 = time.perf_counter()
        handle = self.launcher.launch(index)
        url = handle.wait_listening(self.startup_timeout_s)
        start_s = time.perf_counter() - t0
        if url is None:
            self._event(
                "replica_failed_to_start",
                name=handle.name, pid=handle.pid,
            )
            handle.kill()
            return None
        if (
            not getattr(self.launcher, "self_registering", False)
            and self.router_url is not None
        ):
            self._register(url)
        with self._lock:
            if self._stopped:
                stopped = True
            else:
                self._handles.append(handle)
                stopped = False
        if stopped:
            # stop() won the race: this replica must not outlive the
            # supervisor — retire it instead of appending
            self._retire_handle(handle)
            return None
        self._event(
            "replica_started",
            name=handle.name, url=url, pid=handle.pid, start_s=round(start_s, 3),
        )
        return handle

    def _register(self, url: str) -> None:
        from keystone_tpu_torch.fleet.client import REGISTER_ROUTE, post_roster

        try:
            post_roster(self.router_url, REGISTER_ROUTE, url, timeout_s=10)
        except Exception as e:
            logger.warning(
                "supervisor: register of %s failed: %s", url, e
            )

    # -- retirement ---------------------------------------------------------

    def _deregister(self, url: str) -> None:
        """The one roster-removal seam (retirement AND reap use it)."""
        if self.router_url is not None and url:
            deregister_replica(self.router_url, url)

    def _retire_handle(self, handle) -> None:
        """The three-step exit (deregister -> drain -> bounded wait ->
        kill), run on the caller's thread. A self-deregistering replica
        leaves the roster itself on SIGTERM, before it drains."""
        url = handle.url
        self_deregisters = getattr(self.launcher, "self_deregistering", False)
        if not self_deregisters:
            self._deregister(url)
        handle.drain()
        drained = handle.wait(self.drain_timeout_s)
        if not drained:
            logger.warning(
                "supervisor: %s did not drain within %.0fs; killing",
                handle.name, self.drain_timeout_s,
            )
            handle.kill()
            handle.wait(5.0)
            if self_deregisters:
                self._deregister(url)
        self._event("replica_retired", name=handle.name, url=url, drained=drained)

    def _retire_async(self, handle) -> None:
        threading.Thread(
            target=self._retire_handle,
            args=(handle,),
            name=f"keystone-retire-{handle.name}",
            daemon=True,
        ).start()

    def _launch_many(self, n: int) -> int:
        """Launch ``n`` replicas CONCURRENTLY and wait for their
        handshakes; returns how many came up. Serial launches would
        multiply scale-out reaction time by the shortfall — a
        capacity-plan feed-forward jump exists precisely so a big
        load step costs ONE cold start of wall clock, not N."""
        if n <= 0:
            return 0
        if n == 1:
            return 1 if self._launch_one() is not None else 0
        results: List = []
        res_lock = threading.Lock()

        def run():
            handle = self._launch_one()
            with res_lock:
                results.append(handle)

        threads = [
            threading.Thread(
                target=run, name="keystone-launch", daemon=True
            )
            for _ in range(n)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return sum(1 for h in results if h is not None)

    # -- the convergence entry points ---------------------------------------

    def scale_to(self, n: int) -> int:
        """Converge toward ``n`` replicas: launch the shortfall
        concurrently (each waits out its handshake), retire the
        excess newest-first on background drain threads. Returns the
        new target."""
        if n < 0:
            raise ValueError(f"target must be >= 0, got {n}")
        with self._lock:
            if self._stopped:
                return self._target
            self._target = n
            excess = []
            while len(self._handles) > n:
                # newest-first: the longest-lived replicas hold the
                # warmest caches and the steadiest health history
                excess.append(self._handles.pop())
            shortfall = n - len(self._handles)
        for handle in excess:
            self._retire_async(handle)
        self._launch_many(shortfall)
        return n

    def reap(self) -> int:
        """Detect replicas that died WITHOUT being retired, drop them
        from the roster (deregistering the stale URL), and launch
        replacements up to the target. Returns how many replacements
        actually CAME UP — a death whose replacement failed to start
        must not count as healed (deaths themselves are visible as
        ``replica_died`` events either way)."""
        with self._lock:
            if self._stopped:
                return 0
            dead = [h for h in self._handles if not h.alive()]
            for h in dead:
                self._handles.remove(h)
            target = self._target
            live = len(self._handles)
        for handle in dead:
            url = handle.url
            self._deregister(url)
            self._event(
                "replica_died", name=handle.name, url=url,
                pid=handle.pid,
            )
        launched = self._launch_many(max(0, target - live))
        # launches covering a shortfall that existed WITHOUT a death
        # (an earlier launch that never bound) are convergence, not
        # repair — only death-attributable launches count as replaced
        replaced = min(launched, len(dead))
        if dead:
            with self._lock:
                self._replaced_total += replaced
            self._event(
                "replicas_replaced", died=len(dead), replaced=replaced,
            )
        return replaced

    def stop(self) -> None:
        """Retire every replica (waited on — process exit must not
        strand children; retirements run concurrently so shutdown
        costs one drain, not N) and refuse further work."""
        with self._lock:
            self._stopped = True
            handles, self._handles = self._handles, []
            self._target = 0
        if not handles:
            return
        if len(handles) == 1:
            self._retire_handle(handles[0])
            return
        threads = [
            threading.Thread(
                target=self._retire_handle,
                args=(handle,),
                name=f"keystone-retire-{handle.name}",
                daemon=True,
            )
            for handle in handles
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()


__all__ = [
    "DRAIN_TIMEOUT_S",
    "STARTUP_TIMEOUT_S",
    "InprocLauncher",
    "InprocReplica",
    "SubprocessLauncher",
    "SubprocessReplica",
    "Supervisor",
    "deregister_replica",
]
