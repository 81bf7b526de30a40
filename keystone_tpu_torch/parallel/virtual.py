"""Several processes joined into one group, for multi-process code paths
without a cluster (counterpart of ``keystone_tpu/parallel/virtual.py``).

The reference tests simulate a cluster with multi-partition local RDDs
(SURVEY.md §4); the JAX package gives one process n virtual CPU devices.
The port runs one process per device, so its counterpart is a launcher:
``launch(fn, n)`` starts n processes, joins them into one
``torch.distributed`` group (gloo on the CPU, NCCL with one card each on
``cuda``), runs ``fn(*args)`` in each and returns their results in rank
order. The tests and ``chip_smoke.py`` share it.

- The processes rendezvous through a ``FileStore`` in a fresh temporary
  directory, so launches in parallel test workers never race for a port.
- They start with the ``spawn`` method: each imports only what ``fn``'s
  module imports (the port imports no JAX), and no CUDA state is forked.
- Every launch has a time limit. Each rank's collectives time out after
  ``timeout_s`` (``init_process_group(timeout=...)``), and the parent
  kills every process and raises once ``timeout_s`` has passed since the
  launch, or as soon as one process fails.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

# a launch's default limit, start-up (about 8 s a process on the card's
# host) included
DEFAULT_TIMEOUT_S = 120.0


def backend_initialized() -> bool:
    """Whether this process has joined a process group."""
    return dist.is_initialized()


def _to_host(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _worker(rank: int, world: int, root: str, device: str, fn: Callable, args: tuple,
            timeout_s: float, threads: Optional[int]) -> None:
    from keystone_tpu_torch.parallel import runtime

    out = os.path.join(root, f"rank{rank}.pkl")
    try:
        if threads:
            torch.set_num_threads(threads)
        store = dist.FileStore(os.path.join(root, "store"), world)
        runtime.join(rank, world, device=device, store=store, timeout_s=timeout_s)
        try:
            result = {"ok": _to_host(fn(*args))}
        finally:
            runtime.shutdown()
    except BaseException:
        result = {"error": traceback.format_exc()}
    with open(out + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out + ".tmp", out)
    if "error" in result:
        os._exit(1)


def launch(fn: Callable, n: int, args: Sequence = (), *, device: str = "cpu",
           timeout_s: float = DEFAULT_TIMEOUT_S, threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(*args)`` in ``n`` processes joined into one group and
    return the results (tensors moved to the CPU) in rank order.
    ``fn`` must be picklable (a module-level function). ``device``
    ``"cuda"`` needs ``n`` cards (NCCL, one card a process); ``"cpu"``
    uses gloo, with ``threads`` intra-op threads a process when given.
    Raises ``RuntimeError`` with the first failing rank's traceback, or
    ``TimeoutError`` naming the ranks still running at the limit; either
    way no process is left behind."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("launch(device='cuda') needs CUDA, which is not available here")
        if torch.cuda.device_count() < n:
            raise RuntimeError(
                f"launch(device='cuda') of {n} processes needs {n} cards; this host has "
                f"{torch.cuda.device_count()} (NCCL cannot share one card between ranks)"
            )
    elif device != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    ctx = multiprocessing.get_context("spawn")
    root = tempfile.mkdtemp(prefix="keystone_launch_")
    procs = [
        ctx.Process(target=_worker, args=(r, n, root, device, fn, tuple(args), timeout_s, threads),
                    daemon=True)
        for r in range(n)
    ]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed:
                break
            if time.monotonic() > deadline:
                running = [r for r, p in enumerate(procs) if p.is_alive()]
                raise TimeoutError(
                    f"launch of {n} processes passed its {timeout_s:.0f} s limit; "
                    f"ranks {running} still running"
                )
            time.sleep(0.05)
        results = []
        for r, p in enumerate(procs):
            path = os.path.join(root, f"rank{r}.pkl")
            got = None
            if os.path.exists(path):
                with open(path, "rb") as f:
                    got = pickle.load(f)
            if p.exitcode != 0 or got is None or "error" in got:
                failed = [q for q in range(n) if procs[q].exitcode not in (None, 0)] or [r]
                f = os.path.join(root, f"rank{failed[0]}.pkl")
                why = f"exit code {procs[failed[0]].exitcode}, no result"
                if os.path.exists(f):
                    with open(f, "rb") as fh:
                        why = pickle.load(fh).get("error", why)
                raise RuntimeError(f"rank {failed[0]} of {n} failed:\n{why}")
            results.append(got["ok"])
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
        shutil.rmtree(root, ignore_errors=True)
