"""One CUDA graph for one static input: the capture core that
``FittedPipeline.jit``/``jit_batch`` (``workflow/api.py``) and the
serving engine's per-bucket graphs (``serving/engine.py``) share, so the
two cannot drift (the counterpart of the JAX package's ``_batch_run``
being the one staging surface of ``jit_batch`` and its engine).

``capture_graph`` runs a warm eager pass of the callable on a zero input
of the example's spec, on the given stream (it fills the operator and
band caches and builds the kernels, so that the capture finds no host
work), captures the callable into a ``torch.cuda.CUDAGraph`` that reads
the static input and writes a static output, and replays it once to
check it. ``replay_graph`` copies a batch into the static input on that
stream, replays, and returns a clone of the static output, so that the
next replay cannot overwrite what it returned; the caller's stream is
ordered after it.

The kernels' wrappers count launches in Python, so a replay would count
nothing: a graph keeps the launches its capture made
(``_cuda.capture_tally``) and adds them to ``_cuda.LAUNCHES`` on every
replay, the checking one included.

``GraphedFunction`` is ``jit``'s and ``jit_batch``'s callable: one graph
per distinct input spec on the card, the callable run eagerly on the CPU.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from keystone_tpu_torch import _cuda
from keystone_tpu_torch.parallel.dataset import _tree_map, tree_leaves


@dataclasses.dataclass
class CapturedGraph:
    """A captured CUDA graph: its static input and output trees, the
    kernel launches one replay makes, the seconds the warm pass, capture
    and checking replay took, and the device memory of its memory pool
    (shared pools: the whole pool's) after the capture."""

    graph: Any
    static_in: Any
    static_out: Any
    launches: Dict[str, int]
    capture_s: float
    pool_bytes: int
    # what the capture's kernels read beside static_in (the SIFT and LCS
    # operators, out of their bounded caches), kept for the graph's life
    refs: List[Any] = dataclasses.field(default_factory=list)

    def release(self) -> None:
        """Drop the graph and what it keeps (its pool is freed once no
        other graph shares it)."""
        self.static_in = self.static_out = None
        self.refs.clear()
        self.graph.reset()


def capture_graph(
    run: Callable[[Any], Any],
    example: Any,
    stream: Any,
    device: torch.device,
    *,
    warm: Optional[Callable[[Any], Any]] = None,
    pool: Any = None,
) -> CapturedGraph:
    """Warm pass (``warm``, by default ``run``), capture of ``run`` and
    one checking replay, for a static input of ``example``'s spec, on
    ``stream``. ``pool`` is another graph's memory pool to share.
    ``capture_error_mode="thread_local"``: a capture may run on one
    thread while others copy and allocate."""
    t0 = time.perf_counter()
    static_in = _tree_map(torch.zeros_like, example)
    with torch.cuda.stream(stream):
        stream.wait_stream(torch.cuda.current_stream(device))
        (warm or run)(static_in)
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    refs: List[Any] = []
    with _cuda.capture_tally(refs) as launches:
        # its entry empties the caching allocator first
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            static_out = run(static_in)
    pool_bytes = graph_pool_bytes(graph, device)
    with torch.cuda.stream(stream):
        graph.replay()
    _cuda.add_launches(launches)
    stream.synchronize()
    return CapturedGraph(
        graph, static_in, static_out, dict(launches),
        time.perf_counter() - t0, pool_bytes, refs,
    )


def replay_graph(
    g: CapturedGraph,
    staged: Any,
    stream: Any,
    device: torch.device,
    ready: Any = None,
    rows: Optional[int] = None,
) -> Any:
    """``staged`` copied into ``g``'s static input, one replay and a
    clone of the static output (its first ``rows`` rows when given), all
    on ``stream``, after the caller's stream and ``ready`` (an event).
    The caller's stream is ordered after the clone. Callers serialize
    replays of one graph."""
    caller = torch.cuda.current_stream(device)
    with torch.cuda.stream(stream):
        # the staged tensors were written on a copy stream (an upload,
        # ``ready``) or on the caller's stream
        stream.wait_stream(caller)
        if ready is not None:
            stream.wait_event(ready)
        for src, dst in zip(tree_leaves(staged), tree_leaves(g.static_in)):
            # the caching allocator must not hand src's memory to the
            # next upload while this stream still reads it
            src.record_stream(stream)
            dst.copy_(src)
        g.graph.replay()
        _cuda.add_launches(g.launches)
        if rows is None:
            out = _tree_map(lambda a: a.clone(), g.static_out)
        else:
            out = _tree_map(lambda a: a[:rows].clone(), g.static_out)
        done = torch.cuda.Event()
        done.record(stream)
    caller.wait_event(done)
    for a in tree_leaves(out):
        a.record_stream(caller)
    return out


def graph_pool_bytes(graph: Any, device: torch.device) -> int:
    """The bytes of ``graph``'s memory pool: the allocator's segments
    tagged with its pool id. (A ``memory_reserved`` delta around the
    capture also counts what the capture's own ``empty_cache`` frees, and
    what other threads allocate or free meanwhile.)"""
    pool = tuple(graph.pool())
    index = device.index if device.index is not None else torch.cuda.current_device()
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg["device"] == index and tuple(seg["segment_pool_id"]) == pool)


def input_spec(tree: Any) -> Any:
    """The tree's structure with each leaf's shape and dtype."""
    return _tree_map(lambda a: (tuple(a.shape), a.dtype), tree)


def _to_device(a: Any, device: torch.device) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a))
    return a.to(device)


class GraphedFunction:
    """``fn`` (tensor tree in, tensor tree out) as one CUDA graph per
    distinct input spec on a CUDA ``device``: a new spec is captured once
    (``capture_graph``), and every later call with it copies its input
    into the graph's static input, replays and returns a clone of the
    static output (``replay_graph``). A capture or replay that fails
    raises; nothing falls back to eager dispatch. On the CPU each call
    runs ``fn`` eagerly. Inputs that are not on ``device`` (numpy arrays,
    tensors elsewhere) are moved there first.

    Calls may come from several threads: captures and replays are
    serialized on one lock, on one stream of the callable's own, and the
    graphs of all specs share one memory pool, which is safe because
    their replays never overlap and each output is cloned before the
    next replay."""

    def __init__(self, fn: Callable[[Any], Any], device: torch.device):
        self.fn = fn
        self.device = device
        self._graphs: Dict[Any, CapturedGraph] = {}
        self._lock = threading.Lock()
        self._stream: Any = None
        self._pool: Any = None

    def __call__(self, x: Any) -> Any:
        x = _tree_map(lambda a: _to_device(a, self.device), x)
        with torch.no_grad():
            if self.device.type != "cuda":
                return self.fn(x)
            return self._graphed(x)

    def _graphed(self, x: Any) -> Any:
        key = input_spec(x)
        with self._lock:
            g = self._graphs.get(key)
            if g is None:
                if self._stream is None:
                    self._stream = torch.cuda.Stream(self.device)
                # lint: disable=blocking-under-lock
                # captures are serialized on purpose: one per input
                # spec, and none beside a replay (they share one stream
                # and one memory pool)
                g = capture_graph(self.fn, x, self._stream, self.device, pool=self._pool)
                if self._pool is None:
                    self._pool = g.graph.pool()
                self._graphs[key] = g
            return replay_graph(g, x, self._stream, self.device)

    @property
    def captures(self) -> int:
        """The graphs captured so far: one per distinct input spec."""
        return len(self._graphs)

    def graph_report(self) -> List[Dict[str, Any]]:
        """One entry per captured graph: input spec, capture seconds (warm
        pass and checking replay included), the bytes of the shared pool
        after its capture, and the launches of one replay."""
        return [
            {"spec": spec, "capture_s": g.capture_s, "pool_bytes": g.pool_bytes,
             "launches": dict(g.launches)}
            for spec, g in self._graphs.items()
        ]
