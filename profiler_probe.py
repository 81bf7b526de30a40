"""What a serving lane's CUDA graphs need before a later trace can see
them, and what the first trace of a process costs.

    python3 profiler_probe.py

Runs each (step, workload) pair below in a fresh ``python3``, so each
starts with the profiler and CUPTI never used. The steps, taken once
right after the CUDA context is up and timed:

- ``none``: nothing;
- ``session``: one full ``torch.profiler.profile`` session with CPU and
  CUDA activities around one small kernel (what a Gateway on the card
  took before its lanes until this script showed it was not needed);
- ``inductor_import``: ``import torch._inductor.config``, which a
  ``torch.profiler.profile`` session does when it starts (no CUPTI);
- ``kineto_cuda``: an empty ``torch.autograd.profiler.profile`` with
  the CUDA activity (Kineto and CUPTI without ``torch.profiler``'s
  wrapper).

The workloads then run on the card and are traced for one second by
``observability/profilez.profilez_document`` (what ``/profilez`` answers
with; ``trace_s`` is its wall time, the capture's second included):

- ``gateway``: a ``Gateway`` of the demo chain (d 256, hidden 512, depth
  4; buckets 8, 64; two pipelined lanes) under 8 client threads;
- ``graph_main``: a CUDA graph captured on a side stream, replayed by the
  main thread;
- ``graph_thread``: the same graph replayed by a thread started before
  the trace;
- ``graph_thread_captured``: a graph captured and replayed by a thread.

Prints one JSON line per pair (the step's seconds, the trace's seconds,
the kernel events and ``cudaGraphLaunch`` calls in the trace), then the
card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

STEPS = ("none", "session", "inductor_import", "kineto_cuda")
WORKLOADS = ("gateway", "graph_main", "graph_thread", "graph_thread_captured")


def take_step(step):
    import torch

    if step == "session":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
    elif step == "inductor_import":
        import torch._inductor.config  # noqa: F401
    elif step == "kineto_cuda":
        with torch.autograd.profiler.profile(use_device="cuda", use_kineto=True):
            pass


def read_trace(doc):
    kernels, graph_launches = 0, 0
    for fname in doc["files"]:
        with open(os.path.join(doc["trace_dir"], fname)) as f:
            events = json.load(f)["traceEvents"]
        kernels += sum(e.get("cat") == "kernel" for e in events)
        graph_launches += sum(e.get("name") == "cudaGraphLaunch" for e in events)
    return {"kernels": kernels, "graph_launches": graph_launches}


def small_graph(stream):
    import torch

    x = torch.randn(64, 256, device="cuda")
    w = torch.randn(256, 256, device="cuda")
    with torch.cuda.stream(stream):
        for _ in range(3):
            torch.tanh(x @ w)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=stream):
        y = torch.tanh(x @ w)
    return g, y


def child(step, workload):
    t = time.perf_counter()
    import numpy as np
    import torch

    from keystone_tpu_torch.observability.profilez import profilez_document

    rec = {"step": step, "workload": workload, "import_s": time.perf_counter() - t}
    t = time.perf_counter()
    torch.ones(1, device="cuda")
    torch.cuda.synchronize()
    rec["cuda_init_s"] = time.perf_counter() - t
    t = time.perf_counter()
    take_step(step)
    rec["step_s"] = time.perf_counter() - t
    stop = threading.Event()
    threads = []
    if workload == "gateway":
        from keystone_tpu_torch.gateway import lifecycle
        from keystone_tpu_torch.serving.bench import build_pipeline

        gw = lifecycle.Gateway(build_pipeline(256, 512, 4), buckets=(8, 64), n_lanes=2,
                               pipeline_depth=2, device="cuda",
                               warmup_example=np.zeros(256, np.float32))
        x = np.ones(256, np.float32)

        def client():
            while not stop.is_set():
                gw.predict(x).result(timeout=60)

        threads = [threading.Thread(target=client) for _ in range(8)]
    else:
        stream = torch.cuda.Stream()
        if workload == "graph_thread_captured":
            ready = threading.Event()

            def client():
                g, _ = small_graph(stream)
                ready.set()
                while not stop.is_set():
                    g.replay()
                    stream.synchronize()

            threads = [threading.Thread(target=client)]
        else:
            g, _ = small_graph(stream)

            def client():
                while not stop.is_set():
                    g.replay()
                    stream.synchronize()

            if workload == "graph_thread":
                threads = [threading.Thread(target=client)]
    for th in threads:
        th.start()
    if workload == "graph_thread_captured":
        ready.wait(60)
    base = tempfile.mkdtemp(prefix="probe-")
    t = time.perf_counter()
    if workload == "graph_main":
        th = threading.Thread(target=lambda: rec.update(profilez=profilez_document("1.0", base)))
        th.start()
        while th.is_alive():
            g.replay()
            stream.synchronize()
        th.join()
    else:
        time.sleep(0.5)
        t = time.perf_counter()
        rec["profilez"] = profilez_document("1.0", base)
    rec["trace_s"] = time.perf_counter() - t
    stop.set()
    for th in threads:
        th.join()
    code, doc = rec.pop("profilez")
    rec["profilez_code"] = code
    rec.update(read_trace(doc) if code == 200 else {"error": doc})
    if workload == "gateway":
        gw.close()
    print(json.dumps(rec), flush=True)


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    for workload in WORKLOADS:
        # the graph workloads locate the cause: with no step and with the
        # full session; the gateway takes every step
        for step in STEPS if workload == "gateway" else ("none", "session"):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), step, workload],
                                  capture_output=True, text=True, timeout=300, cwd=ROOT)
            line = next((ln for ln in reversed(proc.stdout.splitlines()) if ln.startswith("{")),
                        None)
            print(line or json.dumps({"step": step, "workload": workload, "rc": proc.returncode,
                                      "stderr": proc.stderr[-1500:]}), flush=True)
    print(smi)


if __name__ == "__main__":
    if len(sys.argv) == 3:
        child(*sys.argv[1:])
    else:
        main()
