"""How the port's Gateway starts, on the CPU: no profiler session among its
steps, and a ``/profilez`` trace (``utils/profiling.trace``) that needs no
step first and imports no ``torch._inductor`` (whose import a
``torch.profiler`` session makes, and which took about 8 s of a fresh
process on an H100 host). Small shapes; the trace runs in a fresh
interpreter so that nothing this process imported hides an import."""

import json
import subprocess
import sys

import numpy as np
import torch

from keystone_tpu_torch.gateway import Gateway
from keystone_tpu_torch.observability.registry import MetricsRegistry
from keystone_tpu_torch.serving import bench as tbench

D = 8


def test_a_cpu_gateway_opens_no_profiler_session(monkeypatch):
    opened = []
    for owner in (torch.profiler.profile, torch.autograd.profiler.profile):
        init = owner.__init__

        def spy(self, *a, _init=init, **k):
            opened.append(type(self).__name__)
            _init(self, *a, **k)

        monkeypatch.setattr(owner, "__init__", spy)
    gw = Gateway(tbench.build_pipeline(d=D, hidden=8, depth=2, device="cpu"), buckets=(2, 4),
                 n_lanes=2, device="cpu", warmup_example=np.zeros(D, np.float32),
                 name="start-cpu", registry=MetricsRegistry())
    try:
        out = gw.predict(np.ones(D, np.float32)).result(timeout=60)
    finally:
        gw.close(timeout=10)
    assert opened == []
    assert "profiler" not in gw.startup_s
    assert set(gw.startup_s) == {"lanes", "warmup"}
    assert np.isfinite(out).all()


FIRST_TRACE = r"""
import json, os, sys, tempfile, threading, time
import torch
from keystone_tpu_torch.observability.profilez import profilez_document
from keystone_tpu_torch.serving import bench
x = torch.ones(64, 64)
stop = threading.Event()
def work():
    while not stop.is_set():
        torch.tanh(x @ x)
t = threading.Thread(target=work)
t.start()
code, doc = profilez_document("0.3", tempfile.mkdtemp())
stop.set()
t.join()
names = set()
for f in doc["files"]:
    with open(os.path.join(doc["trace_dir"], f)) as fh:
        names |= {e.get("name") for e in json.load(fh)["traceEvents"]}
print(json.dumps({"code": code, "inductor": "torch._inductor" in sys.modules,
                  "dynamo": "torch._dynamo" in sys.modules, "mm": "aten::mm" in names}))
"""


def test_a_first_trace_takes_no_step_first_and_imports_no_inductor():
    proc = subprocess.run([sys.executable, "-c", FIRST_TRACE], capture_output=True, text=True,
                          timeout=300, check=True)
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    # the worker thread started before the trace, and its ops are in it
    assert doc == {"code": 200, "inductor": False, "dynamo": False, "mm": True}
