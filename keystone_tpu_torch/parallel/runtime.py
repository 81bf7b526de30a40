"""The multi-process runtime (counterpart of
``keystone_tpu/parallel/runtime.py``).

The reference's distributed substrate is a Spark cluster launched by
``bin/run-pipeline.sh:9-55``. The JAX package's is an SPMD process group,
one process per host joined by ``jax.distributed.initialize``. The
port's is one process per card joined by ``torch.distributed``: every
process runs the same program, reductions over examples are
``all_reduce``s (``mesh.py``) and the small solves after them run on
every rank. A CUDA run uses NCCL, each process on the card of its local
rank (``torch.cuda.set_device`` before the group is made); a CPU run uses
gloo. A CUDA run never falls back to gloo, and without a card it raises.

Launch, one process per card::

    torchrun --nproc-per-node 8 -m keystone_tpu_torch TimitPipeline ...

or with the JAX package's variables (one command per process)::

    COORDINATOR_ADDRESS=host:port NUM_PROCESSES=2 PROCESS_ID=0 \\
        python -m keystone_tpu_torch TimitPipeline ...

Axis layout: ``dcn`` is the node axis (only data parallelism crosses
it), ``data`` the example axis within a node, ``model`` the feature axis.
"""

from __future__ import annotations

import atexit
import datetime
import logging
import os
import socket
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from keystone_tpu_torch.parallel import mesh as mesh_lib
from keystone_tpu_torch.parallel.mesh import DATA_AXIS, DCN_AXIS, MODEL_AXIS, Mesh

logger = logging.getLogger(__name__)

# how long a rank waits in a collective, or for the others to join
DEFAULT_TIMEOUT_S = 600.0

_initialized = False
_devices: Optional[List[torch.device]] = None  # every rank's device, once joined
_nodes: Optional[List[int]] = None  # every rank's node index, once joined

_JAX_VARS = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")
_TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _own_device() -> torch.device:
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_initialized() else 0)
    return torch.device("cpu")


def process_devices() -> List[torch.device]:
    """Every rank's device, in rank order (one process that joined no
    group: its own card, else the CPU)."""
    return list(_devices) if _devices is not None else [_own_device()]


def process_nodes() -> List[int]:
    """Every rank's node (host) index, in rank order."""
    return list(_nodes) if _nodes is not None else [0]


def setup_aot_cache(cache_dir: Optional[str] = None) -> Optional[str]:
    """The port's AOT store directory (``serving/aot.py``): the kernel
    libraries and each bucket's operators."""
    from keystone_tpu_torch.serving import aot

    return aot.setup_aot_cache(cache_dir)


def aot_cache_dir() -> Optional[str]:
    from keystone_tpu_torch.serving import aot

    return aot.aot_cache_dir()


def _looks_like_cluster() -> bool:
    """Whether this process appears to be one of several launched
    together — where running alone would fit a separate model per
    process: JAX's pod signals, torchrun's, Slurm's and MPI's."""
    for var in ("TPU_WORKER_HOSTNAMES", "TPU_PROCESS_ADDRESSES"):
        if "," in os.environ.get(var, ""):
            return True
    for var in ("MEGASCALE_NUM_SLICES", "LOCAL_WORLD_SIZE", "SLURM_NTASKS",
                "OMPI_COMM_WORLD_SIZE", "PMI_SIZE"):
        try:
            if int(os.environ.get(var, "1")) > 1:
                return True
        except ValueError:
            pass
    return "TORCHELASTIC_RUN_ID" in os.environ


def _partial(names: Sequence[str], values: Sequence) -> Tuple[List[str], List[str]]:
    given = [k for k, v in zip(names, values) if v is not None]
    missing = [k for k, v in zip(names, values) if v is None]
    return given, missing


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    *,
    device=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join this process to the process group (idempotent).

    The group comes from the arguments or JAX's variables
    (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``), else
    from torchrun's (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``). The local rank picks the card:
    ``local_device_ids[0]``, else ``LOCAL_RANK``, else the process id
    modulo the host's cards. ``device`` (``None`` means ``cuda``) picks
    the backend: NCCL on ``cuda``, gloo on ``cpu``.

    Failure contract, as the JAX package's: a partial configuration
    raises ``ValueError`` naming what is missing; a complete one that
    cannot connect raises; with none, this is one process, unless the
    environment looks like part of a cluster, where it raises rather
    than train a separate model per process."""
    global _initialized
    if _initialized or dist.is_initialized():
        return
    env = os.environ
    coordinator_address = coordinator_address or env.get("COORDINATOR_ADDRESS")
    if num_processes is None and "NUM_PROCESSES" in env:
        num_processes = int(env["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in env:
        process_id = int(env["PROCESS_ID"])
    given, missing = _partial(_JAX_VARS, (coordinator_address, num_processes, process_id))
    if given and missing:
        raise ValueError(
            f"partial multi-process config: {'/'.join(given)} set but "
            f"{'/'.join(missing)} missing; set all three of COORDINATOR_ADDRESS / "
            "NUM_PROCESSES / PROCESS_ID (env or arguments), or none of them"
        )
    local = int(local_device_ids[0]) if local_device_ids else None
    if given:
        init_method = f"tcp://{coordinator_address}"
        rank, world = int(process_id), int(num_processes)
    else:
        tr_given, tr_missing = _partial(_TORCHRUN_VARS, [env.get(v) for v in _TORCHRUN_VARS])
        if tr_given and tr_missing:
            raise ValueError(
                f"partial torchrun config: {'/'.join(tr_given)} set but "
                f"{'/'.join(tr_missing)} missing"
            )
        if not tr_given:
            if _looks_like_cluster():
                raise RuntimeError(
                    "this process looks like one of several launched together "
                    "(a pod, torchrun, Slurm or MPI environment) but has no complete "
                    "process-group config; refusing to run alone, which would fit a "
                    "separate model per process"
                )
            logger.info("no multi-process config; one process")
            _initialized = True
            return
        init_method = "env://"
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    if local is None and "LOCAL_RANK" in env:
        local = int(env["LOCAL_RANK"])
    join(rank, world, device=device, local_rank=local, init_method=init_method,
         timeout_s=timeout_s)
    _initialized = True


def join(rank: int, world: int, *, device=None, local_rank: Optional[int] = None,
         init_method: Optional[str] = None, store=None,
         timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Make the process group (rank ``rank`` of ``world``) through
    ``init_method`` or ``store``, and return this rank's device: NCCL on
    card ``local_rank`` for ``cuda`` (set before the group is made), gloo
    for ``cpu``. Every rank's device and host are then gathered once."""
    global _devices, _nodes
    from keystone_tpu_torch._device import resolve_device

    dev = resolve_device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        local = rank % n if local_rank is None else local_rank
        if not 0 <= local < n:
            raise RuntimeError(f"local rank {local} has no card: this host has {n}")
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
        dist.init_process_group("nccl", init_method=init_method, store=store, rank=rank,
                                world_size=world, timeout=timeout, device_id=dev)
    else:
        dist.init_process_group("gloo", init_method=init_method, store=store, rank=rank,
                                world_size=world, timeout=timeout)
    info: list = [None] * world
    dist.all_gather_object(info, (str(dev), socket.gethostname()))
    hosts: List[str] = []
    for _, h in info:
        if h not in hosts:
            hosts.append(h)
    _devices = [torch.device(d) for d, _ in info]
    _nodes = [hosts.index(h) for _, h in info]
    mesh_lib.set_mesh(None)
    atexit.register(shutdown)
    logger.info("process group up: rank %d/%d on %s (%s)", rank, world, dev,
                dist.get_backend())
    return dev


def shutdown() -> None:
    """Leave the process group (idempotent; registered at exit by
    ``join``)."""
    global _initialized, _devices, _nodes
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False
    _devices = _nodes = None
    mesh_lib.set_mesh(None)


def multislice_shape(
    n_devices: int,
    n_slices: Optional[int] = None,
    n_model: int = 1,
) -> Tuple[int, int, int]:
    """The (dcn, data, model) mesh shape for ``n_devices``. ``n_slices``
    (nodes) defaults to the nodes of the process group (1 for one
    process); ``n_model`` divides the devices of a node, the rest is the
    data axis."""
    if n_slices is None:
        n_slices = len(set(process_nodes()))
    if n_devices % n_slices:
        raise ValueError(f"{n_devices} devices not divisible into {n_slices} slices")
    per_slice = n_devices // n_slices
    if per_slice % n_model:
        raise ValueError(
            f"per-slice device count {per_slice} not divisible by model axis {n_model}"
        )
    return n_slices, per_slice // n_model, n_model


def make_multislice_mesh(
    n_slices: Optional[int] = None,
    n_model: int = 1,
    devices: Optional[Sequence[torch.device]] = None,
) -> Mesh:
    """A (dcn, data, model) mesh whose ``dcn`` rows follow nodes: the
    ranks sorted by (node, rank), so collectives that cross nodes appear
    only on the ``dcn`` axis, and the example axis spans (dcn, data).
    ``devices`` builds it over this process's devices instead."""
    import numpy as np

    if devices is not None:
        devs, ranks, nodes = list(devices), None, [0] * len(devices)
    else:
        nodes = process_nodes()
        ranks = sorted(range(process_count()), key=lambda r: (nodes[r], r))
        all_devs = process_devices()
        devs = [all_devs[r] for r in ranks]
    shape = multislice_shape(
        len(devs), n_slices if n_slices is not None else len(set(nodes)), n_model
    )
    grid = np.empty(shape, dtype=object)
    grid.reshape(-1)[:] = devs
    rgrid = None if ranks is None else np.asarray(ranks).reshape(shape)
    return Mesh(grid, (DCN_AXIS, DATA_AXIS, MODEL_AXIS), rgrid)
