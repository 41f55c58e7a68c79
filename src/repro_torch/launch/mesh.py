"""The launcher's mesh and process group (the counterpart of
``repro/launch/mesh.py``).

One process per device: ``--mesh DxM`` (or ``PxDxM``) names a
``torch.distributed.device_mesh.DeviceMesh`` over ``D*M`` (or ``P*D*M``)
processes with the reference's axis names, ("data", "model") or ("pod",
"data", "model").  A "model" axis larger than 1 is tensor and expert
parallelism, in the server (``launch/serve.py``, ``--mesh 1xM``) and in the
training launcher (``launch/train.py``, ``--mesh DxM``).

Launching two processes on the CPU::

    # terminal 1                                   # terminal 2
    python -m repro_torch.launch.train --arch gpt-proxy --vcycle \\
        --device cpu --mesh 2x1 --coordinator 127.0.0.1:PORT \\
        --num-processes 2 --process-id 0 ...        # ... --process-id 1 ...

The process-group backend is chosen by rule: gloo on the CPU; NCCL when
every rank has a CUDA card of its own; gloo with CUDA tensors when ranks
share a card (NCCL refuses two ranks on one device).  The group is made on
an explicit store -- a ``TCPStore`` hosted by process 0 at the coordinator
address, or an in-process ``HashStore`` for one rank -- which
``distributed/multiprocess.py``'s barrier and key-value exchanges reach.
``--coordinator file://PATH`` (processes on one host) lets process 0 bind a
free port itself and publish it in PATH.

The dry run (``launch/dryrun.py``) plays one rank of the reference's
production meshes (:func:`make_production_mesh`) on PyTorch's fake
process-group backend, and prices them with the card's constants below.
"""
from __future__ import annotations

import os
import time
from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.config import MeshConfig
from repro_torch.device import default_device
from repro_torch.distributed.multiprocess import bind_store

def parse_mesh_arg(spec: str) -> Tuple[int, ...]:
    """``"DxM"`` -> (data, model); ``"PxDxM"`` -> (pod, data, model)."""
    try:
        dims = tuple(int(p) for p in spec.lower().split("x"))
    except ValueError:
        raise ValueError(
            f"--mesh expects DxM or PxDxM (e.g. 2x4 or 2x2x1), "
            f"got {spec!r}") from None
    if len(dims) not in (2, 3) or any(d < 1 for d in dims):
        raise ValueError(
            f"--mesh expects 2 or 3 axes >= 1 (DxM or PxDxM), got {spec!r}")
    return dims


def mesh_axes(dims: Tuple[int, ...]) -> Tuple[str, ...]:
    return ("pod", "data", "model") if len(dims) == 3 else ("data", "model")


def backend_for(device, num_processes: int) -> str:
    """The process-group backend for ``num_processes`` ranks on ``device``
    (see the module docstring)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "gloo"
    if dev.type == "cuda" and num_processes <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device, process_id: int) -> torch.device:
    """This rank's device: its own card when every rank has one, else the
    shared card (or the CPU)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    n = torch.cuda.device_count()
    return torch.device("cuda", process_id % n if n else 0)


def init_distributed(coordinator: str, num_processes: int, process_id: int, *,
                     device=None, timeout_s: float = 600.0) -> str:
    """Join the default process group on a ``TCPStore`` at ``coordinator``
    and return the backend; the store is kept for the key-value exchanges
    (``multiprocess.bind_store``).  ``coordinator`` is HOST:PORT (process 0
    hosts the store there) or ``file://PATH`` (see :func:`_coordinator_store`).
    A no-op returning the live backend when the group is already up.
    ``device`` is the CUDA card unless given (see
    ``repro_torch.device.default_device``)."""
    device = default_device(device)
    if dist.is_initialized():
        return dist.get_backend()
    import datetime

    backend = backend_for(device, num_processes)
    kw = {}
    if backend == "nccl":
        kw["device_id"] = rank_device(device, process_id)
        torch.cuda.set_device(kw["device_id"])
    timeout = datetime.timedelta(seconds=timeout_s)
    store = _coordinator_store(coordinator, num_processes, process_id, timeout)
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id, timeout=timeout, **kw)
    bind_store(store)
    return backend


def _coordinator_store(coordinator: str, num_processes: int, process_id: int,
                       timeout) -> "dist.TCPStore":
    """The group's ``TCPStore``.  At HOST:PORT process 0 binds PORT.  At
    ``file://PATH`` process 0 binds a port of its own on 127.0.0.1 (the
    system's pick, held from then on) and writes its HOST:PORT to PATH in one
    rename; the others wait for PATH and connect there.  So no port is
    picked, released and bound again while other programs on the host may
    take it.  PATH must be one no earlier group wrote."""
    if not coordinator.startswith("file://"):
        host, port = coordinator.rsplit(":", 1)
        return dist.TCPStore(host, int(port), num_processes, process_id == 0, timeout=timeout)
    path = coordinator[len("file://"):]
    if process_id == 0:
        store = dist.TCPStore("127.0.0.1", 0, num_processes, True, timeout=timeout,
                              wait_for_workers=False)
        with open(f"{path}.{os.getpid()}.part", "w") as f:
            f.write(f"127.0.0.1:{store.port}")
        os.replace(f"{path}.{os.getpid()}.part", path)
        return store
    deadline = time.monotonic() + timeout.total_seconds()
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no coordinator address at {path} after {timeout}")
        time.sleep(0.01)
    with open(path) as f:
        host, port = f.read().rsplit(":", 1)
    return dist.TCPStore(host, int(port), num_processes, False, timeout=timeout)


def _init_single(device) -> None:
    """A one-rank default group on an in-process store (no port needed)."""
    if dist.is_initialized():
        return
    backend = backend_for(device, 1)
    kw = {}
    if backend == "nccl":
        kw["device_id"] = rank_device(device, 0)
        torch.cuda.set_device(kw["device_id"])
    store = dist.HashStore()
    dist.init_process_group(backend, store=store, world_size=1, rank=0, **kw)
    bind_store(store)


def _device_mesh(dims: Tuple[int, ...], device):
    from torch.distributed.device_mesh import init_device_mesh

    axes = mesh_axes(dims)
    total = 1
    for d in dims:
        total *= d
    if dist.get_world_size() != total:
        raise RuntimeError(f"mesh {'x'.join(map(str, dims))} needs {total} processes, "
                           f"the process group has {dist.get_world_size()}")
    dev_type = "cuda" if torch.device(device).type == "cuda" else "cpu"
    return init_device_mesh(dev_type, dims, mesh_dim_names=axes)


def make_cli_mesh(spec: str, *, num_processes: int = 1, device=None):
    """The launcher's ``--mesh`` as a ``DeviceMesh``, one device per
    process: ("data", "model") for ``DxM``, ("pod", "data", "model") for
    ``PxDxM``, on the CUDA card unless ``device`` is given.  With one
    process and no process group, a one-rank group on an in-process store is
    made first; with several, the caller has run :func:`init_distributed`."""
    dims = parse_mesh_arg(spec)
    total = 1
    for d in dims:
        total *= d
    if total != num_processes:
        raise ValueError(f"--mesh {spec} has {total} devices; this port runs one "
                         f"process per device, so it needs --num-processes {total}, "
                         f"not {num_processes}")
    device = default_device(device)
    if num_processes == 1:
        _init_single(device)
    elif not dist.is_initialized():
        raise RuntimeError("a mesh over several processes needs init_distributed first")
    return _device_mesh(dims, device)


def make_host_mesh(n_data: int = 1, n_model: int = 1, *, device=None):
    """A ("data", "model") mesh of ``n_data x n_model`` over the processes
    of the default group (tests and the CPU; the caller has run
    :func:`init_distributed` when there are several), on the CUDA card
    unless ``device`` is given."""
    return make_cli_mesh(f"{n_data}x{n_model}", num_processes=n_data * n_model,
                         device=device)


# the dry run's two target shapes (the reference's): one 256-device mesh and
# two of them behind a leading "pod" axis
PRODUCTION_MESHES = {
    "16x16": MeshConfig((16, 16), ("data", "model")),
    "2x16x16": MeshConfig((2, 16, 16), ("pod", "data", "model")),
}


def make_production_mesh(multi_pod: bool = False, rank: int = 0):
    """The dry run's mesh: 16x16 ("data", "model") or 2x16x16 ("pod",
    "data", "model"), this process acting as ``rank`` of 256 or 512
    (:func:`make_fake_mesh`)."""
    return make_fake_mesh(PRODUCTION_MESHES["2x16x16" if multi_pod else "16x16"], rank)


def make_fake_mesh(cfg: MeshConfig, rank: int = 0):
    """A ``DeviceMesh`` of ``cfg``'s shape and axes whose default process
    group is PyTorch's fake backend
    (``torch.testing._internal.distributed.fake_pg``), this process acting
    as ``rank``: every collective on a meta tensor completes at once, and a
    ``TorchDispatchMode`` sees it as a ``c10d`` op with its group
    (``launch/op_cost.py``).  The group is process-global, so the dry run
    runs in a process of its own; a live group of another size or rank is
    refused.  Nothing touches a card."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = cfg.n_devices
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != n or \
                dist.get_rank() != rank:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks "
                               f"({dist.get_backend()}) is live; a {n}-rank fake mesh "
                               f"needs a process of its own")
    else:
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n)
    return init_device_mesh("cpu", cfg.shape, mesh_dim_names=cfg.axes)


# Roofline constants of the NVIDIA H100 SXM5 80GB, from its spec sheet (not
# measured); the card the port runs on reports itself to ``nvidia-smi
# --query-gpu=name,power.limit --format=csv,noheader`` as "NVIDIA H100 80GB
# HBM3, 700.00 W".  ``chip_smoke.py`` measures its matmul rate and copy
# bandwidth beside them.
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12  # B/s
NVLINK_BW = 450e9  # B/s per direction per GPU, inside a node of 8
IB_BW = 50e9  # B/s per GPU across nodes (400 Gb/s NDR)
HBM_BYTES = 80 * 2 ** 30
NODE_SIZE = 8  # GPUs a node joins over NVLink
