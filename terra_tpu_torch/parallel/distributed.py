"""Multi-process runtime on ``torch.distributed`` (port of
``terra_tpu/parallel/distributed.py``).

  * :func:`initialize` joins the process group: from the environment that
    ``torchrun`` (``python -m torch.distributed.run``) sets, or from an
    explicit coordinator address, process count and rank;
  * :func:`pod_mesh` builds the ('rows', 'samples') layout over every rank;
  * rendering and training then go through ``parallel.mesh`` and
    ``optim.make_train_step_sharded``: the counter-based RNG keys off global
    pixel ids, so every rank renders its part of the same image.

Each rank drives one device, named explicitly: ``cuda:(local_rank %
device_count)`` or the CPU. The backend is ``nccl`` on CUDA and ``gloo`` on
the CPU unless the caller names one. NCCL puts one rank on a card; several
ranks that share a card (the tests of the sharded paths on one GPU) take
``backend="gloo"`` with CUDA tensors, whose ``all_reduce``, ``broadcast``
and ``barrier`` are the only collectives the port uses. A CUDA request on
a machine without a card raises; nothing falls back to the CPU.
"""
from __future__ import annotations

import logging
import os
import socket
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, local_device, make_mesh

log = logging.getLogger("terra_tpu_torch")
# How long a collective waits for every rank before it fails: a rank that
# builds a 1M-triangle scene or writes a 4k checkpoint keeps the others
# waiting for tens of seconds.
TIMEOUT = timedelta(seconds=600)

__all__ = ["initialize", "pod_mesh", "is_coordinator", "local_device", "spawn_cpu"]


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               device: str = "cuda") -> torch.device:
    """Join the process group (idempotent) and return this rank's device.

    Without ``coordinator_address`` the rank, world size and rendezvous
    come from the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, as ``torchrun`` sets them); with it, ``host:port`` of
    rank 0's store over ``tcp://``, with ``num_processes`` and
    ``process_id``. ``backend`` defaults to ``nccl`` for ``device="cuda"``
    and ``gloo`` for ``device="cpu"``."""
    local = None if process_id is None else int(os.environ.get("LOCAL_RANK", process_id))
    dev = local_device(device, local)
    if dist.is_initialized():
        log.debug("distributed.initialize: already initialized (rank %d of %d)",
                  dist.get_rank(), dist.get_world_size())
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, timeout=TIMEOUT)
    if coordinator_address is None:
        dist.init_process_group(init_method="env://", **kw)
    else:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator needs num_processes and process_id")
        dist.init_process_group(init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id, **kw)
    log.info("distributed: rank %d of %d on %s, backend %s", dist.get_rank(),
             dist.get_world_size(), dev, backend)
    return dev


def pod_mesh(sample_ways: int = 1, device: str = "cuda") -> Mesh:
    """('rows', 'samples') layout over every rank: ``sample_ways`` ranks on
    the sample axis, the rest on pixel rows."""
    n = dist.get_world_size()
    if n % sample_ways:
        raise ValueError(f"{n} ranks do not split into {sample_ways} sample ways")
    return make_mesh((n // sample_ways, sample_ways), device=device)


def is_coordinator() -> bool:
    """Rank 0, or the only process when no group has been joined."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cpu_rank(rank: int, fn, nprocs: int, address: str, args: tuple) -> None:
    torch.set_num_threads(max((os.cpu_count() or 1) // nprocs, 1))
    initialize(address, nprocs, rank, backend="gloo", device="cpu")
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn_cpu(fn, nprocs: int, *args) -> None:
    """Run ``fn(*args)`` in ``nprocs`` new local processes, rank i of one
    gloo group on the CPU each (coordinator on a free localhost port): the
    ``--cpu-mesh`` mode of the scripts, a stand-in for several devices.
    ``fn`` must be importable (a module-level function). Returns when every
    rank has ended; raises if one failed."""
    torch.multiprocessing.start_processes(
        _cpu_rank, args=(fn, nprocs, f"127.0.0.1:{_free_port()}", args), nprocs=nprocs,
        start_method="spawn", join=True)
