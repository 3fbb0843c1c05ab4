"""Process-group setup and per-process data loading.

Counterpart of the JAX package's ``parallel/distributed.py``
(``initialize_distributed``, ``host_shard_range``, ``make_global_batch``).
The port runs one process per GPU, started by ``torchrun`` (which sets
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``): ``initialize_distributed`` joins the process group (NCCL
on the card, gloo on the CPU) and puts this process on ``cuda:LOCAL_RANK``,
so that ``resolve_device("cuda")`` lands there. Like JAX's it does nothing
when the environment names no world; unlike JAX's it never swallows a
failure: once a world is named, a process group that cannot be joined
raises, and nothing continues in one process or on the CPU.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from asvspoof2021_air_tpu_torch._device import resolve_device
from asvspoof2021_air_tpu_torch.parallel.mesh import Mesh, world


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda",
                           backend: Optional[str] = None) -> None:
    """Join the process group of ``num_processes`` processes (default
    ``WORLD_SIZE``) as ``process_id`` (default ``RANK``), rendezvous at
    ``coordinator_address`` ("host:port"; default torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``), over ``backend`` (default NCCL for
    ``device`` "cuda", gloo for "cpu"); on the card first select
    ``cuda:LOCAL_RANK``. A no-op when a process group exists already, or
    when neither the arguments nor the environment name a world."""
    if dist.is_initialized():
        return
    size = num_processes if num_processes is not None else \
        os.environ.get("WORLD_SIZE")
    if size is None and coordinator_address is None:
        return      # one process: nothing to join
    if size is None:
        raise ValueError("coordinator_address without num_processes")
    rank = process_id if process_id is not None else \
        int(os.environ.get("RANK", "0"))
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {}
    if dev.type == "cuda":
        local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(local)
        if backend == "nccl":
            kw["device_id"] = local     # NCCL binds this rank's card
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group(backend, init_method=init, world_size=int(size),
                            rank=rank, **kw)


def host_shard_range(n_items: int) -> range:
    """The items of a dataset that this process loads: disjoint contiguous
    shards of ceil(n / W) items across the W processes."""
    rank, size = world()
    per = -(-n_items // size)
    start = rank * per
    return range(min(start, n_items), min(start + per, n_items))


def make_global_batch(local_batch: Dict[str, np.ndarray], mesh: Mesh,
                      axis_name: str = "data") -> Dict[str, Any]:
    """The global batch of which ``local_batch`` is this rank's contiguous
    shard, as the port's steps take it: every rank holds its own rows, as
    tensors on the mesh's device. Every rank must contribute as many rows
    (JAX's ``make_array_from_process_local_data`` asks the same): a
    mismatch raises on every rank."""
    out = {k: torch.as_tensor(np.asarray(v)).to(mesh.device)
           for k, v in local_batch.items()}
    group = mesh.group(axis_name)
    if group is not None and out:
        n = next(iter(out.values())).shape[0]
        sizes = torch.tensor([n, -n], dtype=torch.int64, device=mesh.device)
        dist.all_reduce(sizes, op=dist.ReduceOp.MAX, group=group)
        if int(sizes[0]) != -int(sizes[1]):
            raise ValueError(
                f"local batches of {-int(sizes[1])} to {int(sizes[0])} rows "
                f"across the {mesh.size(axis_name)} ranks of mesh axis "
                f"{axis_name!r}: every rank must hold as many")
    return out
