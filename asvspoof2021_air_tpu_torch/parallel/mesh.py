"""Meshes of ranks, batch sharding and the collectives of the port's
multi-GPU steps.

Counterpart of the JAX package's ``parallel/mesh.py`` (``make_mesh``,
``batch_sharding``, ``shard_batch``, ``replicate``). JAX runs one logical
program over a mesh of devices and GSPMD shards the batch; the port runs
one process per GPU (``torchrun``), each holding its contiguous slice of
every global batch, and its steps call the collectives themselves
(``torch.distributed``: NCCL on the card, gloo on the CPU). Models are at
most about 20M parameters, so parameters and optimizer states are
replicated on every rank, as in JAX: wider meshes scale the batch or the
ensemble, not the model.

A :class:`Mesh` names its axes as a JAX mesh does ("data", or "model" and
"data" for the ensemble meshes of ``train/ensemble.py``); on each rank it
holds the rank's index along each axis and the process group of the ranks
that differ from it along that axis alone. In a process with no process
group the mesh is one rank and every group is None: the steps then make no
collective.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from asvspoof2021_air_tpu_torch._device import resolve_device


class ShardingError(ValueError):
    """A global batch that the ranks of a mesh axis do not divide (JAX's
    sharding refuses it too)."""


class Mesh:
    """Ranks on named axes: ``shape[i]`` ranks along ``axis_names[i]``.
    ``index(axis)`` is this rank's coordinate along ``axis`` (None on a
    rank outside the mesh), ``group(axis)`` the process group of the ranks
    that share every other coordinate with it (None in a one-process
    world), ``device`` this rank's device."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int],
                 index: Dict[str, Optional[int]], groups: Dict[str, Any],
                 device):
        self.axis_names, self.shape = tuple(axis_names), tuple(shape)
        self._index, self._groups = dict(index), dict(groups)
        self.device = resolve_device(device)

    def size(self, axis: str = "data") -> int:
        return self.shape[self.axis_names.index(axis)]

    def index(self, axis: str = "data") -> Optional[int]:
        return self._index[axis]

    def group(self, axis: str = "data"):
        return self._groups[axis]

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={n}" for a, n in zip(self.axis_names,
                                                    self.shape))
        return f"Mesh({dims}; index {self._index}, {self.device})"


def world() -> tuple:
    """(this process's rank, the world's size): (0, 1) without a process
    group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def make_mesh(device="cuda", axis_name: str = "data") -> Mesh:
    """A 1-D mesh over every rank of the world (the world group), or over
    this process alone when there is no process group."""
    rank, size = world()
    group = dist.group.WORLD if dist.is_initialized() else None
    return Mesh((axis_name,), (size,), {axis_name: rank},
                {axis_name: group}, device)


def batch_sharding(mesh: Mesh, axis_name: str = "data"
                   ) -> Callable[[int], slice]:
    """``rows(n)``: the contiguous rows of a global batch of ``n`` that this
    rank holds, ``n / W`` of them for W ranks along ``axis_name``; raises
    :class:`ShardingError` when W does not divide n."""
    size, index = mesh.size(axis_name), mesh.index(axis_name)

    def rows(n: int) -> slice:
        if n % size:
            raise ShardingError(
                f"a global batch of {n} rows does not split over the "
                f"{size} ranks of mesh axis {axis_name!r}")
        per = n // size
        return slice(index * per, (index + 1) * per)

    return rows


def shard_batch(batch: Dict[str, Any], mesh: Mesh, axis_name: str = "data",
                batch_axis: int = 0) -> Dict[str, Any]:
    """This rank's slice of every array of a global host ``batch`` along
    ``batch_axis`` (1 for the K-stacked batches of ``make_multi_step``),
    numpy arrays and tensors alike, by :func:`batch_sharding`."""
    rows = batch_sharding(mesh, axis_name)
    index = (slice(None),) * batch_axis
    return {k: v[index + (rows(v.shape[batch_axis]),)]
            for k, v in batch.items()}


def replicate(obj, mesh: Mesh, axis_name: str = "data", src: int = 0):
    """Broadcast every tensor of ``obj`` (an ``nn.Module``, a train state
    with its optimizer states, or a dict or list of tensors) from the rank
    at index ``src`` of ``axis_name`` to the others, in place, one flat
    buffer per type and device; return ``obj``. Nothing to do in a
    one-rank mesh."""
    group = mesh.group(axis_name)
    if group is None or mesh.size(axis_name) == 1:
        return obj
    root = dist.get_global_rank(group, src) if group is not dist.group.WORLD \
        else src
    by_type: Dict[tuple, List[torch.Tensor]] = {}
    for t in _tensors(obj):
        by_type.setdefault((t.dtype, t.device), []).append(t.data)
    for ts in by_type.values():     # one broadcast of one flat buffer each
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, root, group=group)
        for t, v in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(v.view_as(t))
    return obj


def _tensors(obj) -> List[torch.Tensor]:
    if torch.is_tensor(obj):
        return [obj]
    if isinstance(obj, nn.Module):
        return [*obj.parameters(), *obj.buffers()]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    if hasattr(obj, "members"):          # an EnsembleState
        return _tensors(obj.members)
    if hasattr(obj, "optimizers"):       # a TrainState
        mods = [obj.model, obj.loss_module, *obj.classifiers()]
        ts = [t for m in mods if m is not None for t in _tensors(m)]
        return ts + [v for opt in obj.optimizers()
                     for st in opt.state.values() for v in st.values()
                     if torch.is_tensor(v) and v.dim() > 0]
    return []


def average_(tensors: Sequence[torch.Tensor], group) -> None:
    """Replace each of ``tensors`` (one floating type) by its mean over the
    ranks of ``group``, in one all-reduce of one flat buffer. Nothing to do
    without a group."""
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(v.view_as(t))


def mean_metrics(metrics: Dict[str, torch.Tensor], group
                 ) -> Dict[str, torch.Tensor]:
    """Each metric (0-dim f32 tensors) averaged over ``group``'s ranks in
    one all-reduce; the metrics themselves without a group."""
    if group is None:
        return metrics
    names = sorted(metrics)
    flat = torch.stack([metrics[k].float() for k in names])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    return dict(zip(names, flat.unbind()))


def gather(t: torch.Tensor, group) -> torch.Tensor:
    """(W, ...) of ``t`` from every rank of ``group`` in rank order (one
    shape on every rank), by an all-reduce into a zero-filled buffer, which
    gloo runs on CUDA tensors too; ``t[None]`` without a group."""
    if group is None:
        return t[None]
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    buf = t.new_zeros((size, *t.shape))
    buf[rank] = t
    dist.all_reduce(buf, group=group)
    return buf

