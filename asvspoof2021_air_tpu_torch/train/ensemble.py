"""Ensembles on one card: M independently initialized systems trained in
one step, their scores averaged.

Counterpart of the JAX package's ``train/ensemble.py``
(``init_ensemble_state``, ``member_state``, ``make_ensemble_train_step``,
``make_ensemble_eval_step``, ``fuse_scores``), the reference's 3-system
average fusion as one training run. JAX stacks the members' states on a
leading axis and vmaps the step over it. The port's steps launch ctypes
kernels (B1, B4a/B4b), which ``torch.func.vmap`` cannot batch, so an
:class:`EnsembleState` keeps the M members' :class:`TrainState` objects as
a list and the ensemble step runs the members' steps one after another;
under ``steps.make_multi_step`` the M x K member-steps are one CUDA graph.

- Members differ by their initialization (``init_ensemble_state``) and
  their draws: member i's model draws (LCNN's dropout, ResNet's pooling
  noise) come from ``steps.step_generator(seed, step, MODEL_STREAM,
  member=i)`` when M > 1, where JAX splits the step's key per member.
- On the fly the front-end runs once a step over the batch tiled M times,
  member-major ((M B) rows), as JAX's does: one B1 launch and one
  augmenter pass, the augmenter drawing for M B rows. Member i trains on
  rows i B .. (i + 1) B - 1.
- The members share the step count. Metrics are member-averaged (the
  model selection then follows the mean dev loss, as in JAX); the eval
  step computes the features once and returns (M, B) scores, fused by
  their mean (:func:`fuse_scores`, the reference's ``avg_fuse``).

Across GPUs (one process each, ``parallel/``), the JAX module's mesh
steps:

- ``ensemble_mesh`` and ``make_member_parallel_step``: the members spread
  over a 1-D "model" mesh, M / d on each of its d ranks; each rank trains
  its members on the whole batch with the one-card ensemble's program
  (member i's draws from its own stream; on the fly the augmenter's draws
  for the M B tiled rows, of which the rank computes the features of its
  members' rows), so each member takes exactly the step it takes on one
  card. No collective but the metrics' mean over "model";
- ``member_data_mesh`` and ``make_member_data_parallel_step``: a 2-D
  ("model", "data") mesh (``torch.distributed.init_device_mesh``), the
  members over "model" and each member's batch over its "data" ranks,
  through a member step built with ``make_train_step(data_group=<the data
  group>, sync_bn=False)``: JAX's ``grad_axis="data"`` step, per-replica
  BN with the gradients, metrics and running statistics averaged over
  "data", which keeps a member's replicas identical.

A rank holds an :class:`EnsembleState` of its own members
(``init_ensemble_state(..., mesh=)``), ``member_ids`` their global
indices.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from asvspoof2021_air_tpu_torch._device import resolve_device
from asvspoof2021_air_tpu_torch.parallel.mesh import (
    Mesh, mean_metrics, world)
from asvspoof2021_air_tpu_torch.train.state import TrainState
from asvspoof2021_air_tpu_torch.train.steps import (
    eval_features, step_generator, take_rows)


class EnsembleState:
    """M member :class:`TrainState` objects stepped together, with the
    parts of a ``TrainState``'s interface that the steps, the CUDA graph of
    ``make_multi_step``, the loop and the checkpoints read. ``model`` is
    the members' models as one ``ModuleList``."""

    def __init__(self, members: List[TrainState],
                 member_ids: Optional[List[int]] = None,
                 n_members: Optional[int] = None):
        self.members = list(members)
        self.model = nn.ModuleList(m.model for m in self.members)
        self.member_ids = list(range(len(self.members))) \
            if member_ids is None else list(member_ids)
        self.n_members = n_members or len(self.members)

    @property
    def step(self) -> int:
        return self.members[0].step

    @step.setter
    def step(self, value: int) -> None:
        for m in self.members:
            m.step = value

    @property
    def capturable(self) -> bool:
        return self.members[0].capturable

    @property
    def lr(self) -> Optional[torch.Tensor]:
        return self.members[0].lr

    def set_rate(self) -> None:
        for m in self.members:
            m.set_rate()

    def gate(self, value: float) -> None:
        for m in self.members:
            m.gate(value)

    def graph_tensors(self) -> List[torch.Tensor]:
        return [t for m in self.members for t in m.graph_tensors()]

    def state_dict(self) -> Dict[str, Any]:
        """Checkpoint form: the shared step and each member's
        ``TrainState.state_dict`` (this rank's members on a mesh:
        ``train/loop.py`` gathers them)."""
        return {"step": self.step,
                "members": [m.state_dict() for m in self.members]}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Load every member's state from a checkpoint of all
        ``n_members`` (each rank of a mesh its own ``member_ids``)."""
        members = state.get("members")
        if members is None or len(members) != self.n_members:
            raise ValueError(
                f"the checkpoint holds "
                f"{'no' if members is None else len(members)} ensemble "
                f"members; this state trains {self.n_members}")
        for m, i in zip(self.members, self.member_ids):
            m.load_state_dict(members[i])
        self.step = int(state["step"])


def init_ensemble_state(make_state: Callable[[int], TrainState],
                        n_members: int, mesh: Optional[Mesh] = None
                        ) -> EnsembleState:
    """The members ``make_state(0)`` .. ``make_state(n_members - 1)``, each
    independently initialized (the loop draws member i's weights after
    member i - 1's from the run's generator). With a ``mesh`` that has a
    "model" axis, this rank's members only (:func:`local_members`), made
    after the same draws, so each holds the weights it has on one card."""
    states = [make_state(i) for i in range(n_members)]
    if mesh is None:
        return EnsembleState(states)
    ids = local_members(n_members, mesh)
    return EnsembleState([states[i] for i in ids], ids, n_members)


def local_members(n_members: int, mesh: Mesh) -> List[int]:
    """The members that this rank of ``mesh``'s "model" axis trains: the
    ``n_members / d`` consecutive ones at its index, of d ranks."""
    d, i = mesh.size("model"), mesh.index("model")
    if i is None:
        raise ValueError("this rank is outside the ensemble mesh")
    per = n_members // d
    return list(range(i * per, (i + 1) * per))


def member_state(state, i: int):
    """Member i of an :class:`EnsembleState`, or of its ``state_dict``."""
    if isinstance(state, EnsembleState):
        return state.members[i]
    return state["members"][i]


def _metrics(ms: List[Dict[str, torch.Tensor]], mean: bool
             ) -> Dict[str, torch.Tensor]:
    """The members' metrics stacked on a leading member axis, or their
    mean over it."""
    out = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
    return {k: v.mean(0) for k, v in out.items()} if mean else out


def make_ensemble_train_step(train_step: Callable, n_members: int,
                             mean_metrics: bool = True,
                             frontend: Optional[Callable] = None
                             ) -> Callable:
    """``ensemble_step(state, batch, rng=None, adv_gate=0.0,
    frontend_params=None, draws=None, model_draws=None) -> metrics`` over
    an :class:`EnsembleState`: the call form of ``train_step`` (a
    ``steps.make_train_step`` built with the same ``frontend``), so that
    ``steps.make_multi_step`` takes it. Every member trains on the batch;
    with an on-the-fly ``frontend`` the features of the M-fold tiled batch
    are computed once and member i trains on its rows. ``draws`` are the
    augmenter's for the M B rows and ``model_draws`` a list of the
    members' draws; each is drawn from ``rng`` and the step where not
    given (``ensemble_step.draw`` and ``ensemble_step.draw_model``, as on
    a member step)."""
    return _member_step(train_step, n_members, frontend, mean_metrics)


def _member_step(train_step: Callable, n_members: int,
                 frontend: Optional[Callable], mean: bool = True,
                 ids: Optional[List[int]] = None, model_group=None,
                 tiled: bool = True) -> Callable:
    """The ensemble step of members ``ids`` of ``n_members`` (all by
    default), the members an :class:`EnsembleState` holds, with the metrics
    averaged over them and then over ``model_group``'s ranks. ``tiled``: an
    on-the-fly batch is tiled M times and the augmenter draws for the M B
    rows, of which the members' are computed (the one-card ensemble and
    the member-parallel step); else each member's step makes its own
    front-end draws (the member x data step)."""
    M = n_members
    ids = list(range(M)) if ids is None else list(ids)
    augmenter = getattr(frontend, "augmenter", None)
    tiled = tiled and frontend is not None

    def draw(rng, step: int, batch: Dict[str, Any], out=None):
        if augmenter is None or "feat" in batch:
            return None
        if not tiled:       # each member's own, keyed by its index
            return [train_step.draw(rng, step, batch,
                                    None if out is None else out[j],
                                    member=i if M > 1 else None)
                    for j, i in enumerate(ids)]
        if rng is None:
            raise ValueError("the channel augmenter draws from the run's "
                             "seed: pass rng")
        n, length = batch["wave"].shape
        gen = step_generator(rng, step, frontend.device)
        if len(ids) == M:
            return augmenter.draw((M * n, length), gen, out)
        return take_rows(augmenter.draw((M * n, length), gen), ids[0] * n,
                         len(ids) * n, out)

    def draw_model(rng, step: int, models, batch: Dict[str, Any],
                   out=None):
        draws = [train_step.draw_model(
            rng, step, models[j], batch, None if out is None else out[j],
            member=i if M > 1 else None) for j, i in enumerate(ids)]
        return None if all(d is None for d in draws) else draws

    def ensemble_step(state: EnsembleState, batch: Dict[str, Any], rng=None,
                      adv_gate: float = 0.0, frontend_params=None,
                      draws=None, model_draws=None
                      ) -> Dict[str, torch.Tensor]:
        if state.member_ids != ids:
            raise ValueError(f"the state holds members {state.member_ids}; "
                             f"this step trains members {ids}")
        if model_draws is None:
            model_draws = draw_model(rng, state.step, state.model, batch)
        if draws is None:
            with torch.no_grad():
                draws = draw(rng, state.step, batch)
        member_draws = [None] * len(ids)
        batches = [batch] * len(ids)
        if tiled and "feat" not in batch:
            with torch.no_grad():
                wave = {k: batch[k].to(frontend.device).repeat(
                    len(ids), *[1] * (batch[k].dim() - 1))
                    for k in ("wave", "length") if k in batch}
                x = frontend(wave, draws, frontend_params)
            x = x.view(len(ids), -1, *x.shape[1:])
            rest = {k: v for k, v in batch.items()
                    if k not in ("wave", "length")}
            batches = [{"feat": x[j], **rest} for j in range(len(ids))]
        elif draws is not None:
            member_draws = draws
        ms = [train_step(s, b, rng, adv_gate, frontend_params,
                         member_draws[j],
                         None if model_draws is None else model_draws[j])
              for j, (s, b) in enumerate(zip(state.members, batches))]
        out = _metrics(ms, mean or model_group is not None)
        return mean_metrics(out, model_group)

    ensemble_step.draw = draw
    ensemble_step.draw_model = draw_model
    ensemble_step.groups = getattr(train_step, "groups", []) + (
        [] if model_group is None else [model_group])
    return ensemble_step


def make_ensemble_eval_step(eval_step: Callable,
                            frontend: Optional[Callable] = None
                            ) -> Callable:
    """``ensemble_eval(state, batch, frontend_params=None) -> (metrics,
    scores, feats)``: the features computed once (an on-the-fly
    ``frontend`` with the eval step's fixed draws, ``steps.eval_features``),
    each member's ``eval_step`` on them; the metrics member-averaged, the
    scores (M, B), the embeddings member 0's."""
    features = (None if frontend is None
                else eval_features(frontend, frontend.device))

    def ensemble_eval(state: EnsembleState, batch: Dict[str, Any],
                      frontend_params=None):
        if features is not None and "feat" not in batch:
            with torch.no_grad():
                x = features(batch, frontend_params)
            batch = {"feat": x, **{k: v for k, v in batch.items()
                                   if k not in ("wave", "length")}}
        outs = [eval_step(s, batch, frontend_params) for s in state.members]
        return (_metrics([o[0] for o in outs], True),
                torch.stack([o[1] for o in outs]), outs[0][2])

    return ensemble_eval


def ensemble_mesh(n_members: int, device="cuda") -> Mesh:
    """1-D "model" mesh for member-parallel training over the largest rank
    count d <= W that divides ``n_members``: ranks 0 .. d - 1, each
    hosting ``n_members / d`` members (a rank past d is outside it). Every
    rank of the world must call it (a group of d < W ranks is made
    collectively)."""
    rank, size = world()
    d = size
    while n_members % d:
        d -= 1
    group = None
    if dist.is_initialized():
        group = dist.group.WORLD if d == size else \
            dist.new_group(list(range(d)))
    return Mesh(("model",), (d,), {"model": rank if rank < d else None},
                {"model": group}, device)


def make_member_parallel_step(train_step: Callable, n_members: int,
                              mesh: Mesh,
                              frontend: Optional[Callable] = None
                              ) -> Callable:
    """The ensemble step of this rank's members of ``mesh``'s "model" axis
    (:func:`local_members`), on the whole (replicated) batch, the call form
    of ``make_ensemble_train_step``: each member takes the step it takes in
    the one-card ensemble (its own draws; on the fly its rows of the M-fold
    tiled batch, the augmenter drawing for all M B rows). The metrics are
    averaged over the members and the "model" ranks. Feed it the state of
    ``init_ensemble_state(..., mesh=mesh)``."""
    return _member_step(train_step, n_members, frontend,
                        ids=local_members(n_members, mesh),
                        model_group=mesh.group("model"))


def member_data_mesh(n_members: int, n_data: int, device="cuda") -> Mesh:
    """2-D ("model", "data") mesh of ``n_members`` x ``n_data`` ranks (a
    ``torch.distributed`` ``DeviceMesh``; rank m n_data + j holds member
    m's data shard j); the world must hold exactly that many ranks."""
    rank, size = world()
    if n_members * n_data != size:
        raise ValueError(f"a {n_members} x {n_data} member x data mesh "
                         f"needs {n_members * n_data} ranks; the world has "
                         f"{size}")
    dev = resolve_device(device)
    if not dist.is_initialized():
        return Mesh(("model", "data"), (1, 1), {"model": 0, "data": 0},
                    {"model": None, "data": None}, dev)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(dev.type, (n_members, n_data),
                          mesh_dim_names=("model", "data"))
    m, j = dm.get_coordinate()
    return Mesh(("model", "data"), (n_members, n_data),
                {"model": m, "data": j},
                {"model": dm.get_group("model"),
                 "data": dm.get_group("data")}, dev)


def make_member_data_parallel_step(train_step_sync: Callable,
                                   n_members: int, mesh: Mesh) -> Callable:
    """The ensemble over a 2-D ("model", "data") mesh: this rank's members
    of the "model" axis, each on this rank's rows of the batch (sharded
    over "data"). ``train_step_sync`` MUST be built with
    ``make_train_step(..., data_group=mesh.group("data"), sync_bn=False)``,
    the JAX step's ``grad_axis="data"``: per-replica BN over the local
    rows, the gradients, metrics and new running statistics averaged over
    "data" inside the step, which keeps a member's replicas identical; its
    draws are keyed by the member and the data index (an on-the-fly
    front-end runs in each member's step). The metrics are then averaged
    over the members and the "model" ranks."""
    group = mesh.group("data")
    if group is not None and (group not in train_step_sync.groups
                              or train_step_sync.sync_bn):
        raise ValueError("train_step_sync must be built with data_group="
                         "mesh.group('data') and sync_bn=False")
    return _member_step(train_step_sync, n_members,
                        train_step_sync.frontend,
                        ids=local_members(n_members, mesh),
                        model_group=mesh.group("model"), tiled=False)


def fuse_scores(member_scores) -> np.ndarray:
    """Average fusion over the leading member axis: the reference's
    ``avg_fuse`` divided by the member count (the same ranking and EER)."""
    return np.asarray(member_scores).mean(axis=0)
