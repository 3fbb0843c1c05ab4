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

The multi-GPU mesh steps of the JAX module (``ensemble_mesh``,
``make_member_parallel_step``, ``member_data_mesh``,
``make_member_data_parallel_step``) are not ported (ROADMAP Queue A,
multi-GPU).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from asvspoof2021_air_tpu_torch.train.state import TrainState
from asvspoof2021_air_tpu_torch.train.steps import (
    eval_features, step_generator)


class EnsembleState:
    """M member :class:`TrainState` objects stepped together, with the
    parts of a ``TrainState``'s interface that the steps, the CUDA graph of
    ``make_multi_step``, the loop and the checkpoints read. ``model`` is
    the members' models as one ``ModuleList``."""

    def __init__(self, members: List[TrainState]):
        self.members = list(members)
        self.model = nn.ModuleList(m.model for m in self.members)

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
        ``TrainState.state_dict``."""
        return {"step": self.step,
                "members": [m.state_dict() for m in self.members]}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        members = state.get("members")
        if members is None or len(members) != len(self.members):
            raise ValueError(
                f"the checkpoint holds "
                f"{'no' if members is None else len(members)} ensemble "
                f"members; this state trains {len(self.members)}")
        for m, sd in zip(self.members, members):
            m.load_state_dict(sd)
        self.step = int(state["step"])


def init_ensemble_state(make_state: Callable[[int], TrainState],
                        n_members: int) -> EnsembleState:
    """The members ``make_state(0)`` .. ``make_state(n_members - 1)``, each
    independently initialized (the loop draws member i's weights after
    member i - 1's from the run's generator)."""
    return EnsembleState([make_state(i) for i in range(n_members)])


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
    M = n_members
    augmenter = getattr(frontend, "augmenter", None)

    def draw(rng, step: int, batch: Dict[str, Any], out=None):
        if augmenter is None or "feat" in batch:
            return None
        if rng is None:
            raise ValueError("the channel augmenter draws from the run's "
                             "seed: pass rng")
        n, length = batch["wave"].shape
        return augmenter.draw((M * n, length),
                              step_generator(rng, step, frontend.device), out)

    def draw_model(rng, step: int, models, batch: Dict[str, Any], out=None):
        draws = [train_step.draw_model(
            rng, step, models[i], batch, None if out is None else out[i],
            member=i if M > 1 else None) for i in range(M)]
        return None if all(d is None for d in draws) else draws

    def ensemble_step(state: EnsembleState, batch: Dict[str, Any], rng=None,
                      adv_gate: float = 0.0, frontend_params=None,
                      draws=None, model_draws=None
                      ) -> Dict[str, torch.Tensor]:
        if model_draws is None:
            model_draws = draw_model(rng, state.step, state.model, batch)
        if frontend is not None and "feat" not in batch:
            with torch.no_grad():
                if draws is None:
                    draws = draw(rng, state.step, batch)
                tiled = {k: batch[k].to(frontend.device).repeat(
                    M, *[1] * (batch[k].dim() - 1))
                    for k in ("wave", "length") if k in batch}
                x = frontend(tiled, draws, frontend_params)
            x = x.view(M, -1, *x.shape[1:])
            rest = {k: v for k, v in batch.items()
                    if k not in ("wave", "length")}
            batches = [{"feat": x[i], **rest} for i in range(M)]
        else:
            batches = [batch] * M
        ms = [train_step(s, b, rng, adv_gate, frontend_params, None,
                         None if model_draws is None else model_draws[i])
              for i, (s, b) in enumerate(zip(state.members, batches))]
        return _metrics(ms, mean_metrics)

    ensemble_step.draw = draw
    ensemble_step.draw_model = draw_model
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


def fuse_scores(member_scores) -> np.ndarray:
    """Average fusion over the leading member axis: the reference's
    ``avg_fuse`` divided by the member count (the same ranking and EER)."""
    return np.asarray(member_scores).mean(axis=0)
