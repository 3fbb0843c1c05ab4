"""Train and eval steps.

Counterpart of the JAX package's ``train/steps.py`` ``make_train_step``,
``make_multi_step`` and ``make_eval_step`` for ``add_loss`` in {None,
"ang_iso"} and ``base_loss`` in {"ce", "bce"}:

- the base loss is always computed and logged; with an add-loss the
  backbone trains on the add-loss alone, times ``weight_loss``;
- a step is front-end (no gradient) -> model in train mode -> losses ->
  backward -> both optimizers (``TrainState.apply_gradients``);
- the metrics are the JAX step's: ``base_loss``, the add-loss under its
  name, and ``total_loss``, as 0-dim tensors;
- the eval step scores as the JAX one does: softmax[:, 0] of the logits
  for CE, the logit for BCE, the loss module's score (-cos) for ang_iso;
- ``make_multi_step`` runs K steps per call, the JAX ``lax.scan`` over K
  stacked batches: on the card as one CUDA graph of K steps, replayed.

The other losses, ``adv_aug`` and ``remat_policy`` raise
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from asvspoof2021_air_tpu_torch._device import resolve_device
from asvspoof2021_air_tpu_torch.train.state import TrainState


@dataclasses.dataclass(frozen=True)
class StepConfig:
    add_loss: Optional[str] = None        # None | "ang_iso"
    base_loss: str = "ce"                 # "ce" | "bce"
    weight_loss: float = 1.0
    # The JAX StepConfig's switches for what the port does not train with
    # yet (ROADMAP Queue A); set, they raise.
    adv_aug: bool = False
    remat_policy: Optional[str] = None


def _check(config: StepConfig) -> None:
    if config.add_loss not in (None, "ang_iso"):
        raise NotImplementedError(
            f"add_loss {config.add_loss!r}: the port trains with None or "
            "'ang_iso' (the other losses are ROADMAP Queue A)")
    if config.base_loss not in ("ce", "bce"):
        raise ValueError(f"base_loss {config.base_loss!r}")
    if config.adv_aug:
        raise NotImplementedError("adv_aug (the channel classifiers) is not "
                                  "ported")
    if config.remat_policy is not None:
        raise NotImplementedError("remat_policy is not ported")


def base_loss_and_score(base_loss: str, logits: torch.Tensor,
                        labels: torch.Tensor):
    """The JAX package's ``losses/basic.py`` CE (mean softmax cross-entropy
    on integer labels) or BCE-with-logits on the first logit, and the
    score the eval step reports with it."""
    if base_loss == "bce":
        return (F.binary_cross_entropy_with_logits(
            logits[:, 0], labels.to(logits.dtype)), logits[:, 0])
    return F.cross_entropy(logits, labels), torch.softmax(logits, dim=1)[:, 0]


def _features(batch, frontend, rng, frontend_params, device):
    if "feat" in batch:
        return batch["feat"].to(device)
    return frontend(batch, rng, frontend_params)


def make_train_step(config: StepConfig, frontend: Optional[Callable] = None,
                    device="cuda") -> Callable:
    """``step(state, batch, rng=None, frontend_params=None) -> metrics``.

    ``batch`` holds 'feat' (B, T, F) or 'wave' (B, L) + 'length', and
    'label' (B,), as tensors. ``frontend(batch, rng, params)`` turns a
    waveform batch into features on ``device``. The step updates ``state``
    in place (parameters, BN statistics, optimizer states, step)."""
    _check(config)
    dev = resolve_device(device)

    def train_step(state: TrainState, batch: Dict[str, Any], rng=None,
                   frontend_params=None) -> Dict[str, torch.Tensor]:
        state.model.train()
        labels = batch["label"].to(dev).long()
        with torch.no_grad():
            x = _features(batch, frontend, rng, frontend_params, dev)
        state.zero_grad()
        feats, logits = state.model(x)
        base, _ = base_loss_and_score(config.base_loss, logits, labels)
        metrics = {"base_loss": base.detach()}
        if config.add_loss is None:
            total = base
        else:
            add, _scores = state.loss_module(feats, labels)
            metrics[config.add_loss] = add.detach()
            total = add * config.weight_loss
        total.backward()
        state.apply_gradients()
        metrics["total_loss"] = total.detach()
        return metrics

    return train_step


def _run_steps(train_step: Callable, state: TrainState,
               batches: Dict[str, torch.Tensor], n_steps: int,
               frontend_params) -> Dict[str, torch.Tensor]:
    """``n_steps`` calls of the step over stacked batches; the metrics
    stacked."""
    ms = [train_step(state, {k: v[i] for k, v in batches.items()}, None,
                     frontend_params) for i in range(n_steps)]
    return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}


class _GraphedSteps:
    """K training steps as one CUDA graph over a capturable
    :class:`TrainState`; see :func:`make_multi_step`."""

    def __init__(self, train_step: Callable, n_steps: int):
        self.train_step, self.n_steps = train_step, n_steps
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static: Dict[str, torch.Tensor] = {}
        self.out: Dict[str, torch.Tensor] = {}
        self.captured: List[int] = []

    @staticmethod
    def _pointers(state: TrainState) -> List[int]:
        ts = [*state.model.parameters(), *state.model.buffers()]
        if state.loss_module is not None:
            ts += list(state.loss_module.parameters())
        ts += [p.grad for p in ts if p.grad is not None]
        ts += [v for st in state.optimizer.state.values()
               for v in st.values()]
        return [t.data_ptr() for t in ts] + [state.lr.data_ptr()]

    def __call__(self, state: TrainState, batches: Dict[str, torch.Tensor],
                 frontend_params=None) -> Dict[str, torch.Tensor]:
        if not state.capturable:
            raise ValueError("a CUDA graph of training steps needs a "
                             "capturable TrainState "
                             "(create_train_state(capturable=True))")
        dev = state.lr.device
        if self.graph is None:
            # The first call's K steps run eagerly on a side stream: real
            # steps of the run, which also warm up what the capture needs
            # (Adam's state, the libraries' workspaces). Then the capture
            # records the same K steps over static buffers, running none.
            self.static = {k: v.to(dev, copy=True) for k, v in
                           batches.items()}
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            run = lambda: _run_steps(self.train_step, state, self.static,
                                     self.n_steps, frontend_params)
            with torch.cuda.stream(side):
                out = run()
                step, graph = state.step, torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, stream=side):
                    self.out = run()
                state.step = step
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph, self.captured = graph, self._pointers(state)
            return out
        if self._pointers(state) != self.captured:
            raise RuntimeError("the train state's tensors moved since the "
                               "CUDA graph captured them")
        got = {k: v.shape for k, v in batches.items()}
        want = {k: v.shape for k, v in self.static.items()}
        if got != want:
            raise ValueError(f"the CUDA graph was captured for batches of "
                             f"{want}, not {got}")
        for k, v in batches.items():
            self.static[k].copy_(v, non_blocking=True)
        state.set_rate()
        self.graph.replay()
        state.step += self.n_steps
        return {k: v.clone() for k, v in self.out.items()}


def make_multi_step(train_step: Callable, n_steps: int) -> Callable:
    """``multi_step(state, batches, frontend_params=None) -> metrics``:
    ``n_steps`` steps of ``train_step`` over ``batches``, a dict of
    tensors with a leading (n_steps, ...) axis; each metric comes back as
    one (n_steps,) tensor. The JAX ``make_multi_step`` (a ``lax.scan``).

    On a CPU state it calls the step ``n_steps`` times. On the card the
    state must be capturable: the first call runs its steps eagerly, then
    captures them as one CUDA graph (front-end, forward, backward, both
    optimizers); every later call copies its batches into the graph's
    static buffers, writes the learning rate (constant within a call) and
    replays. The batches must keep their shapes. A kernel launched inside
    the graph counts its launch once, at the capture. A failed capture
    raises; nothing falls back to eager steps."""
    graphed = _GraphedSteps(train_step, n_steps)

    def multi_step(state: TrainState, batches: Dict[str, torch.Tensor],
                   frontend_params=None) -> Dict[str, torch.Tensor]:
        if next(state.model.parameters()).is_cuda:
            return graphed(state, batches, frontend_params)
        return _run_steps(train_step, state, batches, n_steps,
                          frontend_params)

    return multi_step


def make_eval_step(config: StepConfig, frontend: Optional[Callable] = None,
                   device="cuda") -> Callable:
    """``step(state, batch, frontend_params=None) -> (metrics, score,
    feats)`` with the model in eval mode and no gradient."""
    _check(config)
    dev = resolve_device(device)

    def eval_step(state: TrainState, batch: Dict[str, Any],
                  frontend_params=None):
        state.model.eval()
        labels = batch["label"].to(dev).long()
        with torch.no_grad():
            x = _features(batch, frontend, None, frontend_params, dev)
            feats, logits = state.model(x)
            base, score = base_loss_and_score(config.base_loss, logits,
                                              labels)
            metrics = {"base_loss": base}
            if config.add_loss == "ang_iso":
                add, score = state.loss_module(feats, labels)
                metrics["ang_iso"] = add
        return metrics, score, feats

    return eval_step
