"""Train and eval steps.

Counterpart of the JAX package's ``train/steps.py`` ``make_train_step`` and
``make_eval_step`` for ``add_loss`` in {None, "ang_iso"} and ``base_loss``
in {"ce", "bce"}:

- the base loss is always computed and logged; with an add-loss the
  backbone trains on the add-loss alone, times ``weight_loss``;
- a step is front-end (no gradient) -> model in train mode -> losses ->
  backward -> both optimizers (``TrainState.apply_gradients``);
- the metrics are the JAX step's: ``base_loss``, the add-loss under its
  name, and ``total_loss``, as 0-dim tensors;
- the eval step scores as the JAX one does: softmax[:, 0] of the logits
  for CE, the logit for BCE, the loss module's score (-cos) for ang_iso.

The other losses, ``adv_aug`` and ``remat_policy`` raise
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

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
