"""Train state: the model and the loss module with their two optimizers.

Counterpart of the JAX package's ``train/state.py``: Adam with coupled L2
weight decay 5e-4 on the backbone, plain SGD on the loss module's center,
both stepped each iteration at the step-decay learning rate
``lr * decay^((step // steps_per_epoch) // interval)``.

``torch.optim.Adam(lr, betas, eps, weight_decay)`` is the same update as
``optax.chain(add_decayed_weights(wd), scale_by_adam(b1, b2, eps),
scale_by_learning_rate(schedule))``: the decay is added to the gradient
before the moments, and eps to sqrt(v_hat). optax evaluates the schedule
at the update count before the step; :meth:`TrainState.apply_gradients`
sets the rate from ``step`` before stepping, which is the same count.

A *capturable* state (``create_train_state(capturable=True)``, CUDA only)
can be stepped inside a CUDA graph (``train/steps.make_multi_step``): the
rate is a device tensor that both optimizers read (Adam with
``capturable=True``, its step counts on the card; the center's SGD fused),
the gradients are zeroed in place rather than dropped, so every buffer the
graph captured persists, and :meth:`TrainState.load_state_dict` copies
into the existing tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn


def step_decay_schedule(base_lr: float, decay: float, interval_epochs: int,
                        steps_per_epoch: int) -> Callable[[int], float]:
    """lr * decay^(epoch // interval) as a function of the global step."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return base_lr * (decay ** (epoch // interval_epochs))

    return schedule


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    loss_module: Optional[nn.Module]
    optimizer: torch.optim.Adam
    loss_optimizer: Optional[torch.optim.SGD]
    schedule: Callable[[int], float]
    step: int = 0
    # the learning rate on the card, read by both optimizers of a
    # capturable state; None for an eager one
    lr: Optional[torch.Tensor] = None

    @property
    def capturable(self) -> bool:
        return self.lr is not None

    def optimizers(self) -> List[torch.optim.Optimizer]:
        return [o for o in (self.optimizer, self.loss_optimizer)
                if o is not None]

    def zero_grad(self) -> None:
        for opt in self.optimizers():
            opt.zero_grad(set_to_none=not self.capturable)

    def set_rate(self) -> None:
        """Write ``schedule(step)`` where the optimizers read it."""
        lr = self.schedule(self.step)
        if self.capturable:
            self.lr.fill_(lr)
            return
        for opt in self.optimizers():
            for group in opt.param_groups:
                group["lr"] = lr

    def apply_gradients(self) -> None:
        """One step of both optimizers at ``schedule(step)``. A backbone
        parameter the loss does not reach (``fc7`` and ``bn7`` under
        OC-Softmax, whose logits feed only the logged CE) gets a zero
        gradient first: in JAX every parameter has one, so coupled L2 still
        moves it, while ``torch.optim.Adam`` skips a parameter whose grad
        is None. Inside a CUDA graph's capture the rate is not written: the
        graph's caller writes it before each replay."""
        for p in self.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if not (self.capturable and torch.cuda.is_current_stream_capturing()):
            self.set_rate()
        for opt in self.optimizers():
            opt.step()
        self.step += 1

    def state_dict(self) -> Dict[str, Any]:
        """Checkpoint form: the model's state_dict, the loss module's, the
        Adam state per parameter name, and the step."""
        adam = {}
        for name, p in self.model.named_parameters():
            st = self.optimizer.state.get(p)
            if st:
                adam[name] = {k: v.detach().clone() for k, v in st.items()}
        return {
            "step": self.step,
            "model": self.model.state_dict(),
            "loss_module": (None if self.loss_module is None
                            else self.loss_module.state_dict()),
            "optimizer": adam,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Load a :meth:`state_dict` into this state's tensors, in place
        where they exist (model, center, Adam moments), so a CUDA graph
        captured over them replays from the loaded state."""
        self.model.load_state_dict(state["model"])
        if self.loss_module is not None:
            self.loss_module.load_state_dict(state["loss_module"])
        for name, p in self.model.named_parameters():
            saved = state["optimizer"].get(name)
            have = self.optimizer.state.get(p)
            if saved is None:
                self.optimizer.state.pop(p, None)
            elif have and set(have) == set(saved):
                for k, v in saved.items():
                    have[k].copy_(v)
            else:
                # Adam counts its steps in a CPU tensor, on the card when
                # capturable
                self.optimizer.state[p] = {
                    k: v.detach().to(p.device if self.capturable else "cpu")
                    .clone() if k == "step"
                    else v.detach().to(p.device, torch.float32).clone()
                    for k, v in saved.items()}
        self.step = int(state["step"])


def create_train_state(model: nn.Module, loss_module: Optional[nn.Module],
                       schedule: Callable[[int], float], beta_1: float = 0.9,
                       beta_2: float = 0.999, eps: float = 1e-8,
                       weight_decay: float = 5e-4,
                       capturable: bool = False) -> TrainState:
    """Adam (coupled L2) on the model, SGD on the loss module's parameters
    (none without a loss module); ``capturable`` for a state that a CUDA
    graph steps (the model on the card)."""
    lr = schedule(0)
    if capturable:
        dev = next(model.parameters()).device
        if dev.type != "cuda":
            raise ValueError("a capturable train state needs the model on "
                             "the card")
        lr = torch.tensor(lr, dtype=torch.float32, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(beta_1, beta_2),
                           eps=eps, weight_decay=weight_decay,
                           capturable=capturable)
    lopt = (torch.optim.SGD(loss_module.parameters(), lr=lr,
                            fused=capturable or None)
            if loss_module is not None else None)
    return TrainState(model, loss_module, opt, lopt, schedule,
                      lr=lr if capturable else None)
