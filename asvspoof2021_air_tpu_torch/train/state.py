"""Train state: the model, the loss module and the ADV_AUG channel
classifiers, with their optimizers.

Counterpart of the JAX package's ``train/state.py``: Adam with coupled L2
weight decay 5e-4 on the backbone (any model the port holds), plain SGD
on every parameter of the loss module (the center of OC-Softmax and of the
Isolate losses, P2SGrad's weight), both stepped each iteration at the step-decay learning rate
``lr * decay^((step // steps_per_epoch) // interval)``; under ADV_AUG one
channel classifier (two for LAPA/DFPA), each with its own Adam of the
backbone's form (``make_backbone_optimizer(sched_d)`` in the JAX loop)
stepped at ``schedule_d``, the same decay from ``lr_d``.

``torch.optim.Adam(lr, betas, eps, weight_decay)`` is the same update as
``optax.chain(add_decayed_weights(wd), scale_by_adam(b1, b2, eps),
scale_by_learning_rate(schedule))``: the decay is added to the gradient
before the moments, and eps to sqrt(v_hat). optax evaluates the schedule
at the update count before the step; :meth:`TrainState.apply_gradients`
sets the rates from ``step`` before stepping, which is the same count.

A *capturable* state (``create_train_state(capturable=True)``, CUDA only)
can be stepped inside a CUDA graph (``train/steps.make_multi_step``): the
rates ``lr`` and ``lr_d`` and the adversarial gate ``adv_gate`` are device
tensors that the optimizers and the step read (Adam with
``capturable=True``, its step counts on the card; the loss module's SGD
fused), the gradients are zeroed in place rather than dropped, so every
buffer the graph captured persists, and :meth:`TrainState.load_state_dict` copies
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


def _adam_state(opt: torch.optim.Adam, module: nn.Module
                ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The Adam state of ``module``'s parameters, by parameter name."""
    out = {}
    for name, p in module.named_parameters():
        st = opt.state.get(p)
        if st:
            out[name] = {k: v.detach().clone() for k, v in st.items()}
    return out


def _load_adam_state(opt: torch.optim.Adam, module: nn.Module,
                     saved: Dict[str, Dict[str, torch.Tensor]],
                     capturable: bool) -> None:
    """Load :func:`_adam_state`'s form into ``opt``, in place where the
    state exists."""
    for name, p in module.named_parameters():
        st, have = saved.get(name), opt.state.get(p)
        if st is None:
            opt.state.pop(p, None)
        elif have and set(have) == set(st):
            for k, v in st.items():
                have[k].copy_(v)
        else:
            # Adam counts its steps in a CPU tensor, on the card when
            # capturable
            opt.state[p] = {
                k: v.detach().to(p.device if capturable else "cpu").clone()
                if k == "step"
                else v.detach().to(p.device, torch.float32).clone()
                for k, v in st.items()}


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    loss_module: Optional[nn.Module]
    optimizer: torch.optim.Adam
    loss_optimizer: Optional[torch.optim.SGD]
    schedule: Callable[[int], float]
    step: int = 0
    # the learning rate on the card, read by the backbone's and the
    # loss module's optimizers of a capturable state; None for an eager one
    lr: Optional[torch.Tensor] = None
    # ADV_AUG: the channel classifier(s), their Adams and their schedule
    classifier: Optional[nn.Module] = None
    clf_optimizer: Optional[torch.optim.Adam] = None
    classifier2: Optional[nn.Module] = None
    clf2_optimizer: Optional[torch.optim.Adam] = None
    schedule_d: Optional[Callable[[int], float]] = None
    # a capturable state's classifier rate and adversarial gate on the card
    lr_d: Optional[torch.Tensor] = None
    adv_gate: Optional[torch.Tensor] = None

    @property
    def capturable(self) -> bool:
        return self.lr is not None

    def optimizers(self) -> List[torch.optim.Optimizer]:
        return [o for o in (self.optimizer, self.loss_optimizer,
                            self.clf_optimizer, self.clf2_optimizer)
                if o is not None]

    def classifiers(self) -> List[nn.Module]:
        return [c for c in (self.classifier, self.classifier2)
                if c is not None]

    def zero_grad(self) -> None:
        for opt in self.optimizers():
            opt.zero_grad(set_to_none=not self.capturable)

    def set_rate(self) -> None:
        """Write ``schedule(step)`` and ``schedule_d(step)`` where the
        optimizers read them."""
        lr = self.schedule(self.step)
        lr_d = (self.schedule_d(self.step) if self.schedule_d is not None
                else None)
        if self.capturable:
            self.lr.fill_(lr)
            if lr_d is not None:
                self.lr_d.fill_(lr_d)
            return
        for opt in self.optimizers():
            rate = lr_d if opt in (self.clf_optimizer,
                                   self.clf2_optimizer) else lr
            for group in opt.param_groups:
                group["lr"] = rate

    def gate(self, value: float):
        """The adversarial gate as the step multiplies by it: ``value``
        itself in an eager state; in a capturable one the device tensor
        ``adv_gate``, written with ``value`` except inside a CUDA graph's
        capture (the graph's caller writes it before each replay, as it
        writes the rates). A gate captured as a Python number would keep
        the epoch of its capture."""
        if not self.capturable:
            return value
        if not torch.cuda.is_current_stream_capturing():
            self.adv_gate.fill_(value)
        return self.adv_gate

    def graph_tensors(self) -> List[torch.Tensor]:
        """Every tensor a CUDA graph of its steps reads or writes: the
        parameters, buffers and gradients, the optimizers' states, the
        rates and the gate."""
        ts = [*self.model.parameters(), *self.model.buffers()]
        for m in (self.loss_module, *self.classifiers()):
            if m is not None:
                ts += list(m.parameters())
        ts += [p.grad for p in ts if p.grad is not None]
        ts += [v for opt in self.optimizers() for st in opt.state.values()
               for v in st.values() if torch.is_tensor(v)]
        return ts + [self.lr, self.lr_d, self.adv_gate]

    def trained_parameters(self) -> List[torch.Tensor]:
        """The parameters the backbone's loss trains: the model's and the
        loss module's (the classifiers train on their own loss)."""
        ps = list(self.model.parameters())
        if self.loss_module is not None:
            ps += list(self.loss_module.parameters())
        return ps

    def apply_gradients(self) -> None:
        """One step of every optimizer at ``schedule(step)`` and
        ``schedule_d(step)``. A backbone parameter the loss does not reach
        (the logits' layers under an add-loss: ECAPA's ``fc7`` and ``bn7``,
        ResNet's and LCNN's ``fc_mu``, which feed only the logged CE) gets a zero gradient first: in JAX every parameter has
        one, so coupled L2 still moves it, while ``torch.optim.Adam`` skips
        a parameter whose grad is None. Inside a CUDA graph's capture the
        rates are not written: the graph's caller writes them before each
        replay."""
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
        Adam state per parameter name, the classifiers and their Adam
        states (None without), and the step."""
        out = {
            "step": self.step,
            "model": self.model.state_dict(),
            "loss_module": (None if self.loss_module is None
                            else self.loss_module.state_dict()),
            "optimizer": _adam_state(self.optimizer, self.model),
        }
        for name, opt_name, clf, opt in self._classifier_slots():
            out[name] = None if clf is None else clf.state_dict()
            out[opt_name] = None if clf is None else _adam_state(opt, clf)
        return out

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Load a :meth:`state_dict` into this state's tensors, in place
        where they exist (model, loss module, classifiers, Adam moments), so a
        CUDA graph captured over them replays from the loaded state."""
        self.model.load_state_dict(state["model"])
        if self.loss_module is not None:
            self.loss_module.load_state_dict(state["loss_module"])
        _load_adam_state(self.optimizer, self.model, state["optimizer"],
                         self.capturable)
        for name, opt_name, clf, opt in self._classifier_slots():
            if clf is None:
                continue
            if state.get(name) is None:
                raise ValueError(f"the checkpoint holds no {name}, which "
                                 "this ADV_AUG state trains")
            clf.load_state_dict(state[name])
            _load_adam_state(opt, clf, state[opt_name], self.capturable)
        self.step = int(state["step"])

    def _classifier_slots(self):
        return (("classifier", "clf_optimizer", self.classifier,
                 self.clf_optimizer),
                ("classifier2", "clf2_optimizer", self.classifier2,
                 self.clf2_optimizer))


def create_train_state(model: nn.Module, loss_module: Optional[nn.Module],
                       schedule: Callable[[int], float], beta_1: float = 0.9,
                       beta_2: float = 0.999, eps: float = 1e-8,
                       weight_decay: float = 5e-4,
                       capturable: bool = False,
                       classifier: Optional[nn.Module] = None,
                       classifier2: Optional[nn.Module] = None,
                       schedule_d: Optional[Callable[[int], float]] = None
                       ) -> TrainState:
    """Adam (coupled L2) on the model, SGD on the loss module's parameters
    (none without a loss module), and for each classifier its own Adam of
    the model's form at ``schedule_d``; ``capturable`` for a state that a
    CUDA graph steps (the model on the card)."""
    lr = schedule(0)
    if classifier is not None and schedule_d is None:
        raise ValueError("a classifier needs its schedule_d")
    lr_d = schedule_d(0) if schedule_d is not None else None
    adv_gate = None
    if capturable:
        dev = next(model.parameters()).device
        if dev.type != "cuda":
            raise ValueError("a capturable train state needs the model on "
                             "the card")
        on = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        lr, adv_gate = on(lr), on(0.0)
        lr_d = on(lr_d if lr_d is not None else 0.0)

    def adam(params, rate):
        return torch.optim.Adam(params, lr=rate, betas=(beta_1, beta_2),
                                eps=eps, weight_decay=weight_decay,
                                capturable=capturable)

    opt = adam(model.parameters(), lr)
    lopt = (torch.optim.SGD(loss_module.parameters(), lr=lr,
                            fused=capturable or None)
            if loss_module is not None else None)
    copt, copt2 = (None if c is None else adam(c.parameters(), lr_d)
                   for c in (classifier, classifier2))
    return TrainState(model, loss_module, opt, lopt, schedule,
                      lr=lr if capturable else None, classifier=classifier,
                      clf_optimizer=copt, classifier2=classifier2,
                      clf2_optimizer=copt2, schedule_d=schedule_d,
                      lr_d=lr_d if capturable else None, adv_gate=adv_gate)
