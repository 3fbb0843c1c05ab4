"""Train and eval steps.

Counterpart of the JAX package's ``train/steps.py`` ``make_train_step``,
``make_multi_step`` and ``make_eval_step`` for ``add_loss`` in {None,
"isolate", "iso_sq", "ang_iso", "p2sgrad"} and ``base_loss`` in {"ce",
"bce"}, with or without ADV_AUG, for any model the port holds:

- the base loss is always computed and logged; with an add-loss the
  backbone trains on the add-loss alone: ``add * weight_loss`` for
  isolate, iso_sq and ang_iso, ``add`` for p2sgrad (``steps.py:128-165``
  of the JAX package, which raises ValueError for amsoftmax, as the port
  does);
- ADV_AUG (``adv_aug``, ``dual_classifier`` for LAPA/DFPA) adds
  ``adv_gate * CE(classifier(GRL(feats)), channel)`` to the ang_iso loss
  (both classifiers' CEs in dual mode), then trains the classifiers on the
  same embeddings, detached, against their parameters from before the
  step (``steps.py:139-159, 231-290`` of the JAX package; the reference
  re-runs the forward for that phase, JAX and the port reuse it). The
  classifiers run without dropout, as JAX calls them with ``train=False``;
- a step is front-end (no gradient) -> model in train mode -> losses ->
  backward -> every optimizer (``TrainState.apply_gradients``);
- the metrics are the JAX step's: ``base_loss``, the add-loss under its
  name, ``adv_loss``/``adv_acc`` and ``clf_loss``/``clf_acc`` under
  ADV_AUG, and ``total_loss``, as 0-dim tensors;
- the eval step scores as the JAX one does: softmax[:, 0] of the logits
  for CE, the logit for BCE, the loss module's score (-cos) for ang_iso
  and p2sgrad, the distance to the center for isolate and iso_sq;
  with an augmenting front-end (``dev_aug``) it draws the same channels
  for every batch, as JAX's eval step passes one fixed key;
- ``make_multi_step`` runs K steps per call, the JAX ``lax.scan`` over K
  stacked batches: on the card as one CUDA graph of K steps, replayed.

The augmenter's draws at a training step, and the model's (LCNN's dropout
mask, ResNet's pooling noise: the JAX step's ``dropout`` and ``noise``
streams), are a function of the run's seed and the step alone
(:func:`step_generator`, one stream each), as the JAX step folds the step
into its key: a step draws the same eagerly, in a graph's replay and after
a resume.

Data parallel over ``torch.distributed`` (``data_group``, one process per
GPU, each with its contiguous rows of every global batch;
``parallel/mesh.py``): with ``sync_bn`` (the default) the step computes
what the one-process step computes on the global batch, as JAX's one
logical program over a data mesh does (``grad_axis=None`` there): BN
normalizes with the global batch's moments (``ops/bn_relu_vjp.
batch_norm_group``), the augmenter's and the model's draws are made for the
global batch from the same generators and sliced to the rank's rows, the
gradients are averaged over the ranks (``TrainState.apply_gradients``) and
so are the metrics. With ``sync_bn=False`` it is the JAX step's
``grad_axis`` mode (the member x data ensemble mesh): BN normalizes with
the rank's local moments, the draws are the rank's own (keyed by its index
in the group), and the gradients, the metrics and the new running
statistics are averaged over the ranks.

``remat_policy="conv_dot"`` (the JAX step's ``jax.checkpoint`` policy)
runs the model's forward under ``torch.utils.checkpoint`` with a selective
policy that saves the outputs of convolutions and matrix products
(``aten.convolution``/``mm``/``addmm``/``bmm``) and recomputes everything
else (the elementwise and BN chains, the softmax) in the backward, the
recompute Functions of ``ops/bn_relu_vjp.py``, ``ops/res2_chain_vjp.py``
and B4a included. The recompute re-runs each BN's running-statistics
update, so the step restores the statistics the forward left, in place.
The checkpoint keeps no RNG state (``preserve_rng_state=False``): the
model's and the augmenter's draws are the step's inputs
(:func:`step_generator`), so the recompute draws nothing, and reading the
CUDA generator's state inside a graph capture would raise. So the K-step
CUDA graph of ``make_multi_step`` captures the checkpointed backward as
it captures the plain one. Other values raise ValueError, as in JAX. It
is a switch kept for parity
with the JAX step's API, set by no CLI flag or ``TrainConfig`` field, and
it loses on this port: the recompute Functions above already keep only
their inputs and statistics, so it saves no memory (peak 3.68 GiB with
and without it) and the step takes 52-129% longer (one f32 ECAPA-TDNN-512
step at B = 64, T = 750; ``chip_smoke.py`` phase 8c on an NVIDIA H100
80GB HBM3 at 700 W).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from asvspoof2021_air_tpu_torch._device import resolve_device
from asvspoof2021_air_tpu_torch.losses.basic import (
    binary_cross_entropy_with_logits, cross_entropy)
from asvspoof2021_air_tpu_torch.ops.bn_relu_vjp import batch_norm_group
from asvspoof2021_air_tpu_torch.parallel.mesh import average_, mean_metrics
from asvspoof2021_air_tpu_torch.train.state import TrainState
from asvspoof2021_air_tpu_torch.utils import profiling

TRAINED_LOSSES = (None, "isolate", "iso_sq", "ang_iso", "p2sgrad")


@dataclasses.dataclass(frozen=True)
class StepConfig:
    add_loss: Optional[str] = None   # None|isolate|iso_sq|ang_iso|p2sgrad
    base_loss: str = "ce"                 # "ce" | "bce"
    weight_loss: float = 1.0
    adv_aug: bool = False
    dual_classifier: bool = False         # codec + device classifiers
    remat_policy: Optional[str] = None    # None | "conv_dot"


def _check(config: StepConfig, train: bool = True) -> None:
    if train and config.add_loss not in TRAINED_LOSSES:
        # the JAX step's ValueError (amsoftmax is a scoring head only)
        raise ValueError(f"add_loss {config.add_loss!r} does not train; "
                         f"choices: {TRAINED_LOSSES}")
    if config.base_loss not in ("ce", "bce"):
        raise ValueError(f"base_loss {config.base_loss!r}")
    if config.remat_policy not in (None, "conv_dot"):
        raise ValueError(config.remat_policy)


_CONV_DOT_OPS = (torch.ops.aten.convolution.default,
                 torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                 torch.ops.aten.bmm.default)


def _conv_dot_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy: save convolution and matrix-product
    outputs, recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _CONV_DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _forward(model: torch.nn.Module, x: torch.Tensor, model_draws,
             remat_policy: Optional[str]):
    """The train-mode forward (embedding, logits); with ``remat_policy``
    under the selective checkpoint of the module docstring."""
    args = (x,) if model_draws is None else (x, model_draws)
    if remat_policy is None:
        return model(*args)
    from torch.utils.checkpoint import (
        checkpoint, create_selective_checkpoint_contexts)
    return checkpoint(
        model, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: create_selective_checkpoint_contexts(
            _conv_dot_policy))


def _running_stats(model: torch.nn.Module) -> List[torch.Tensor]:
    return [b for name, b in model.named_buffers()
            if name.endswith(("running_mean", "running_var"))]


def base_loss_and_score(base_loss: str, logits: torch.Tensor,
                        labels: torch.Tensor):
    """The mean CE on integer labels or BCE-with-logits on the first logit
    (``losses/basic.py``), and the score the eval step reports with it."""
    if base_loss == "bce":
        return (binary_cross_entropy_with_logits(logits[:, 0], labels),
                logits[:, 0])
    return cross_entropy(logits, labels), torch.softmax(logits, dim=1)[:, 0]


FRONTEND_STREAM, MODEL_STREAM = 0, 1


def step_generator(seed: int, step: int, device,
                   stream: int = FRONTEND_STREAM,
                   member: Optional[int] = None,
                   shard: Optional[int] = None) -> torch.Generator:
    """The generator of the draws of ``stream`` (the augmenter's, or the
    model's dropout and noise) at training step ``step`` of a run whose base
    seed is ``seed``: a fresh ``torch.Generator`` on ``device`` seeded from
    (seed, step, stream) alone, ensemble member ``member``'s from
    (seed, step, stream, member) (``train/ensemble.py``), and data shard
    ``shard``'s of a per-replica step (``sync_bn=False``) from (seed, step,
    stream, member, shard). The draws are
    made eagerly, outside any CUDA graph (a graph takes them as static
    inputs, like its batches), so a replayed step draws bit for bit what
    the same step draws eagerly."""
    key = [seed, step]
    if stream != FRONTEND_STREAM or member is not None or shard is not None:
        key.append(stream)
    if shard is not None:
        # (member + 1 or 0, shard, 1): a key of its own length
        key += [0 if member is None else member + 1, shard, 1]
    elif member is not None:
        key.append(member)
    s = np.random.SeedSequence(key).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s) >> 1)


def _accuracy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(logits, 1) == target).float().mean()


def _channel_ce(state: TrainState, config: StepConfig, x: torch.Tensor,
                channel: torch.Tensor):
    """(CE of the classifier(s) on ``x`` against ``channel``, the first
    classifier's accuracy): CE(c1, channel) or, dual, CE(c1, channel[:,
    0]) + CE(c2, channel[:, 1])."""
    if not config.dual_classifier:
        c1 = state.classifier(x)
        return cross_entropy(c1, channel), _accuracy(c1, channel)
    c1, c2 = state.classifier(x), state.classifier2(x)
    return (cross_entropy(c1, channel[:, 0])
            + cross_entropy(c2, channel[:, 1]),
            _accuracy(c1, channel[:, 0]))


def _augmenter(frontend):
    return getattr(frontend, "augmenter", None)


def group_index(group) -> tuple:
    """(this rank's index in ``group``, the group's size); (0, 1) for
    None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def take_rows(draws, start: int, n: int, out=None):
    """Rows ``start`` .. ``start + n - 1`` of every tensor of ``draws`` (a
    tensor or a dict of them, rows on dim 0), copied into ``out``'s tensors
    where given."""
    if isinstance(draws, dict):
        return {k: take_rows(v, start, n, None if out is None else out[k])
                for k, v in draws.items()}
    rows = draws[start:start + n]
    return rows if out is None else out.copy_(rows)


def _sync_running_stats(model: torch.nn.Module, group) -> None:
    """The BN running statistics averaged over ``group`` (a per-replica
    step's, as JAX pmeans its new batch_stats)."""
    average_([b for name, b in model.named_buffers()
              if name.endswith(("running_mean", "running_var"))], group)


def make_train_step(config: StepConfig, frontend: Optional[Callable] = None,
                    device="cuda", data_group=None,
                    sync_bn: bool = True) -> Callable:
    """``step(state, batch, rng=None, adv_gate=0.0, frontend_params=None,
    draws=None, model_draws=None) -> metrics``.

    ``batch`` holds 'feat' (B, T, F) or 'wave' (B, L) + 'length', 'label'
    (B,) and, under ADV_AUG, 'channel' ((B,) or (B, 2)), as tensors.
    ``frontend(batch, draws, params)`` turns a waveform batch into features
    on ``device``. ``rng`` is the run's base seed (an int): with an
    augmenting front-end the step draws from ``step_generator(rng,
    state.step)`` unless ``draws`` are given, and a model that draws in
    train mode (LCNN, ResNet, the attentive ConvNet) from
    ``step_generator(rng, state.step, stream=MODEL_STREAM)`` unless
    ``model_draws`` are given. ``adv_gate``
    multiplies the adversarial term (0 in the first epoch, then 1). The
    step updates ``state`` in place (parameters, BN statistics, optimizer
    states, step). ``step.draw(rng, step, batch, out=None, member=None)``
    gives the augmenter's draws it would make at ``step`` (None without an
    augmenter; an ensemble member's own under the member x data mesh) and
    ``step.draw_model(rng, step, model, batch, out=None, member=None)``
    the model's (None for a model that does not draw; an
    ensemble member's from its own stream), written into ``out``'s tensors
    where given.

    ``data_group`` (a ``torch.distributed`` process group) makes it the
    data-parallel step of the module docstring: ``batch`` is this rank's
    contiguous 1/W of the global batch (``parallel/mesh.shard_batch``),
    the draws are those of the global batch sliced to its rows (the rank's
    own with ``sync_bn=False``), and the metrics come back averaged over
    the group; ``step.groups`` lists the groups it communicates over."""
    _check(config)
    dev = resolve_device(device)
    augmenter = _augmenter(frontend)
    index, size = group_index(data_group)

    def sharded(make, n: int, rng, step: int, stream: int,
                member: Optional[int], out):
        """The draws of this rank's ``n`` rows by ``make(rows, generator,
        out)``: one process's own; with a data group the global batch's
        rows index n .. (index + 1) n - 1, or the shard's own stream
        without ``sync_bn``; written into ``out`` where given."""
        if data_group is not None and not sync_bn:
            return make(n, step_generator(rng, step, dev, stream, member,
                                          shard=index), out)
        gen = step_generator(rng, step, dev, stream, member)
        if size == 1:
            return make(n, gen, out)
        return take_rows(make(size * n, gen, None), index * n, n, out)

    def draw(rng, step: int, batch: Dict[str, Any], out=None,
             member: Optional[int] = None):
        if augmenter is None or "feat" in batch:
            return None
        if rng is None:
            raise ValueError("the channel augmenter draws from the run's "
                             "seed: pass rng")
        n, length = batch["wave"].shape
        return sharded(lambda rows, gen, o: augmenter.draw((rows, length),
                                                           gen, o),
                       n, rng, step, FRONTEND_STREAM, member, out)

    def draw_model(rng, step: int, model, batch: Dict[str, Any], out=None,
                   member: Optional[int] = None):
        # a model that draws in train mode (LCNN's dropout, ResNet's and
        # the attentive ConvNet's pooling noise) has draw(batch, frames,
        # generator, out); the others have none, or None
        if getattr(model, "draw", None) is None:
            return None
        if rng is None:
            raise ValueError("the model's dropout and noise draw from the "
                             "run's seed: pass rng or model_draws")
        if "feat" in batch:
            n, frames = batch["feat"].shape[:2]
        else:
            n, frames = batch["wave"].shape[0], frontend.feat_len
        return sharded(lambda rows, gen, o: model.draw(rows, frames, gen, o),
                       n, rng, step, MODEL_STREAM, member, out)

    def train_step(state: TrainState, batch: Dict[str, Any], rng=None,
                   adv_gate: float = 0.0, frontend_params=None,
                   draws=None, model_draws=None) -> Dict[str, torch.Tensor]:
        state.model.train()
        labels = batch["label"].to(dev).long()
        with torch.no_grad():
            if "feat" in batch:
                x = batch["feat"].to(dev)
            else:
                if draws is None:
                    draws = draw(rng, state.step, batch)
                x = frontend(batch, draws, frontend_params)
            if model_draws is None:
                model_draws = draw_model(rng, state.step, state.model, batch)
        state.zero_grad()
        with batch_norm_group(data_group if sync_bn else None):
            metrics, total, clf_loss = _losses(state, config, x, labels,
                                               batch, model_draws, adv_gate,
                                               dev)
            stats = None
            if config.remat_policy is not None:
                stats = [b.clone() for b in _running_stats(state.model)]
            # the backbone's loss trains the model and the loss module
            # only (JAX differentiates it w.r.t. params and loss_params);
            # the adversarial term's gradient reaches the classifiers'
            # parameters too, and is not accumulated there
            total.backward(inputs=state.trained_parameters())
        if stats is not None:      # undo the recompute's second update
            with torch.no_grad():
                for b, v in zip(_running_stats(state.model), stats):
                    b.copy_(v)
        if config.adv_aug:
            clf_loss.backward(inputs=[p for c in state.classifiers()
                                      for p in c.parameters()])
        state.apply_gradients(data_group)
        if data_group is not None and not sync_bn:
            _sync_running_stats(state.model, data_group)
        metrics["total_loss"] = total.detach()
        return mean_metrics(metrics, data_group)

    train_step.draw = draw
    train_step.draw_model = draw_model
    train_step.groups = [] if data_group is None else [data_group]
    train_step.frontend, train_step.sync_bn = frontend, sync_bn
    train_step.remat_policy = config.remat_policy
    return train_step


def _losses(state: TrainState, config: StepConfig, x: torch.Tensor,
            labels: torch.Tensor, batch: Dict[str, Any], model_draws,
            adv_gate, dev):
    """(metrics, the backbone's loss, the classifiers' loss or None) of the
    train-mode forward of ``x``; what follows the model's forward is the
    span ``asv.loss``."""
    feats, logits = _forward(state.model, x, model_draws,
                             config.remat_policy)
    with profiling.span("asv.loss", (feats, logits)) as s:
        base, _ = base_loss_and_score(config.base_loss, logits, labels)
        metrics = {"base_loss": base.detach()}
        if config.add_loss is None:
            total = base
        elif config.add_loss in ("isolate", "iso_sq"):
            add = state.loss_module(feats, labels)
            total = add * config.weight_loss
        else:
            add, _scores = state.loss_module(feats, labels)
            total = add if config.add_loss == "p2sgrad" \
                else add * config.weight_loss
        if config.add_loss is not None:
            metrics[config.add_loss] = add.detach()
        clf_loss = None
        if config.adv_aug:
            channel = batch["channel"].to(dev).long()
            if config.add_loss == "ang_iso":
                adv, acc = _channel_ce(state, config, feats, channel)
                metrics["adv_loss"], metrics["adv_acc"] = adv.detach(), acc
                total = total + state.gate(adv_gate) * adv
            # the classifier phase: the same embeddings, detached, against
            # the classifiers' parameters from before this step
            clf_loss, clf_acc = _channel_ce(state, config, feats.detach(),
                                            channel)
            metrics["clf_loss"] = clf_loss.detach()
            metrics["clf_acc"] = clf_acc
        return metrics, s.out(total), clf_loss


def _run_steps(train_step: Callable, state: TrainState,
               batches: Dict[str, torch.Tensor], n_steps: int, rng,
               adv_gate: float, frontend_params,
               draws: Optional[List] = None) -> Dict[str, torch.Tensor]:
    """``n_steps`` calls of the step over stacked batches, with each step's
    (augmenter's, model's) ``draws`` where given; the metrics stacked."""
    ms = [train_step(state, {k: v[i] for k, v in batches.items()}, rng,
                     adv_gate, frontend_params,
                     *((None, None) if draws is None else draws[i]))
          for i in range(n_steps)]
    return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}


def _check_capturable_groups(train_step: Callable, n_steps: int) -> None:
    """A CUDA graph captures NCCL's collectives only: a step that
    communicates over another backend (gloo) raises by name."""
    for g in getattr(train_step, "groups", []):
        backend = dist.get_backend(g)
        if backend != "nccl":
            raise ValueError(
                f"steps_per_call={n_steps} on the card captures the steps' "
                f"all-reduces in a CUDA graph, which NCCL's allow and "
                f"{backend}'s do not: run steps_per_call 1 over {backend}, "
                "or the NCCL backend")


@contextlib.contextmanager
def _named_capture_failure(train_step: Callable, n_steps: int):
    """A failed capture of steps that communicate re-raised with its cause
    named; nothing falls back to eager steps."""
    try:
        yield
    except RuntimeError as e:
        if not getattr(train_step, "groups", []):
            raise
        raise RuntimeError(
            f"capturing {n_steps} training steps with their NCCL "
            f"all-reduces as one CUDA graph failed: {e}") from e


class _GraphedSteps:
    """K training steps as one CUDA graph over a capturable
    :class:`TrainState`; see :func:`make_multi_step`."""

    def __init__(self, train_step: Callable, n_steps: int):
        self.train_step, self.n_steps = train_step, n_steps
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static: Dict[str, torch.Tensor] = {}
        self.draws: Optional[List] = None
        self.out: Dict[str, torch.Tensor] = {}
        self.captured: List[int] = []
        self.table: Optional[profiling.GraphTable] = None

    @staticmethod
    def _pointers(state) -> List[int]:
        return [t.data_ptr() for t in state.graph_tensors()]

    def _draws(self, model, rng, step: int, batches, out=None):
        """Each inner step's (augmenter's, model's) draws, made eagerly
        from (rng, step + i); written into ``out``'s buffers where given."""
        ds = []
        for i in range(self.n_steps):
            batch = {k: v[i] for k, v in batches.items()}
            a, m = (None, None) if out is None else out[i]
            ds.append((self.train_step.draw(rng, step + i, batch, a),
                       self.train_step.draw_model(rng, step + i, model,
                                                  batch, m)))
        return None if ds[0] == (None, None) else ds

    def __call__(self, state: TrainState, batches: Dict[str, torch.Tensor],
                 rng=None, adv_gate: float = 0.0,
                 frontend_params=None) -> Dict[str, torch.Tensor]:
        if not state.capturable:
            raise ValueError("a CUDA graph of training steps needs a "
                             "capturable TrainState "
                             "(create_train_state(capturable=True))")
        dev = state.lr.device
        if self.graph is None:
            _check_capturable_groups(self.train_step, self.n_steps)
            # The first call's K steps run eagerly on a side stream: real
            # steps of the run, which also warm up what the capture needs
            # (Adam's state, the libraries' workspaces, cuFFT's plans).
            # Then the capture records the same K steps over static
            # buffers (batches, the augmenter's and the model's draws),
            # running none.
            self.static = {k: v.to(dev, copy=True) for k, v in
                           batches.items()}
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                out = _run_steps(self.train_step, state, self.static,
                                 self.n_steps, rng, adv_gate,
                                 frontend_params)
                step, graph = state.step, torch.cuda.CUDAGraph()
                self.draws = self._draws(state.model, rng, step,
                                         self.static)
                cap = profiling.Capture(side, "train_steps", owner=self)
                with _named_capture_failure(self.train_step, self.n_steps), \
                        torch.cuda.graph(graph, stream=side), cap:
                    self.out = _run_steps(self.train_step, state,
                                          self.static, self.n_steps, rng,
                                          adv_gate, frontend_params,
                                          self.draws)
                state.step = step
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph, self.captured = graph, self._pointers(state)
            self.table = cap.table
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
        if self.draws is not None:
            self._draws(state.model, rng, state.step, self.static,
                        self.draws)
        state.set_rate()
        state.gate(adv_gate)
        with profiling.replay(self.table):
            self.graph.replay()
        state.step += self.n_steps
        return {k: v.clone() for k, v in self.out.items()}


def make_multi_step(train_step: Callable, n_steps: int) -> Callable:
    """``multi_step(state, batches, rng=None, adv_gate=0.0,
    frontend_params=None) -> metrics``: ``n_steps`` steps of ``train_step``
    over ``batches``, a dict of tensors with a leading (n_steps, ...) axis;
    each metric comes back as one (n_steps,) tensor. The JAX
    ``make_multi_step`` (a ``lax.scan``).

    On a CPU state it calls the step ``n_steps`` times. On the card the
    state must be capturable: the first call runs its steps eagerly, then
    captures them as one CUDA graph (front-end and augmenter, forward,
    backward, every optimizer); every later call copies its batches and
    the augmenter's and the model's draws for its steps into the graph's
    static buffers, writes the learning rates and the gate (constant within
    a call) and replays. The batches must keep their shapes. The capture
    records the graph's node table (``utils/profiling.Capture``), and a
    kernel launched inside the graph counts its launch on every replay. A
    step with
    ``remat_policy="conv_dot"`` is captured with its checkpointed backward
    (the recompute inside the graph). A data-parallel or
    mesh step's all-reduces are captured with it: NCCL's only (the step's
    ``groups`` over gloo raise ValueError). A failed capture
    raises; nothing falls back to eager steps."""
    graphed = _GraphedSteps(train_step, n_steps)

    def multi_step(state: TrainState, batches: Dict[str, torch.Tensor],
                   rng=None, adv_gate: float = 0.0,
                   frontend_params=None) -> Dict[str, torch.Tensor]:
        if next(state.model.parameters()).is_cuda:
            return graphed(state, batches, rng, adv_gate, frontend_params)
        return _run_steps(train_step, state, batches, n_steps, rng,
                          adv_gate, frontend_params)

    return multi_step


def eval_features(frontend: Optional[Callable], device) -> Callable:
    """``features(batch, frontend_params) -> x``, the eval step's input:
    the batch's 'feat' on ``device``, or ``frontend`` over its waveforms,
    an augmenting front-end with draws made once per batch shape from a
    generator seeded 0 and reused for every batch, as the JAX eval step
    passes ``PRNGKey(0)`` to its front-end."""
    augmenter = _augmenter(frontend)
    fixed: Dict[Any, Any] = {}

    def features(batch: Dict[str, Any], frontend_params=None):
        if "feat" in batch:
            return batch["feat"].to(device)
        shape = tuple(batch["wave"].shape)
        if augmenter is not None and shape not in fixed:
            fixed[shape] = augmenter.draw(
                shape, torch.Generator(device=device).manual_seed(0))
        return frontend(batch, fixed.get(shape), frontend_params)

    return features


def make_eval_step(config: StepConfig, frontend: Optional[Callable] = None,
                   device="cuda", data_group=None) -> Callable:
    """``step(state, batch, frontend_params=None) -> (metrics, score,
    feats)`` with the model in eval mode and no gradient, its input from
    :func:`eval_features`. Scores per ``add_loss`` as the JAX
    eval step (``steps.py:355-371``): the loss module's score for ang_iso
    and p2sgrad, the distance to the center for isolate and iso_sq, the
    base loss's for None and amsoftmax. With a ``data_group`` the batch is
    this rank's rows of the global one and the metrics come back averaged
    over the group (the scores stay the rank's own)."""
    _check(config, train=False)
    dev = resolve_device(device)
    features = eval_features(frontend, dev)

    def eval_step(state: TrainState, batch: Dict[str, Any],
                  frontend_params=None):
        state.model.eval()
        labels = batch["label"].to(dev).long()
        with torch.no_grad():
            x = features(batch, frontend_params)
            feats, logits = state.model(x)
            base, score = base_loss_and_score(config.base_loss, logits,
                                              labels)
            metrics = {"base_loss": base}
            if config.add_loss in ("isolate", "iso_sq"):
                metrics[config.add_loss] = state.loss_module(feats, labels)
                score = state.loss_module.score(feats)
            elif config.add_loss in ("ang_iso", "p2sgrad"):
                add, score = state.loss_module(feats, labels)
                metrics[config.add_loss] = add
        return mean_metrics(metrics, data_group), score, feats

    return eval_step
