"""Epoch-level training loop for every model family.

Counterpart of the JAX package's ``train/loop.py`` (``TrainConfig``,
``build_datasets``, ``setup_training``, ``train``) for ``model`` in
{"ecapa", "resnet", "lcnn", "res2net", "cnn", "rawnet"} and ``add_loss``
in {None, "isolate", "iso_sq", "ang_iso", "p2sgrad"}:

- data: cached feature files (``ASVspoof2019FeatureDataset``, or
  ``AugmentedFeatureDataset`` under ``LA_aug``/``DF_aug``/``LAPA_aug``/
  ``DFPA_aug``, with channel ids) batched by ``RatioMixIterator``, or,
  ``on_the_fly``, raw waveforms (``RawAudioDataset`` -> ``WaveformIterator``
  -> ``OnDeviceFrontend``, LFCC through kernel B1 on the card (or CQCC),
  after the channel augmenter under ``on_device_aug``, with the synthetic
  IR bank under ``apply_ir``; for RawNet2 ``WaveformFrontend``: the
  augmenter, then the waveforms tiled to ``rawnet_args["nb_samp"]``
  samples); both
  iterators behind a ``PrefetchIterator``;
- the step: the model in train mode (ECAPA pools through kernels
  B4a/B4b and the BN pairs take the recompute VJPs, unless
  ``fused_pool`` / ``fused_bn`` are "off"; LCNN's dropout and ResNet's
  pooling noise draw from the run's
  seed and the step) in f32 or bf16 (``compute_dtype``; SE-Res2Net50,
  ConvNet and RawNet2 compute in f32 under either, as the JAX registry
  builds them) -> the base loss
  and the add-loss (plus, under
  ``ADV_AUG``, the channel classifiers' CE behind the GRL from the second
  epoch on, and the classifiers' own phase) -> every optimizer;
  ``steps_per_call`` > 1 runs K steps per call, on the card as one CUDA
  graph (``train/steps.make_multi_step``), the epoch's tail shorter than
  K one step at a time;
- per epoch the dev pass (dev EER as the min over both score signs, dev
  loss; through the augmenter with fixed draws under ``dev_aug``), the
  eval-set EER with ``test_on_eval`` and an ``eval_set``, epoch
  and ``best`` checkpoints chosen by dev loss, ``train_meta.json`` and
  early stopping; ``continue_training`` restarts from ``best.pt`` and
  ``auto_resume`` from the newest epoch checkpoint with its model-selection
  history; ``profile`` traces the first ~20 steps into
  ``<out_fold>/profile``.

Writes ``args.json``, ``train_loss.log`` (``epoch step loss`` per step),
``dev_loss.log`` (``epoch loss eer``) and ``test_loss.log`` (``epoch
eer``) as the JAX loop does, and returns the same summary dict.

``ensemble`` M > 1 trains M systems in one step (``train/ensemble.py``):
one checkpoint holds every member and the shared step, and the dev and
eval scores are the members' mean. ``feat="CQCC"`` on the fly runs the
CQCC front-end. ``visualize`` writes the t-SNE/PCA figure of the dev
(and, with ``test_on_eval``, eval) embeddings and the loss centers every
third epoch (``visualize.py``, on the host). ``ADV_AUG`` trains from
augmented feature files only: on the fly the JAX loop's batches carry no
channel ids, so its step fails there; the port refuses the pair. RawNet2
reads waveforms, so it trains on the fly only (from feature files the JAX
model would read a feature column as a waveform; the port refuses it).
``C`` and ``model_scale`` are the port's own fields, so tests can train a
narrow ECAPA; the JAX loop always trains C=512, scale 8. The other
families have fixed widths; the heads of LCNN and ConvNet are sized for
``feat_dim`` x ``feat_len``.

Across GPUs (one process each under ``torchrun``, ``parallel/``), ``train``
takes ``mesh`` as the JAX loop does (default: a 1-D "data" mesh over every
rank). A single system trains data-parallel: every rank iterates the same
seeded global batches and takes its contiguous rows (``shard_batch``; the
batch size must split over the ranks), and the step is the one-process
step on the global batch (``train/steps.py``: BN over the global batch,
the gradients and metrics averaged). An ensemble spreads its members: over
a "model" mesh when the ranks divide M (``make_member_parallel_step``),
else over a ("model", "data") mesh of M x W / M when M divides the ranks
(``make_member_data_parallel_step``). The dev and eval passes shard their
batches the same way and gather the scores, so every rank computes the
same losses and EERs. Only rank 0 writes the logs, ``train_meta.json`` and
the checkpoints (an ensemble's members gathered to it), each write followed
by a barrier; a resume loads on every rank. Every rank loads every global
batch: W times the host reads of one process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import time
from collections import defaultdict
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from asvspoof2021_air_tpu_torch._device import disable_tf32, resolve_device
from asvspoof2021_air_tpu_torch.data import protocol as proto
from asvspoof2021_air_tpu_torch.data.datasets import (
    ASVspoof2019FeatureDataset, AugmentedFeatureDataset, RawAudioDataset)
from asvspoof2021_air_tpu_torch.data.pipeline import (
    RatioMixIterator, SequentialIterator, WaveformIterator)
from asvspoof2021_air_tpu_torch.data.prefetch import PrefetchIterator
from asvspoof2021_air_tpu_torch.losses.registry import build_loss
from asvspoof2021_air_tpu_torch.metrics.eer import compute_eer
from asvspoof2021_air_tpu_torch.models.classifier import ChannelClassifier
from asvspoof2021_air_tpu_torch.models.rawnet import RAWNET2_DEFAULT_ARGS
from asvspoof2021_air_tpu_torch.models.registry import build_model
from asvspoof2021_air_tpu_torch.ops.augment import (
    ChannelAugmenter, synthetic_ir_bank)
from asvspoof2021_air_tpu_torch.parallel.mesh import (
    Mesh, batch_sharding, gather, make_mesh, mean_metrics, replicate,
    shard_batch, world)
from asvspoof2021_air_tpu_torch.train.checkpoint import (
    restore_checkpoint, save_checkpoint)
from asvspoof2021_air_tpu_torch.train.ensemble import (
    ensemble_mesh, fuse_scores, init_ensemble_state, make_ensemble_eval_step,
    make_ensemble_train_step, make_member_data_parallel_step,
    make_member_parallel_step, member_data_mesh)
from asvspoof2021_air_tpu_torch.train.frontend import (
    OnDeviceFrontend, WaveformFrontend)
from asvspoof2021_air_tpu_torch.train.state import (
    create_train_state, step_decay_schedule)
from asvspoof2021_air_tpu_torch.train.steps import (
    StepConfig, make_eval_step, make_multi_step, make_train_step)
from asvspoof2021_air_tpu_torch.utils.profiling import trace
from asvspoof2021_air_tpu_torch.utils.seed import setup_seed


@dataclasses.dataclass
class TrainConfig:
    """The fields of the JAX ``TrainConfig`` that this port reads or refuses
    (``check_supported``), with their defaults, plus ``C`` and
    ``model_scale`` (ECAPA's widths). ``rawnet_args`` are RawNet2's
    (``RAWNET2_DEFAULT_ARGS`` when None).

    ``fused_pool`` (ECAPA's attention tail through kernels B4a/B4b) and
    ``fused_bn`` (every family's train-mode BN pairs through the recompute
    VJPs of ``ops/bn_relu_vjp.py``) take "auto", "on" or "off", as in the
    JAX loop. In the port "auto" means "on" on the card and on the CPU:
    the hand-written path is the port's training path, and on the CPU its
    kernels' plain versions compute the same functions. The JAX loop's
    "auto" is "on" only on a TPU, because there its Pallas kernels run
    compiled and elsewhere only in interpret mode. "off" builds the
    unfused model (:func:`fused_flags`), the path the JAX loop takes off a
    TPU; it is reached only by asking for it by name."""

    out_fold: str = "./models/try"
    seed: int = 688
    access_type: str = "LA"
    path_to_database: str = ""
    path_to_features: str = ""
    path_to_aug_features: str = ""
    ratio: float = 0.5
    feat: str = "LFCC"
    feat_len: int = 750
    feat_dim: int = 60
    pad_chop: bool = True
    padding: str = "repeat"
    enc_dim: int = 256
    model: str = "lcnn"
    num_epochs: int = 200
    batch_size: int = 64
    lr: float = 5e-4
    lr_decay: float = 0.5
    interval: int = 30
    beta_1: float = 0.9
    beta_2: float = 0.999
    eps: float = 1e-8
    base_loss: str = "ce"
    add_loss: Optional[str] = None
    weight_loss: float = 1.0
    r_real: float = 0.9
    r_fake: float = 0.2
    alpha: float = 20.0
    test_only: bool = False
    continue_training: bool = False
    ADV_AUG: bool = False
    LA_aug: bool = False
    DF_aug: bool = False
    LAPA_aug: bool = False
    DFPA_aug: bool = False
    lambda_: float = 0.05
    lr_d: float = 1e-4
    test_on_eval: bool = False
    visualize: bool = False
    early_stop_patience: int = 500
    nclasses: int = 2
    compute_dtype: str = "float32"   # "bfloat16": bf16 compute, f32 params
    fused_pool: str = "auto"         # auto | on | off ("auto" is "on")
    fused_bn: str = "auto"           # auto | on | off ("auto" is "on")
    on_the_fly: bool = False
    on_device_aug: bool = False
    dev_aug: bool = False
    apply_ir: bool = False
    auto_resume: bool = False
    steps_per_call: int = 1
    profile: bool = False
    ensemble: int = 1
    C: int = 512
    model_scale: int = 8
    rawnet_args: Optional[dict] = None


def _aug_flag(config: TrainConfig) -> bool:
    return (config.LA_aug or config.DF_aug or config.LAPA_aug
            or config.DFPA_aug)


FUSED_VALUES = ("auto", "on", "off")


def fused_flags(config: TrainConfig) -> Dict[str, bool]:
    """The ``build_model`` arguments ``fused_pool`` and ``fused_bn`` for
    ``config``: True for "auto" and "on", False for "off"."""
    out = {}
    for key in ("fused_pool", "fused_bn"):
        value = getattr(config, key)
        if value not in FUSED_VALUES:
            raise ValueError(f"{key} must be one of {FUSED_VALUES}, got "
                             f"{value!r}")
        out[key] = value != "off"
    return out


def check_supported(config: TrainConfig) -> None:
    """Raise ValueError for a ``fused_pool``/``fused_bn`` value other than
    auto, on and off, for ADV_AUG without augmented feature files, for
    rawnet from feature files and, as the JAX package does, for rawnet
    with an add-loss and for an on-the-fly feature other than LFCC and
    CQCC (the JAX front-end's refusal)."""
    c = config
    fused_flags(c)
    if c.model == "rawnet" and c.add_loss is not None:
        raise ValueError(
            "rawnet returns class logits, not an enc_dim embedding; train it "
            "with the base CE loss (add_loss None)")
    if c.model == "rawnet" and not c.on_the_fly:
        raise ValueError("rawnet reads raw waveforms: train it on_the_fly")
    if c.ADV_AUG and not _aug_flag(c):
        raise ValueError("ADV_AUG requires an augmentation flag")
    if c.ADV_AUG and c.on_the_fly:
        raise ValueError(
            "ADV_AUG with on_the_fly: the classifiers train on the channel "
            "ids of augmented feature files (LA_aug/DF_aug/LAPA_aug/"
            "DFPA_aug), and waveform batches carry none")
    if (c.on_the_fly and c.model != "rawnet"
            and c.feat not in ("LFCC", "CQCC")):
        raise ValueError(f"on-the-fly front-end supports LFCC/CQCC, got "
                         f"{c.feat}")


def _prepare_out_fold(config: TrainConfig) -> None:
    if config.test_only or config.continue_training:
        return
    if config.auto_resume and os.path.isdir(
            os.path.join(config.out_fold, "checkpoint")):
        return      # resuming: keep the logs and checkpoints
    for d in (config.out_fold, os.path.join(config.out_fold, "checkpoint")):
        if os.path.exists(d):
            shutil.rmtree(d)
        os.makedirs(d)
    with open(os.path.join(config.out_fold, "args.json"), "w") as f:
        json.dump(dataclasses.asdict(config), f, indent=2, sort_keys=True)
    for name in ("train_loss.log", "dev_loss.log", "test_loss.log"):
        with open(os.path.join(config.out_fold, name), "w") as f:
            f.write(f"Start recording {name.split('_')[0]} loss ...\n")


def build_datasets(config: TrainConfig):
    """(train, dev) datasets by the JAX loop's rules: raw audio on the fly,
    else the feature cache, original + augmented under an aug flag."""
    if config.on_the_fly:
        return tuple(RawAudioDataset(config.access_type,
                                     config.path_to_database, part)
                     for part in ("train", "dev"))
    if _aug_flag(config):
        variant = "LA" if (config.LA_aug or config.LAPA_aug) else "DF"
        with_device = config.LAPA_aug or config.DFPA_aug
        return tuple(AugmentedFeatureDataset(
            config.path_to_features, config.path_to_aug_features, part,
            config.feat, variant, with_device) for part in ("train", "dev"))
    return tuple(ASVspoof2019FeatureDataset(
        config.access_type, config.path_to_features, part, config.feat)
        for part in ("train", "dev"))


def _axis_group(mesh: Optional[Mesh], axis: str):
    """``mesh``'s group along ``axis``; None without the mesh or the axis."""
    if mesh is None or axis not in mesh.axis_names:
        return None
    return mesh.group(axis)


def resolve_mesh(config: TrainConfig, mesh: Optional[Mesh], device) -> Mesh:
    """The mesh ``train`` runs over: ``mesh``, by default a 1-D "data" mesh
    over every rank; an ensemble over a data mesh of W > 1 ranks spreads
    its M members, over a "model" mesh (``ensemble_mesh``) when W divides
    M, else over an M x W / M ("model", "data") mesh (``member_data_mesh``)
    when M divides W. Other pairs raise ValueError, and so does a "model"
    axis for a single system."""
    mesh = make_mesh(device) if mesh is None else mesh
    M, axes = config.ensemble, mesh.axis_names
    if M == 1 and "model" in axes:
        raise ValueError("a mesh with a 'model' axis trains an ensemble: "
                         "set ensemble > 1")
    if M == 1 or "model" in axes or mesh.size("data") == 1:
        return mesh
    W = mesh.size("data")
    if M % W == 0:
        return ensemble_mesh(M, device)
    if W % M == 0:
        return member_data_mesh(M, W // M, device)
    raise ValueError(f"an ensemble of {M} members does not spread over "
                     f"{W} ranks: use a rank count that divides {M} or "
                     f"that {M} divides")


def setup_training(config: TrainConfig, steps_per_epoch: int, frontend=None,
                   device="cuda", mesh: Optional[Mesh] = None):
    """(model, loss module, state, train step, eval step), the model and
    the loss module built by name (``models/registry.build_model``,
    ``losses/registry.build_loss``). The weights are drawn from a generator
    seeded with ``config.seed``: the model's first, then the loss
    module's, then the channel classifiers (ADV_AUG: one over the LA or DF
    channels, a second over the devices for LAPA/DFPA). With ``ensemble``
    M > 1 the state is an ``EnsembleState`` of M such members, member i
    drawn after member i - 1, the steps ``train/ensemble.py``'s, and the
    model and loss module member 0's.
    With ``steps_per_call`` > 1 on the card the state is capturable, for
    the CUDA graph of K steps. The eval step scores clean; its attribute
    ``dev_eval_step`` is the dev pass's step, through the augmenter with
    fixed draws under ``dev_aug`` with ``on_device_aug``, as in JAX.

    With a ``mesh`` of :func:`resolve_mesh`'s kinds the state and the steps
    are those of its ranks: the data-parallel steps over its "data" group
    (the eval step averaging its metrics there), or this rank's ensemble
    members with ``make_member_parallel_step`` or
    ``make_member_data_parallel_step``; the state is broadcast from rank 0
    (every rank draws the same weights from the seed already)."""
    check_supported(config)
    dev = resolve_device(device)
    # the JAX setup_training's mapping: bf16 for "bfloat16", else f32
    dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" else None
    if dtype is None:
        disable_tf32()      # f32 training computes in full f32
    gen = setup_seed(config.seed)
    dual = config.ADV_AUG and (config.LAPA_aug or config.DFPA_aug)
    sched = step_decay_schedule(config.lr, config.lr_decay, config.interval,
                                steps_per_epoch)
    sched_d = (step_decay_schedule(config.lr_d, config.lr_decay,
                                   config.interval, steps_per_epoch)
               if config.ADV_AUG else None)

    def make_state(_member: int = 0):
        model = build_model(
            config.model, enc_dim=config.enc_dim,
            nclasses=1 if config.base_loss == "bce" else config.nclasses,
            feat_dim=config.feat_dim, feat_len=config.feat_len, dtype=dtype,
            generator=gen, device=dev, C=config.C,
            model_scale=config.model_scale, rawnet_args=config.rawnet_args,
            **fused_flags(config))
        loss_mod = build_loss(config.add_loss, enc_dim=config.enc_dim,
                              r_real=config.r_real, r_fake=config.r_fake,
                              alpha=config.alpha, nclasses=config.nclasses,
                              generator=gen, device=dev)
        clf = clf2 = None
        if config.ADV_AUG:
            n_channels = len(proto.LA_CHANNELS if (config.LA_aug
                                                   or config.LAPA_aug)
                             else proto.DF_CHANNELS)
            clf = ChannelClassifier(config.enc_dim, n_channels,
                                    config.lambda_, generator=gen,
                                    device=dev)
            if dual:
                clf2 = ChannelClassifier(config.enc_dim, len(proto.DEVICES),
                                         config.lambda_, generator=gen,
                                         device=dev)
        return create_train_state(
            model, loss_mod, sched, config.beta_1, config.beta_2, config.eps,
            capturable=config.steps_per_call > 1 and dev.type == "cuda",
            classifier=clf, classifier2=clf2, schedule_d=sched_d)

    step_cfg = StepConfig(add_loss=config.add_loss,
                          base_loss=config.base_loss,
                          weight_loss=config.weight_loss,
                          adv_aug=config.ADV_AUG, dual_classifier=dual)
    eval_frontend = frontend.eval_view() if frontend is not None else None
    data_group = _axis_group(mesh, "data")
    model_axis = mesh is not None and "model" in mesh.axis_names
    M = config.ensemble
    # the member x data mesh's member step is JAX's grad_axis step
    train_step = make_train_step(step_cfg, frontend, dev,
                                 data_group=data_group,
                                 sync_bn=not model_axis)
    eval_step = make_eval_step(step_cfg, eval_frontend, dev, data_group)
    dev_eval_step = (
        make_eval_step(step_cfg, frontend, dev, data_group)
        if config.dev_aug and config.on_device_aug and frontend is not None
        else eval_step)
    if M > 1 and model_axis:
        state = init_ensemble_state(make_state, M, mesh)
        first = state.members[0]
        if data_group is not None:
            train_step = make_member_data_parallel_step(train_step, M, mesh)
        else:
            train_step = make_member_parallel_step(train_step, M, mesh,
                                                   frontend)
        ens_eval = make_ensemble_eval_step(eval_step, eval_frontend)
        dev_eval_step = (ens_eval if dev_eval_step is eval_step
                         else make_ensemble_eval_step(dev_eval_step,
                                                      frontend))
        eval_step = ens_eval
    elif M > 1:
        state = init_ensemble_state(make_state, M)
        first = state.members[0]
        train_step = make_ensemble_train_step(train_step, M,
                                              frontend=frontend)
        ens_eval = make_ensemble_eval_step(eval_step, eval_frontend)
        dev_eval_step = (ens_eval if dev_eval_step is eval_step
                         else make_ensemble_eval_step(dev_eval_step,
                                                      frontend))
        eval_step = ens_eval
    else:
        state = first = make_state()
        if mesh is not None:
            replicate(state, mesh)
    eval_step.dev_eval_step = dev_eval_step
    return first.model, first.loss_module, state, train_step, eval_step


def _tensors(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(batch[k])
            for k in ("feat", "wave", "length", "label", "channel")
            if k in batch}


def _fused_host_scores(score: torch.Tensor) -> np.ndarray:
    """Eval-step scores on the host: an ensemble's (M, B) averaged over
    the members (``fuse_scores``), a single system's (B,) as they are."""
    sc = score.float().cpu().numpy()
    return fuse_scores(sc) if sc.ndim == 2 else sc


def _eer(scores: np.ndarray, labels: np.ndarray) -> float:
    """EER as the min over both score signs."""
    return min(compute_eer(scores[labels == 0], scores[labels == 1])[0],
               compute_eer(-scores[labels == 0], -scores[labels == 1])[0])


def _local_rows(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of a global batch: its "data" shard, or all of
    them on a mesh without one."""
    if "data" not in mesh.axis_names or mesh.size("data") == 1:
        return batch
    return shard_batch(batch, mesh)


def _evaluate(step, state, batch: Dict[str, Any], mesh: Mesh,
              frontend_params=None, feats_out: Optional[list] = None):
    """(metrics, the global batch's scores on the host, an ensemble's
    fused) of the eval ``step`` on this rank's rows of ``batch``: the
    scores gathered over "data" (rows) and "model" (members), the metrics
    (averaged over "data" by the step) averaged over "model". With
    ``feats_out``, the batch's embeddings (an ensemble's first local
    member's), gathered over "data", are appended to it on the host."""
    metrics, score, feats = step(state, _tensors(_local_rows(batch, mesh)),
                                 frontend_params)
    score = score.float()
    data, model = _axis_group(mesh, "data"), _axis_group(mesh, "model")
    if feats_out is not None:
        feats = feats.float()
        if feats.dim() == 3:                 # an ensemble's (M, B, E)
            feats = feats[0]
        if data is not None:
            feats = torch.cat(gather(feats, data).unbind(), dim=0)
        feats_out.append(feats.cpu().numpy())
    if data is not None:
        score = torch.cat(gather(score, data).unbind(), dim=-1)
    if model is not None:
        score = gather(score, model).flatten(0, 1)
        metrics = mean_metrics(metrics, model)
    return metrics, _fused_host_scores(score)


def _eval_set_eer(config: TrainConfig, eval_set, state, eval_step,
                  mesh: Mesh, frontend=None, embed: bool = False):
    """The eval-set EER of ``state``, scored as the JAX loop's
    ``test_on_eval`` scores it: on the fly, sequential waveform batches
    with the wrapped tail trimmed by count; from features,
    ``SequentialIterator`` batches with their ``valid`` mask; each batch
    over the mesh as :func:`_evaluate`. With ``embed``, (EER, the
    trials' embeddings, their labels)."""
    B = config.batch_size
    scores, labels, feats = [], [], []
    keep = []
    out = feats if embed else None
    if frontend is not None:
        n = len(eval_set)
        batches = WaveformIterator(eval_set, B, frontend.min_samples(),
                                   ratio=1.0, shuffle=False,
                                   steps_per_epoch=-(-n // B)).epoch()
        for i, batch in enumerate(batches):
            _m, score = _evaluate(eval_step, state, batch, mesh,
                                  feats_out=out)
            keep.append(slice(0, min(n - i * B, B)))
            scores.append(score[keep[-1]])
            labels.append(batch["label"][keep[-1]])
    else:
        for batch in SequentialIterator(eval_set, B, config.feat_len,
                                        config.padding):
            _m, score = _evaluate(eval_step, state, batch, mesh,
                                  feats_out=out)
            keep.append(batch["valid"])
            scores.append(score[keep[-1]])
            labels.append(batch["label"][keep[-1]])
    eer = _eer(np.concatenate(scores), np.concatenate(labels))
    if not embed:
        return eer
    return (eer, np.concatenate([f[k] for f, k in zip(feats, keep)]),
            np.concatenate(labels))


def _visualize(config: TrainConfig, state, dev_feats, dev_labels,
               eval_feats, eval_labels, epoch: int) -> str:
    """``embedding_vis_epoch<epoch>.pdf`` in the run folder: the loss
    center(s) of a one-class add-loss (an ensemble's first member's), else
    the bona fide dev embeddings' mean."""
    from asvspoof2021_air_tpu_torch.visualize import visualize_dev_and_eval

    if config.add_loss in ("isolate", "iso_sq", "ang_iso"):
        loss_module = state.loss_module
        if isinstance(loss_module, (list, tuple)):
            loss_module = loss_module[0]
        center = loss_module.center.detach().float().cpu().numpy()
        if config.ensemble > 1 and center.ndim == 3:
            center = center[0]
    else:
        center = dev_feats[dev_labels == 0].mean(0, keepdims=True)
    return visualize_dev_and_eval(
        dev_feats, dev_labels, eval_feats, eval_labels, center,
        seed=config.seed, out_fold=config.out_fold, epoch=epoch)


def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _checkpoint_state(state, mesh: Mesh) -> Optional[Dict[str, Any]]:
    """What rank 0 writes as a checkpoint: its state's ``state_dict``, or,
    for an ensemble spread over a "model" axis, every member's, gathered
    from the ranks in member order (a collective: every rank calls it; the
    others get None)."""
    if _axis_group(mesh, "model") is None:
        return state.state_dict()
    sd = state.state_dict()
    mine = list(zip(state.member_ids, _to_cpu(sd["members"])))
    rank, size = world()
    parts = [None] * size if rank == 0 else None
    dist.gather_object(mine, parts, dst=0)
    if rank != 0:
        return None
    members = {}
    for part in parts:
        for i, m in part:
            members.setdefault(i, m)
    return {"step": sd["step"],
            "members": [members[i] for i in range(state.n_members)]}


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def _resume(config: TrainConfig, state, meta_path: str):
    """(start epoch, best dev loss, early-stop count) after restoring
    ``state`` as ``continue_training`` or ``auto_resume`` asks."""
    start, prev_loss, early_stop = 0, 1e8, 0
    if config.continue_training:
        restore_checkpoint(os.path.join(config.out_fold, "best.pt"), state)
    elif config.auto_resume:
        ckpt_dir = os.path.join(config.out_fold, "checkpoint")
        epochs = sorted(
            (int(f[:-3]) for f in os.listdir(ckpt_dir)
             if f.endswith(".pt") and f[:-3].isdigit()),
            reverse=True) if os.path.isdir(ckpt_dir) else []
        if epochs:
            restore_checkpoint(os.path.join(ckpt_dir, f"{epochs[0]}.pt"),
                               state)
            start = epochs[0]
            # the model-selection history, so the first epoch after the
            # resume cannot overwrite best.pt with a worse dev loss
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    meta = json.load(f)
                prev_loss = meta.get("best_dev_loss", prev_loss)
                early_stop = meta.get("early_stop", early_stop)
    return start, prev_loss, early_stop


def train(config: TrainConfig, train_set=None, dev_set=None, eval_set=None,
          device="cuda", return_state: bool = False,
          mesh: Optional[Mesh] = None):
    """Run the training loop; return the summary dict (and, with
    ``return_state``, the final :class:`TrainState` as well). Under a
    process group every rank calls it with the same arguments; ``mesh``
    as in the module docstring (:func:`resolve_mesh`)."""
    check_supported(config)
    K = max(1, config.steps_per_call)
    if K > 1 and not config.on_the_fly and not config.pad_chop:
        raise ValueError("steps_per_call > 1 needs batches of one shape: "
                         "pad_chop=False collates each batch to its own "
                         "length")
    dev = resolve_device(device)
    mesh = resolve_mesh(config, mesh, dev)
    if "data" in mesh.axis_names:
        batch_sharding(mesh)(config.batch_size)   # raises if W does not
    lead = world()[0] == 0                        # divide the batch
    setup_seed(config.seed)
    if lead:
        _prepare_out_fold(config)
    _barrier()
    if train_set is None or dev_set is None:
        train_set, dev_set = build_datasets(config)
    if len(train_set) == 0 or len(dev_set) == 0:
        source = (config.path_to_database if config.on_the_fly
                  else config.path_to_features)
        raise FileNotFoundError(
            f"no data found under '{source}' "
            f"(train: {len(train_set)}, dev: {len(dev_set)}); expected "
            f"<path>/{{train,dev}}/{config.feat}/*.npy — "
            "run asvspoof2021_air_tpu_torch.cli.preprocess first")

    monitor = config.add_loss or "base_loss"
    frontend = None
    if config.on_the_fly:
        augmenter = None
        if config.on_device_aug:
            augmenter = ChannelAugmenter(
                ir_bank=synthetic_ir_bank() if config.apply_ir else None,
                device=dev)
        if config.model == "rawnet":
            nb_samp = (config.rawnet_args or RAWNET2_DEFAULT_ARGS)["nb_samp"]
            frontend = WaveformFrontend(nb_samp, augmenter=augmenter,
                                        apply_ir=config.apply_ir, device=dev)
        else:
            frontend = OnDeviceFrontend(feat_len=config.feat_len,
                                        padding=config.padding,
                                        augmenter=augmenter,
                                        apply_ir=config.apply_ir,
                                        device=dev, feature=config.feat)
        max_samples = frontend.min_samples()
        train_iter, dev_iter = (WaveformIterator(
            data, config.batch_size, max_samples, config.ratio, seed=seed)
            for data, seed in ((train_set, config.seed),
                               (dev_set, config.seed + 1)))
    else:
        train_iter, dev_iter = (RatioMixIterator(
            data, config.batch_size, config.ratio, feat_len=config.feat_len,
            padding=config.padding, seed=seed, pad_chop=config.pad_chop)
            for data, seed in ((train_set, config.seed),
                               (dev_set, config.seed + 1)))
    train_iter = PrefetchIterator(train_iter, depth=2)
    dev_iter = PrefetchIterator(dev_iter, depth=2)
    _model, _loss, state, train_step, eval_step = setup_training(
        config, train_iter.steps_per_epoch, frontend=frontend, device=dev,
        mesh=mesh)
    multi_step = make_multi_step(train_step, K) if K > 1 else None

    meta_path = os.path.join(config.out_fold, "train_meta.json")
    start_epoch, prev_loss, early_stop = _resume(config, state, meta_path)
    # the augmenter's base seed (the JAX loop's PRNGKey(seed ^ 0x5EED));
    # each step draws from it and its own step count
    rng = config.seed ^ 0x5EED
    frontend_params = frontend.params if frontend is not None else None
    summary: Dict[str, Any] = {"epochs": 0}
    for epoch in range(start_epoch, config.num_epochs):
        adv_gate = 1.0 if (config.ADV_AUG and epoch > 0) else 0.0
        t0 = time.time()
        train_log = defaultdict(list)
        profiling = contextlib.ExitStack()
        if config.profile and epoch == start_epoch and lead:
            profiling.enter_context(
                trace(os.path.join(config.out_fold, "profile")))
        i = 0

        def record(metrics, n_inner: int) -> None:
            # one device-to-host copy per metric per call, one open of the
            # log per call
            nonlocal i
            host = {k: np.atleast_1d(v.detach().float().cpu().numpy())
                    for k, v in metrics.items()}
            with (open(os.path.join(config.out_fold, "train_loss.log"), "a")
                  if lead else contextlib.nullcontext()) as f:
                for j in range(n_inner):
                    for k, v in host.items():
                        train_log[k].append(float(v[j]))
                    if lead:
                        f.write(f"{epoch}\t{i}\t{train_log[monitor][-1]}\n")
                    i += 1
            if i >= 20:
                profiling.close()

        pending = []
        for batch in train_iter.epoch():
            batch = _tensors(_local_rows(batch, mesh))
            if K == 1:
                record(train_step(state, batch, rng, adv_gate,
                                  frontend_params), 1)
                continue
            pending.append(batch)
            if len(pending) < K:
                continue
            stacked = {k: torch.stack([b[k] for b in pending])
                       for k in pending[0]}
            pending = []
            record(multi_step(state, stacked, rng, adv_gate,
                              frontend_params), K)
        for batch in pending:       # the epoch's tail shorter than K
            record(train_step(state, batch, rng, adv_gate, frontend_params),
                   1)
        profiling.close()

        # ---- validation (through the augmenter under dev_aug) ----
        dev_log = defaultdict(list)
        scores, labels = [], []
        # the reference plots every third epoch, the first included
        plot = config.visualize and (epoch + 1) % 3 == 1
        dev_feats = [] if plot else None
        for batch in dev_iter.epoch():
            metrics, score = _evaluate(eval_step.dev_eval_step, state,
                                       batch, mesh, frontend_params,
                                       feats_out=dev_feats)
            for k, v in metrics.items():
                dev_log[k].append(float(v))
            scores.append(score)
            labels.append(batch["label"])
        eer = _eer(np.concatenate(scores), np.concatenate(labels))
        val_loss = float(np.nanmean(dev_log[monitor]))
        if lead:
            with open(os.path.join(config.out_fold, "dev_loss.log"),
                      "a") as f:
                f.write(f"{epoch}\t{val_loss}\t{eer}\n")

        # ---- eval-set EER ----
        eval_feats = eval_labels = None
        if config.test_on_eval and eval_set is not None:
            test_eer = _eval_set_eer(config, eval_set, state, eval_step,
                                     mesh, frontend, embed=plot)
            if plot:
                test_eer, eval_feats, eval_labels = test_eer
            if lead:
                with open(os.path.join(config.out_fold, "test_loss.log"),
                          "a") as f:
                    f.write(f"{epoch}\t{test_eer}\n")

        # ---- embedding visualization: dev and eval panels, dev only
        # without test_on_eval (t-SNE and PCA on the host) ----
        if plot and lead:
            _visualize(config, state, np.concatenate(dev_feats),
                       np.concatenate(labels), eval_feats, eval_labels,
                       epoch + 1)

        # ---- checkpoints and model selection (rank 0 writes) ----
        ckpt = _checkpoint_state(state, mesh)
        improved = val_loss < prev_loss
        if improved:
            prev_loss, early_stop = val_loss, 0
        else:
            early_stop += 1
        if lead:
            save_checkpoint(os.path.join(config.out_fold, "checkpoint",
                                         f"{epoch + 1}.pt"), ckpt)
            if improved:
                save_checkpoint(os.path.join(config.out_fold, "best.pt"),
                                ckpt)
            with open(meta_path, "w") as f:
                json.dump({"epoch": epoch + 1, "best_dev_loss": prev_loss,
                           "early_stop": early_stop}, f)
        del ckpt
        _barrier()
        summary.update(epochs=epoch + 1, dev_loss=val_loss, dev_eer=eer,
                       epoch_seconds=time.time() - t0)
        if early_stop == config.early_stop_patience:
            break

    summary["best_dev_loss"] = prev_loss
    return (summary, state) if return_state else summary
