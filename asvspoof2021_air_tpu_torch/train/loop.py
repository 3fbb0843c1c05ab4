"""Epoch-level training loop for every model family.

Counterpart of the JAX package's ``train/loop.py`` (``TrainConfig``,
``build_datasets``, ``setup_training``, ``train``) for ``model`` in
{"ecapa", "resnet", "lcnn", "res2net", "cnn", "rawnet"} and ``add_loss``
in {None, "isolate", "iso_sq", "ang_iso", "p2sgrad"}:

- data: cached feature files (``ASVspoof2019FeatureDataset``, or
  ``AugmentedFeatureDataset`` under ``LA_aug``/``DF_aug``/``LAPA_aug``/
  ``DFPA_aug``, with channel ids) batched by ``RatioMixIterator``, or,
  ``on_the_fly``, raw waveforms (``RawAudioDataset`` -> ``WaveformIterator``
  -> ``OnDeviceFrontend``, LFCC through kernel B1 on the card, after the
  channel augmenter under ``on_device_aug``, with the synthetic IR bank
  under ``apply_ir``; for RawNet2 ``WaveformFrontend``: the augmenter,
  then the waveforms tiled to ``rawnet_args["nb_samp"]`` samples); both
  iterators behind a ``PrefetchIterator``;
- the step: the model in train mode (ECAPA pools through kernels
  B4a/B4b; LCNN's dropout and ResNet's pooling noise draw from the run's
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

Flags of the JAX loop that this port does not cover raise
NotImplementedError (``check_supported``). ``ADV_AUG`` trains from
augmented feature files only: on the fly the JAX loop's batches carry no
channel ids, so its step fails there; the port refuses the pair. RawNet2
reads waveforms, so it trains on the fly only (from feature files the JAX
model would read a feature column as a waveform; the port refuses it).
``C`` and ``model_scale`` are the port's own fields, so tests can train a
narrow ECAPA; the JAX loop always trains C=512, scale 8. The other
families have fixed widths; the heads of LCNN and ConvNet are sized for
``feat_dim`` x ``feat_len``.
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
from asvspoof2021_air_tpu_torch.train.checkpoint import (
    restore_checkpoint, save_checkpoint)
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
    (``RAWNET2_DEFAULT_ARGS`` when None). It always trains through B4a/B4b
    (ECAPA) and the recompute VJPs, the JAX loop's ``fused_pool``/
    ``fused_bn``, so those are no fields; ``cli/train.py`` refuses a config
    file that turns them off."""

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


def check_supported(config: TrainConfig) -> None:
    """Raise NotImplementedError naming every flag of ``config`` that this
    port does not train with (ROADMAP Queue A lists them), and ValueError
    for ADV_AUG without augmented feature files, for rawnet from feature
    files and, as the JAX ``setup_training`` does, for rawnet with an
    add-loss."""
    c = config
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
    bad = [name for name, hit in (
        (f"feat={c.feat!r} on the fly (the port's front-end is LFCC)",
         c.on_the_fly and c.feat != "LFCC" and c.model != "rawnet"),
        (f"ensemble={c.ensemble}", c.ensemble > 1),
        ("visualize", c.visualize),
    ) if hit]
    if bad:
        raise NotImplementedError("not covered by the port's training "
                                  "slice: " + "; ".join(bad))


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


def setup_training(config: TrainConfig, steps_per_epoch: int, frontend=None,
                   device="cuda"):
    """(model, loss module, state, train step, eval step), the model and
    the loss module built by name (``models/registry.build_model``,
    ``losses/registry.build_loss``). The weights are drawn from a generator
    seeded with ``config.seed``: the model's first, then the loss
    module's, then the channel classifiers (ADV_AUG: one over the LA or DF
    channels, a second over the devices for LAPA/DFPA).
    With ``steps_per_call`` > 1 on the card the state is capturable, for
    the CUDA graph of K steps. The eval step scores clean; its attribute
    ``dev_eval_step`` is the dev pass's step, through the augmenter with
    fixed draws under ``dev_aug`` with ``on_device_aug``, as in JAX."""
    check_supported(config)
    dev = resolve_device(device)
    # the JAX setup_training's mapping: bf16 for "bfloat16", else f32
    dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" else None
    if dtype is None:
        disable_tf32()      # f32 training computes in full f32
    gen = setup_seed(config.seed)
    model = build_model(
        config.model, enc_dim=config.enc_dim,
        nclasses=1 if config.base_loss == "bce" else config.nclasses,
        feat_dim=config.feat_dim, feat_len=config.feat_len, dtype=dtype,
        generator=gen, device=dev, C=config.C,
        model_scale=config.model_scale, rawnet_args=config.rawnet_args)
    loss_mod = build_loss(config.add_loss, enc_dim=config.enc_dim,
                          r_real=config.r_real, r_fake=config.r_fake,
                          alpha=config.alpha, nclasses=config.nclasses,
                          generator=gen, device=dev)
    clf = clf2 = None
    dual = config.ADV_AUG and (config.LAPA_aug or config.DFPA_aug)
    if config.ADV_AUG:
        n_channels = len(proto.LA_CHANNELS if (config.LA_aug
                                               or config.LAPA_aug)
                         else proto.DF_CHANNELS)
        clf = ChannelClassifier(config.enc_dim, n_channels, config.lambda_,
                                generator=gen, device=dev)
        if dual:
            clf2 = ChannelClassifier(config.enc_dim, len(proto.DEVICES),
                                     config.lambda_, generator=gen,
                                     device=dev)
    sched = step_decay_schedule(config.lr, config.lr_decay, config.interval,
                                steps_per_epoch)
    sched_d = (step_decay_schedule(config.lr_d, config.lr_decay,
                                   config.interval, steps_per_epoch)
               if config.ADV_AUG else None)
    state = create_train_state(
        model, loss_mod, sched, config.beta_1, config.beta_2, config.eps,
        capturable=config.steps_per_call > 1 and dev.type == "cuda",
        classifier=clf, classifier2=clf2, schedule_d=sched_d)
    step_cfg = StepConfig(add_loss=config.add_loss,
                          base_loss=config.base_loss,
                          weight_loss=config.weight_loss,
                          adv_aug=config.ADV_AUG, dual_classifier=dual)
    eval_frontend = frontend.eval_view() if frontend is not None else None
    eval_step = make_eval_step(step_cfg, eval_frontend, dev)
    eval_step.dev_eval_step = (
        make_eval_step(step_cfg, frontend, dev)
        if config.dev_aug and config.on_device_aug and frontend is not None
        else eval_step)
    return (model, loss_mod, state,
            make_train_step(step_cfg, frontend, dev), eval_step)


def _tensors(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(batch[k])
            for k in ("feat", "wave", "length", "label", "channel")
            if k in batch}


def _eer(scores: np.ndarray, labels: np.ndarray) -> float:
    """EER as the min over both score signs."""
    return min(compute_eer(scores[labels == 0], scores[labels == 1])[0],
               compute_eer(-scores[labels == 0], -scores[labels == 1])[0])


def _eval_set_eer(config: TrainConfig, eval_set, state, eval_step,
                 frontend=None) -> float:
    """The eval-set EER of ``state``, scored as the JAX loop's
    ``test_on_eval`` scores it: on the fly, sequential waveform batches
    with the wrapped tail trimmed by count; from features,
    ``SequentialIterator`` batches with their ``valid`` mask."""
    B = config.batch_size
    scores, labels = [], []
    if frontend is not None:
        n = len(eval_set)
        batches = WaveformIterator(eval_set, B, frontend.min_samples(),
                                   ratio=1.0, shuffle=False,
                                   steps_per_epoch=-(-n // B)).epoch()
        for i, batch in enumerate(batches):
            _m, score, _f = eval_step(state, _tensors(batch))
            take = min(n - i * B, B)
            scores.append(score.float().cpu().numpy()[:take])
            labels.append(batch["label"][:take])
    else:
        for batch in SequentialIterator(eval_set, B, config.feat_len,
                                        config.padding):
            _m, score, _f = eval_step(state, _tensors(batch))
            scores.append(score.float().cpu().numpy()[batch["valid"]])
            labels.append(batch["label"][batch["valid"]])
    return _eer(np.concatenate(scores), np.concatenate(labels))


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
          device="cuda", return_state: bool = False):
    """Run the training loop; return the summary dict (and, with
    ``return_state``, the final :class:`TrainState` as well)."""
    check_supported(config)
    K = max(1, config.steps_per_call)
    if K > 1 and not config.on_the_fly and not config.pad_chop:
        raise ValueError("steps_per_call > 1 needs batches of one shape: "
                         "pad_chop=False collates each batch to its own "
                         "length")
    dev = resolve_device(device)
    setup_seed(config.seed)
    _prepare_out_fold(config)
    if train_set is None or dev_set is None:
        train_set, dev_set = build_datasets(config)
    if len(train_set) == 0 or len(dev_set) == 0:
        source = (config.path_to_database if config.on_the_fly
                  else config.path_to_features)
        raise FileNotFoundError(
            f"no data found under '{source}' "
            f"(train: {len(train_set)}, dev: {len(dev_set)}); expected "
            f"<path>/{{train,dev}}/{config.feat}/*.npy — "
            "run asvspoof2021_air_tpu.cli.preprocess first")

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
                                        device=dev)
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
        config, train_iter.steps_per_epoch, frontend=frontend, device=dev)
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
        if config.profile and epoch == start_epoch:
            profiling.enter_context(
                trace(os.path.join(config.out_fold, "profile")))
        i = 0

        def record(metrics, n_inner: int) -> None:
            # one device-to-host copy per metric per call, one open of the
            # log per call
            nonlocal i
            host = {k: np.atleast_1d(v.detach().float().cpu().numpy())
                    for k, v in metrics.items()}
            with open(os.path.join(config.out_fold, "train_loss.log"),
                      "a") as f:
                for j in range(n_inner):
                    for k, v in host.items():
                        train_log[k].append(float(v[j]))
                    f.write(f"{epoch}\t{i}\t{train_log[monitor][-1]}\n")
                    i += 1
            if i >= 20:
                profiling.close()

        pending = []
        for batch in train_iter.epoch():
            if K == 1:
                record(train_step(state, _tensors(batch), rng, adv_gate,
                                  frontend_params), 1)
                continue
            pending.append(_tensors(batch))
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
        for batch in dev_iter.epoch():
            metrics, score, _feats = eval_step.dev_eval_step(
                state, _tensors(batch), frontend_params)
            for k, v in metrics.items():
                dev_log[k].append(float(v))
            scores.append(score.float().cpu().numpy())
            labels.append(batch["label"])
        eer = _eer(np.concatenate(scores), np.concatenate(labels))
        val_loss = float(np.nanmean(dev_log[monitor]))
        with open(os.path.join(config.out_fold, "dev_loss.log"), "a") as f:
            f.write(f"{epoch}\t{val_loss}\t{eer}\n")

        # ---- eval-set EER ----
        if config.test_on_eval and eval_set is not None:
            test_eer = _eval_set_eer(config, eval_set, state, eval_step,
                                    frontend)
            with open(os.path.join(config.out_fold, "test_loss.log"),
                      "a") as f:
                f.write(f"{epoch}\t{test_eer}\n")

        # ---- checkpoints and model selection ----
        save_checkpoint(os.path.join(config.out_fold, "checkpoint",
                                     f"{epoch + 1}.pt"), state)
        if val_loss < prev_loss:
            save_checkpoint(os.path.join(config.out_fold, "best.pt"), state)
            prev_loss, early_stop = val_loss, 0
        else:
            early_stop += 1
        with open(meta_path, "w") as f:
            json.dump({"epoch": epoch + 1, "best_dev_loss": prev_loss,
                       "early_stop": early_stop}, f)
        summary.update(epochs=epoch + 1, dev_loss=val_loss, dev_eer=eer,
                       epoch_seconds=time.time() - t0)
        if early_stop == config.early_stop_patience:
            break

    summary["best_dev_loss"] = prev_loss
    return (summary, state) if return_state else summary
