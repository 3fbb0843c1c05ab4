"""Epoch-level training loop for ECAPA-TDNN trained on the fly from raw
waveforms.

Counterpart of the JAX package's ``train/loop.py`` (``TrainConfig``,
``setup_training``, ``train``) for ``model="ecapa"`` with
``on_the_fly=True``: ``RawAudioDataset`` -> ``WaveformIterator`` (both
iterators behind a ``PrefetchIterator``) -> ``OnDeviceFrontend`` (LFCC,
kernel B1 on the card) -> ECAPA in train mode (kernels B4a/B4b) -> the
base loss and the add-loss -> both optimizers; per epoch the dev pass
(dev EER as the min over both score signs, dev loss), epoch and ``best``
checkpoints chosen by dev loss, ``train_meta.json`` and early stopping.
Writes ``args.json``, ``train_loss.log`` (``epoch step loss`` per step) and
``dev_loss.log`` (``epoch loss eer`` per epoch) as the JAX loop does, and
returns the same summary dict.

Flags of the JAX loop that this port does not cover raise
NotImplementedError (``check_supported``). ``C`` and ``model_scale`` are
the port's own fields, so tests can train a narrow ECAPA; the JAX loop
always trains C=512, scale 8.
"""

from __future__ import annotations

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
from asvspoof2021_air_tpu_torch.data.datasets import RawAudioDataset
from asvspoof2021_air_tpu_torch.data.pipeline import WaveformIterator
from asvspoof2021_air_tpu_torch.data.prefetch import PrefetchIterator
from asvspoof2021_air_tpu_torch.losses.one_class import OCSoftmax
from asvspoof2021_air_tpu_torch.metrics.eer import compute_eer
from asvspoof2021_air_tpu_torch.models.ecapa import ECAPA_TDNN
from asvspoof2021_air_tpu_torch.train.checkpoint import save_checkpoint
from asvspoof2021_air_tpu_torch.train.frontend import OnDeviceFrontend
from asvspoof2021_air_tpu_torch.train.state import (
    create_train_state, step_decay_schedule)
from asvspoof2021_air_tpu_torch.train.steps import (
    StepConfig, make_eval_step, make_train_step)
from asvspoof2021_air_tpu_torch.utils.seed import setup_seed


@dataclasses.dataclass
class TrainConfig:
    """The fields of the JAX ``TrainConfig`` that this port reads or refuses
    (``check_supported``), with their defaults, plus ``C`` and
    ``model_scale``. It always trains through B4a/B4b and the recompute
    VJP, the JAX loop's ``fused_pool``/``fused_bn``, so those are no
    fields; ``cli/train.py`` refuses a config file that turns them off."""

    out_fold: str = "./models/try"
    seed: int = 688
    access_type: str = "LA"
    path_to_database: str = ""
    ratio: float = 0.5
    feat: str = "LFCC"
    feat_len: int = 750
    feat_dim: int = 60
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
    test_on_eval: bool = False
    visualize: bool = False
    early_stop_patience: int = 500
    nclasses: int = 2
    compute_dtype: str = "float32"
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


def check_supported(config: TrainConfig) -> None:
    """Raise NotImplementedError naming every flag of ``config`` that this
    port does not train with (ROADMAP Queue A lists them)."""
    c = config
    bad = [name for name, hit in (
        (f"model={c.model!r} (the port trains 'ecapa')", c.model != "ecapa"),
        (f"add_loss={c.add_loss!r} (the port trains None or 'ang_iso')",
         c.add_loss not in (None, "ang_iso")),
        ("on_the_fly=False (the feature-file datasets)", not c.on_the_fly),
        (f"feat={c.feat!r} (the port's front-end is LFCC)", c.feat != "LFCC"),
        ("LA_aug/DF_aug/LAPA_aug/DFPA_aug",
         c.LA_aug or c.DF_aug or c.LAPA_aug or c.DFPA_aug),
        ("ADV_AUG", c.ADV_AUG),
        ("on_device_aug/dev_aug/apply_ir (the channel augmenter)",
         c.on_device_aug or c.dev_aug or c.apply_ir),
        (f"ensemble={c.ensemble}", c.ensemble > 1),
        (f"steps_per_call={c.steps_per_call}", c.steps_per_call > 1),
        (f"compute_dtype={c.compute_dtype!r}", c.compute_dtype != "float32"),
        ("auto_resume/continue_training", c.auto_resume
         or c.continue_training),
        ("visualize", c.visualize),
        ("test_on_eval", c.test_on_eval),
        ("profile", c.profile),
    ) if hit]
    if bad:
        raise NotImplementedError("not covered by the port's training "
                                  "slice: " + "; ".join(bad))


def _prepare_out_fold(config: TrainConfig) -> None:
    if config.test_only:
        return
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
    return (RawAudioDataset(config.access_type, config.path_to_database,
                            "train"),
            RawAudioDataset(config.access_type, config.path_to_database,
                            "dev"))


def setup_training(config: TrainConfig, steps_per_epoch: int, frontend=None,
                   device="cuda"):
    """(model, loss module, state, train step, eval step). The weights are
    drawn from a generator seeded with ``config.seed``: the model's first,
    then the OC-Softmax center."""
    check_supported(config)
    dev = resolve_device(device)
    disable_tf32()      # training computes in full f32
    gen = setup_seed(config.seed)
    model = ECAPA_TDNN(
        C=config.C, model_scale=config.model_scale,
        n_out=1 if config.base_loss == "bce" else config.nclasses,
        n_feat=config.feat_dim, enc_dim=config.enc_dim, fused_pool=True,
        generator=gen, device=dev)
    loss_mod = None
    if config.add_loss is not None:
        loss_mod = OCSoftmax(feat_dim=config.enc_dim, r_real=config.r_real,
                             r_fake=config.r_fake, alpha=config.alpha,
                             generator=gen, device=dev)
    sched = step_decay_schedule(config.lr, config.lr_decay, config.interval,
                                steps_per_epoch)
    state = create_train_state(model, loss_mod, sched, config.beta_1,
                               config.beta_2, config.eps)
    step_cfg = StepConfig(add_loss=config.add_loss,
                          base_loss=config.base_loss,
                          weight_loss=config.weight_loss)
    eval_frontend = frontend.eval_view() if frontend is not None else None
    return (model, loss_mod, state,
            make_train_step(step_cfg, frontend, dev),
            make_eval_step(step_cfg, eval_frontend, dev))


def _tensors(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(batch[k]) for k in ("wave", "length",
                                                     "label")}


def train(config: TrainConfig, train_set=None, dev_set=None, eval_set=None,
          device="cuda", return_state: bool = False):
    """Run the training loop; return the summary dict (and, with
    ``return_state``, the final :class:`TrainState` as well)."""
    check_supported(config)
    dev = resolve_device(device)
    setup_seed(config.seed)
    _prepare_out_fold(config)
    if train_set is None or dev_set is None:
        train_set, dev_set = build_datasets(config)
    if len(train_set) == 0 or len(dev_set) == 0:
        raise FileNotFoundError(
            f"no data found under '{config.path_to_database}' (train: "
            f"{len(train_set)}, dev: {len(dev_set)})")

    monitor = config.add_loss or "base_loss"
    frontend = OnDeviceFrontend(feat_len=config.feat_len,
                                padding=config.padding, device=dev)
    max_samples = frontend.min_samples()
    train_iter = PrefetchIterator(WaveformIterator(
        train_set, config.batch_size, max_samples, config.ratio,
        seed=config.seed), depth=2)
    dev_iter = PrefetchIterator(WaveformIterator(
        dev_set, config.batch_size, max_samples, config.ratio,
        seed=config.seed + 1), depth=2)
    _model, _loss, state, train_step, eval_step = setup_training(
        config, train_iter.steps_per_epoch, frontend=frontend, device=dev)

    prev_loss, early_stop = 1e8, 0
    meta_path = os.path.join(config.out_fold, "train_meta.json")
    summary: Dict[str, Any] = {"epochs": 0}
    for epoch in range(config.num_epochs):
        t0 = time.time()
        train_log = defaultdict(list)
        with open(os.path.join(config.out_fold, "train_loss.log"), "a") as f:
            for i, batch in enumerate(train_iter.epoch()):
                metrics = train_step(state, _tensors(batch), None,
                                     frontend.params)
                for k, v in metrics.items():
                    train_log[k].append(float(v))
                f.write(f"{epoch}\t{i}\t{train_log[monitor][-1]}\n")

        # ---- validation ----
        dev_log = defaultdict(list)
        scores, labels = [], []
        for batch in dev_iter.epoch():
            metrics, score, _feats = eval_step(state, _tensors(batch),
                                               frontend.params)
            for k, v in metrics.items():
                dev_log[k].append(float(v))
            scores.append(score.float().cpu().numpy())
            labels.append(batch["label"])
        scores, labels = np.concatenate(scores), np.concatenate(labels)
        eer = min(compute_eer(scores[labels == 0], scores[labels == 1])[0],
                  compute_eer(-scores[labels == 0], -scores[labels == 1])[0])
        val_loss = float(np.nanmean(dev_log[monitor]))
        with open(os.path.join(config.out_fold, "dev_loss.log"), "a") as f:
            f.write(f"{epoch}\t{val_loss}\t{eer}\n")

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
