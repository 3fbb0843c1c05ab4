"""Batched scoring: feature files or raw audio -> a model (the ECAPA
serving graph or any other family) -> reference-format score file.

Counterpart of the JAX package's ``scoring.py``: the 8-task router
(``build_task_dataset``), the feature-file scorer (``make_score_fn``,
``score_to_file``, ``test_on_asvspoof2021``), the per-loss ``score_rule``
and the cache-free ``score_raw_to_file`` (waveforms -> LFCC on the card -> a
feature model, or waveforms -> RawNet2). A score file holds ``fname -score [bonafide|spoof]`` lines, where
the score is the JAX ``score_rule``'s: -softmax(logits)[:, 0] by default,
the loss module's score (-cos) for OC-Softmax and P2SGrad,
softmax(cosine logits)[:, 0] for AMSoftmax and the distance to the center
for the Isolate losses, so an OC-Softmax file stores +cos (bona fide near
+1).

Both scorers run ECAPA through its serving graph (``ServingECAPA``:
kernels B2 and B3 on the card) and the other families through their
eval-mode modules (``model="resnet"``, ``"lcnn"``, ``"res2net"``,
``"cnn"``, ``"rawnet"``), in f32 by default, as the JAX scorer runs
``model.apply`` in f32; ``dtype=torch.bfloat16`` is the bf16 tier of
ECAPA, ResNet and LCNN (SE-Res2Net50, ConvNet and RawNet2 have no bf16
model in the JAX package, and the port adds none: they score in f32).
RawNet2 reads waveforms, so it scores through ``score_raw_to_file`` with
a ``WaveformFrontend``; the feature-file tasks refuse it.

Over several GPUs (``score_to_file(shard=)``, the JAX scorer's ``shard``):
each rank scores its rows of every batch, the scores are gathered, and
rank 0 writes the one process's file.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from asvspoof2021_air_tpu_torch._device import resolve_device
from asvspoof2021_air_tpu_torch.data.datasets import (
    ASVspoof2019FeatureDataset, AugmentedFeatureDataset, EvalFeatureDataset)
from asvspoof2021_air_tpu_torch.data.pipeline import (
    SequentialIterator, WaveformIterator)
from asvspoof2021_air_tpu_torch.interop.checkpoints import (
    convnet_from_state_dict, lcnn_from_state_dict, rawnet_from_state_dict,
    res2net_from_state_dict, resnet_from_state_dict)
from asvspoof2021_air_tpu_torch.models.registry import MODEL_REGISTRY
from asvspoof2021_air_tpu_torch.parallel.mesh import (
    Mesh, batch_sharding, gather)
from asvspoof2021_air_tpu_torch.serving.ecapa_serving import ServingECAPA
from asvspoof2021_air_tpu_torch.serving.stream import make_scanned_infer
from asvspoof2021_air_tpu_torch.utils.profiling import span

TASKS = ("LA", "DF", "19dev", "19laaugdev", "19lapaaugdev", "19dfaugdev",
         "19dfpaaugdev", "19eval")

LABEL_NAMES = {0: "bonafide", 1: "spoof"}


def build_task_dataset(task: str, paths: Dict[str, str],
                       feature: str = "LFCC"):
    """The dataset of one scoring task. ``paths`` maps the roles
    ori_features, aug_features, la_eval and df_eval to directories."""
    if task == "LA":
        return EvalFeatureDataset(paths["la_eval"], feature)
    if task == "DF":
        return EvalFeatureDataset(paths["df_eval"], feature)
    if task in ("19dev", "19eval"):
        return ASVspoof2019FeatureDataset("LA", paths["ori_features"],
                                          task[2:], feature)
    if task in ("19laaugdev", "19lapaaugdev", "19dfaugdev", "19dfpaaugdev"):
        return AugmentedFeatureDataset(
            paths["ori_features"], paths["aug_features"], "dev", feature,
            variant="LA" if "la" in task[:6] else "DF",
            with_device="pa" in task)
    raise ValueError(f"unknown task {task!r}; choices: {TASKS}")


def score_rule(add_loss: Optional[str], emb: torch.Tensor,
               logits: torch.Tensor, loss_module=None) -> torch.Tensor:
    """Per-loss score: the loss module's score output for ocsoftmax,
    ang_iso and p2sgrad; softmax over AMSoftmax's cosine logits, column 0;
    the distance to the loss module's center for isolate and iso_sq; else
    -softmax(logits)[:, 0]."""
    with span("asv.score_rule"):
        labels = torch.zeros((emb.shape[0],), dtype=torch.long,
                             device=emb.device)
        if add_loss in ("ocsoftmax", "ang_iso", "p2sgrad"):
            _loss, score = loss_module(emb, labels)
            return score
        if add_loss == "amsoftmax":
            outputs, _margin = loss_module(emb, labels)
            return torch.softmax(outputs, dim=1)[:, 0]
        if add_loss in ("isolate", "iso_sq"):
            return torch.linalg.vector_norm(emb - loss_module.center, dim=1)
        return -torch.softmax(logits, dim=1)[:, 0]


def build_scoring_model(state_dict, model: str = "ecapa", *,
                        dtype: torch.dtype = torch.float32,
                        model_scale: int = 8, feat_dim: int = 60,
                        rawnet_args: Optional[dict] = None,
                        device="cuda") -> Callable:
    """feats (B, T, F) (RawNet2: waveforms (B, L)) -> (embedding, logits)
    on ``device``: ECAPA's serving graph (kernels B2 and B3 on the card) in
    ``dtype``, the eval-mode ResNet or LCNN in ``dtype``, or the eval-mode
    SE-Res2Net50, ConvNet or RawNet2 (at ``rawnet_args``) in f32, holding
    ``state_dict``; ``feat_dim`` is the features' dim (LCNN, ConvNet)."""
    dev = resolve_device(device)
    if model == "ecapa":
        return ServingECAPA(state_dict, dtype=dtype, model_scale=model_scale,
                            device=dev)
    compute = None if dtype == torch.float32 else dtype
    if model == "resnet":
        return resnet_from_state_dict(state_dict, compute, dev)
    if model == "lcnn":
        return lcnn_from_state_dict(state_dict, feat_dim, compute, dev)
    if model == "res2net":
        return res2net_from_state_dict(state_dict, dev)
    if model == "cnn":
        return convnet_from_state_dict(state_dict, feat_dim, dev)
    if model == "rawnet":
        return rawnet_from_state_dict(state_dict, rawnet_args, dev)
    raise ValueError(f"unknown model {model!r}; choices: "
                     f"{sorted(MODEL_REGISTRY)}")


def make_score_fn(state_dict, loss_module=None,
                  add_loss: Optional[str] = None, *,
                  dtype: torch.dtype = torch.float32, model_scale: int = 8,
                  model: str = "ecapa", feat_dim: int = 60,
                  device="cuda") -> Callable:
    """Batched scorer: feats (B, T, F) (numpy or tensor) -> raw score (B,)
    f32 on ``device``, through ``model`` built once from ``state_dict``
    (:func:`build_scoring_model`) and the per-loss scoring rule. The
    function's ``device`` attribute names its device."""
    dev = resolve_device(device)
    net = build_scoring_model(state_dict, model, dtype=dtype,
                              model_scale=model_scale, feat_dim=feat_dim,
                              device=dev)
    if loss_module is not None:
        loss_module = loss_module.to(dev).eval()

    @torch.no_grad()
    def score_fn(feats) -> torch.Tensor:
        emb, logits = net(torch.as_tensor(feats).to(dev))
        return score_rule(add_loss, emb, logits, loss_module).float()

    score_fn.device = dev
    return score_fn


def _write_scored(f, batch, scores: np.ndarray, labeled: bool) -> None:
    for j in np.nonzero(batch["valid"])[0]:
        if labeled:
            key = LABEL_NAMES[int(batch["label"][j])]
            f.write(f"{batch['fname'][j]} {-scores[j]} {key}\n")
        else:
            f.write(f"{batch['fname'][j]} {-scores[j]}\n")


def score_to_file(score_fn: Callable, dataset, output_path: str,
                  labeled: bool, batch_size: int = 64, feat_len: int = 750,
                  padding: str = "repeat", scan_batches: int = 1,
                  shard: Optional[Mesh] = None) -> str:
    """Score ``dataset`` in batches of ``batch_size`` (the last one filled
    up, its extra rows not written) and write the score file.

    ``scan_batches=K`` runs K consecutive batches as one dispatch
    (``serving/stream.make_scanned_infer``: a CUDA graph on the card) with
    the same scores; a tail of fewer than K batches runs batch by batch.
    The scan runs on ``score_fn.device`` ("cuda" when it has none).

    ``shard``, a 1-D "data" mesh (``parallel/mesh.make_mesh``) of W ranks
    that all call this with the same arguments: each rank scores its
    contiguous ``batch_size / W`` rows of every batch (W must divide
    ``batch_size``), the scores are gathered over the mesh, and rank 0
    writes the file, the one process's file, then every rank returns."""
    it = SequentialIterator(dataset, batch_size, feat_len, padding)
    group = None if shard is None else shard.group()
    rows = (slice(None) if shard is None
            else batch_sharding(shard)(batch_size))
    scanned = None
    if scan_batches > 1:
        scanned = make_scanned_infer(score_fn,
                                     getattr(score_fn, "device", "cuda"))

    def scores(feats, fn, axis: int) -> np.ndarray:
        """The global batch's scores of ``fn`` on this rank's rows of
        ``feats`` (rows on ``axis``), gathered."""
        local = fn(feats[(slice(None),) * axis + (rows,)])
        if group is None:
            return local.cpu().numpy()
        got = gather(local, group)          # (W, [K,] B / W)
        return torch.cat(got.unbind(), dim=axis).cpu().numpy()

    lead = shard is None or shard.index() == 0
    if lead:
        os.makedirs(os.path.dirname(os.path.abspath(output_path)),
                    exist_ok=True)
    with (open(output_path, "w") if lead else contextlib.nullcontext()) \
            as f, torch.no_grad():
        write = (lambda b, sc: _write_scored(f, b, sc, labeled)) if lead \
            else (lambda b, sc: None)
        pending: list = []
        for batch in it:
            if scanned is None:
                write(batch, scores(batch["feat"], score_fn, 0))
                continue
            pending.append(batch)
            if len(pending) == scan_batches:
                stacked = np.stack([b["feat"] for b in pending])
                for b, sc in zip(pending, scores(stacked, scanned, 1)):
                    write(b, sc)
                pending = []
        for batch in pending:
            write(batch, scores(batch["feat"], score_fn, 0))
    if group is not None:
        dist.barrier(group)     # the file is written before any rank goes on
    return output_path


def test_on_asvspoof2021(
    task: str,
    state_dict,
    paths: Dict[str, str],
    output_score_path: str,
    model_name: str,
    add_loss: Optional[str] = None,
    loss_module=None,
    batch_size: int = 64,
    feature: str = "LFCC",
    feat_len: int = 750,
    padding: str = "repeat",
    scan_batches: int = 1,
    dtype: torch.dtype = torch.float32,
    model_scale: int = 8,
    model: str = "ecapa",
    feat_dim: int = 60,
    device="cuda",
    shard: Optional[Mesh] = None,
) -> str:
    """Score one task's feature files with ``model`` and return the score
    file's path: the '19*' tasks write
    ``<out>/<model_name>_<task>_score.txt`` (labeled), the challenge tasks
    ``<out>/<model_name>_<task>/score.txt`` (unlabeled); over the ranks of
    a ``shard`` mesh as :func:`score_to_file`. RawNet2 reads
    waveforms, not features: ValueError (score it with
    :func:`score_raw_to_file`)."""
    if model == "rawnet":
        raise ValueError("rawnet scores raw waveforms, not feature files: "
                         "use score_raw_to_file with a WaveformFrontend")
    dataset = build_task_dataset(task, paths, feature)
    if "19" in task:
        out = os.path.join(output_score_path, f"{model_name}_{task}_score.txt")
    else:
        out = os.path.join(output_score_path, f"{model_name}_{task}",
                           "score.txt")
    score_fn = make_score_fn(state_dict, loss_module, add_loss, dtype=dtype,
                             model_scale=model_scale, model=model,
                             feat_dim=feat_dim, device=device)
    return score_to_file(score_fn, dataset, out, "19" in task, batch_size,
                         feat_len, padding, scan_batches=scan_batches,
                         shard=shard)


def score_raw_to_file(
    state_dict,
    dataset,
    output_path: str,
    labeled: bool,
    frontend,
    loss_module=None,
    add_loss: Optional[str] = None,
    batch_size: int = 64,
    dtype: torch.dtype = torch.float32,
    model_scale: int = 8,
    model: str = "ecapa",
    rawnet_args: Optional[dict] = None,
    device="cuda",
) -> str:
    """Score every utterance of ``dataset`` through ``frontend`` (an
    :class:`~asvspoof2021_air_tpu_torch.train.frontend.OnDeviceFrontend`,
    or for RawNet2 a ``WaveformFrontend``) and ``model`` built from
    ``state_dict`` (:func:`build_scoring_model`: the ECAPA serving graph or
    the family's eval-mode module); write the score file and return its
    path."""
    dev = resolve_device(device)
    net = build_scoring_model(state_dict, model, dtype=dtype,
                              model_scale=model_scale,
                              rawnet_args=rawnet_args, device=dev)
    if loss_module is not None:
        loss_module = loss_module.to(dev).eval()
    n = len(dataset)
    it = WaveformIterator(dataset, batch_size, frontend.min_samples(),
                          ratio=1.0, seed=0, shuffle=False,
                          steps_per_epoch=-(-n // batch_size))
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    written = 0
    with open(output_path, "w") as f, torch.inference_mode():
        for batch in it.epoch():
            feats = frontend({"wave": torch.from_numpy(batch["wave"]),
                              "length": torch.from_numpy(batch["length"])})
            emb, logits = net(feats)
            scores = score_rule(add_loss, emb, logits, loss_module)
            scores = scores.float().cpu().numpy()
            for j in range(len(scores)):
                if written >= n:
                    break
                if labeled:
                    key = LABEL_NAMES[int(batch["label"][j])]
                    f.write(f"{batch['fname'][j]} {-scores[j]} {key}\n")
                else:
                    f.write(f"{batch['fname'][j]} {-scores[j]}\n")
                written += 1
    return output_path
