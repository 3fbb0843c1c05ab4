"""Scoring CLI of the PyTorch/CUDA port: a trained run's checkpoint (any
model family but RawNet2, with any add-loss) -> score file for one of the
8 tasks.

    python -m asvspoof2021_air_tpu_torch.cli.generate_score \\
        --model_folder <runs> -n <run> -t {LA,DF,19dev,...} \\
        [--ori_features F] [--aug_features A] [--la_eval E] [--df_eval E] \\
        [--dtype float32|bfloat16] [--device cuda|cpu]

The port's counterpart of the JAX package's ``cli/generate_score.py``,
with its flags. The system is rebuilt from the run folder the port's
training loop writes (or ``tools/jax_checkpoint_to_torch.py`` converts):
``args.json`` and ``best.pt``, or ``checkpoint/<N>.pt`` for
``--checkpoint N``. It scores ECAPA through its serving graph (kernels B2
and B3 on the card) and the other families through their eval-mode
modules, in f32 unless ``--dtype bfloat16`` (ECAPA, ResNet and LCNN; the
other families have no bf16 model in the JAX package and score in f32), by
the run's add-loss's rule or ``-l``'s (every rule of the JAX CLI). The
'19*' tasks write under ``./scores``, as the JAX CLI does; the challenge
tasks under ``--score_dir``. ``load_system`` loads a RawNet2 run too (its
``rawnet_args`` in ``args.json``); RawNet2 reads waveforms, so the
feature-file tasks refuse it (ValueError) and
``scoring.score_raw_to_file`` scores it.

An ensemble run (``ensemble`` M > 1, ``train/ensemble.py``) scores each
member to ``<name>_member{i}`` and writes their fusion under ``<name>``
in the single-system layout (:func:`write_fused_score_file`): the average
(``--fusion avg``, the default) or, on a labeled '19*' task, the members'
EER-derived entropy weights (``--fusion wght``).

Under ``torchrun --nproc_per_node=N`` (NCCL on the card, gloo with
``--device cpu``) every process scores its rows of each batch
(``scoring.score_to_file(shard=)``: N must divide ``--batch_size``) and
rank 0 writes the files, the one process's.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from asvspoof2021_air_tpu_torch._device import resolve_device
from asvspoof2021_air_tpu_torch.fusion import entropy_weights
from asvspoof2021_air_tpu_torch.losses.registry import build_loss
from asvspoof2021_air_tpu_torch.metrics.evaluate import (
    eer_from_score_file, read_score_file)
from asvspoof2021_air_tpu_torch.parallel.distributed import (
    initialize_distributed)
from asvspoof2021_air_tpu_torch.parallel.mesh import make_mesh, world
from asvspoof2021_air_tpu_torch.scoring import TASKS, test_on_asvspoof2021
from asvspoof2021_air_tpu_torch.train.checkpoint import restore_checkpoint
from asvspoof2021_air_tpu_torch.train.loop import TrainConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def load_system(model_dir: str, checkpoint: str = "best", device="cuda"):
    """(state_dict, loss module or None, TrainConfig) of a run folder:
    ``args.json`` (keys the port's ``TrainConfig`` lacks are dropped) and
    the checkpoint ``<model_dir>/<checkpoint>.pt``. For an ensemble run the
    state_dicts and loss modules are lists, one entry per member, as the
    JAX ``load_system`` returns them."""
    dev = resolve_device(device)
    with open(os.path.join(model_dir, "args.json")) as f:
        cfg_dict = json.load(f)
    fields = set(TrainConfig.__dataclass_fields__)
    config = TrainConfig(**{k: v for k, v in cfg_dict.items() if k in fields})
    path = os.path.join(model_dir, checkpoint)
    if not path.endswith(".pt"):
        path += ".pt"
    data = restore_checkpoint(path)
    members = data.get("members")
    if config.ensemble > 1 and (members is None
                                or len(members) != config.ensemble):
        raise ValueError(
            f"ensemble={config.ensemble}, but {path} holds "
            f"{'no' if members is None else len(members)} ensemble members")
    sds, loss_mods = [], []
    for m in members if config.ensemble > 1 else [data]:
        loss_mod = None
        if m.get("loss_module") is not None:
            loss_mod = build_loss(config.add_loss, enc_dim=config.enc_dim,
                                  r_real=config.r_real, r_fake=config.r_fake,
                                  alpha=config.alpha,
                                  nclasses=config.nclasses, device=dev)
            loss_mod.load_state_dict(m["loss_module"])
        sds.append(m["model"])
        loss_mods.append(loss_mod)
    if config.ensemble > 1:
        return sds, loss_mods, config
    return sds[0], loss_mods[0], config


def write_fused_score_file(member_files, output: str, weights=None) -> str:
    """Fuse member score files (the same trials in the same order) into one
    file of the members' layout: ``fname score`` for challenge tasks,
    ``fname score key`` for labeled '19*' tasks. ``weights`` (default:
    equal, the average) weight each member's scores."""
    frames = [read_score_file(p) for p in member_files]
    base = frames[0]
    for fr in frames[1:]:
        if not np.array_equal(fr["fname"], base["fname"]):
            raise ValueError(
                "member score files disagree on trial order; cannot fuse")
    if weights is None:
        weights = [1.0 / len(frames)] * len(frames)
    fused = np.sum([w * fr["score"] for w, fr in zip(weights, frames)],
                   axis=0)
    os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)
    with open(output, "w") as f:
        for i, fname in enumerate(base["fname"]):
            if base["key"] is not None:
                f.write(f"{fname} {fused[i]} {base['key'][i]}\n")
            else:
                f.write(f"{fname} {fused[i]}\n")
    return output


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("generate model scores")
    p.add_argument("--model_folder", type=str, default="./models")
    p.add_argument("-n", "--model_name", type=str, required=True)
    p.add_argument("-s", "--score_dir", type=str, default="./scores")
    p.add_argument("-t", "--task", type=str, required=True, choices=TASKS)
    p.add_argument("-l", "--loss", default=None,
                   choices=[None, "softmax", "ocsoftmax", "ang_iso",
                            "isolate", "iso_sq", "amsoftmax", "p2sgrad"],
                   help="scoring rule override; defaults to the run's "
                        "trained add_loss from args.json ('softmax' forces "
                        "the plain -softmax(logits) rule)")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--scan_batches", type=int, default=1,
                   help="run K batches as one CUDA graph replay (the same "
                        "scores)")
    p.add_argument("--checkpoint", type=str, default="best",
                   help="'best' or an epoch N (<model>/checkpoint/N.pt)")
    p.add_argument("--fusion", type=str, default="avg",
                   choices=["avg", "wght"],
                   help="ensemble member fusion: average, or EER-derived "
                        "entropy weights (labeled 19* tasks only)")
    p.add_argument("--ori_features", type=str, default="")
    p.add_argument("--aug_features", type=str, default="")
    p.add_argument("--la_eval", type=str, default="")
    p.add_argument("--df_eval", type=str, default="")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=sorted(DTYPES),
                   help="compute type of the serving graph")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    return p


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    initialize_distributed(device=args.device)
    rank, size = world()
    shard = make_mesh(args.device) if size > 1 else None
    say = print if rank == 0 else (lambda *a, **k: None)
    out_dir = "./scores" if "19" in args.task else args.score_dir
    model_dir = os.path.join(args.model_folder, args.model_name)
    ckpt = args.checkpoint
    if ckpt != "best" and not os.path.isabs(ckpt):
        ckpt = os.path.join("checkpoint", ckpt)
    sd, loss_mod, cfg = load_system(model_dir, ckpt, args.device)

    trained = cfg.add_loss if cfg.add_loss not in (None, "None") else None
    if args.loss is None:
        score_loss = trained
    elif args.loss == "softmax":
        score_loss = None
    else:
        score_loss = args.loss
        aliases = {"ocsoftmax": "ang_iso", "ang_iso": "ocsoftmax"}
        if trained is not None and score_loss not in (
                trained, aliases.get(trained)):
            say(f"warning: scoring rule -l {score_loss} differs from the "
                  f"run's trained add_loss {trained}", flush=True)
    paths = {"ori_features": args.ori_features,
             "aug_features": args.aug_features,
             "la_eval": args.la_eval, "df_eval": args.df_eval}
    score = lambda sd, loss_mod, name: test_on_asvspoof2021(
        args.task, sd, paths, out_dir, name, add_loss=score_loss,
        loss_module=loss_mod, batch_size=args.batch_size, feature=cfg.feat,
        feat_len=cfg.feat_len, padding=cfg.padding,
        scan_batches=args.scan_batches, dtype=DTYPES[args.dtype],
        model_scale=cfg.model_scale, model=cfg.model, feat_dim=cfg.feat_dim,
        device=args.device, shard=shard)
    if cfg.ensemble == 1:
        out = score(sd, loss_mod, args.model_name)
        say(f"wrote {out}")
        return out
    # each member, then their fusion (the reference's score_fusion
    # workflow in one command)
    member_files = []
    for i, (msd, mloss) in enumerate(zip(sd, loss_mod)):
        member_files.append(score(msd, mloss, f"{args.model_name}_member{i}"))
        say(f"wrote {member_files[-1]}")
    if "19" in args.task:
        out = os.path.join(out_dir, f"{args.model_name}_{args.task}_score.txt")
    else:
        out = os.path.join(out_dir, f"{args.model_name}_{args.task}",
                           "score.txt")
    if rank == 0:       # the member files are written (score_to_file)
        weights = None
        if args.fusion == "wght":
            eers = [eer_from_score_file(f) for f in member_files]
            weights = entropy_weights(eers)
            say(f"member EERs {['%.4f' % e for e in eers]} -> weights "
                f"{['%.3f' % w for w in weights]}")
        write_fused_score_file(member_files, out, weights)
        say(f"wrote {out} ({args.fusion} fusion of {len(member_files)} "
            f"members)")
    if shard is not None:
        dist.barrier()
    return out


def script() -> None:
    """The ``asvspoof-torch-score`` console script: :func:`main` without
    its return value (the score file's path), which ``sys.exit`` would take
    for a failure code."""
    main()


if __name__ == "__main__":
    main()
