"""Training CLI of the PyTorch/CUDA port: LCNN (the default, as in the JAX
CLI) or any other family of the JAX CLI's ``-m`` choices, from cached
feature files or, ``--on_the_fly``, from raw waveforms (RawNet2 from raw
waveforms only).

    python -m asvspoof2021_air_tpu_torch.cli.train -f <features> -o <out> \\
        [-m lcnn|resnet|ecapa|res2net|cnn] \\
        [--add_loss isolate|iso_sq|ang_iso|p2sgrad] \\
        [--LA_aug --path_to_aug_features <aug>] \\
        [--compute_dtype bfloat16] [--steps_per_call 8] [--device cuda] \
        [--fused_pool auto|on|off] [--fused_bn auto|on|off]
    python -m asvspoof2021_air_tpu_torch.cli.train -d <database> -o <out> \\
        -m ecapa --add_loss ang_iso --on_the_fly \
        [--on_device_aug [--apply_ir] [--dev_aug]]
    python -m asvspoof2021_air_tpu_torch.cli.train -f <features> -o <out> \
        -m ecapa --add_loss ang_iso --LA_aug --path_to_aug_features <aug> \
        --ADV_AUG [--lambda_ 0.05] [--lr_d 1e-4]
    python -m asvspoof2021_air_tpu_torch.cli.train -d <database> -o <out> \
        -m rawnet --on_the_fly [--on_device_aug] [--config <json>]

    python -m asvspoof2021_air_tpu_torch.cli.train -f <features> -o <out> \
        -m ecapa --add_loss ang_iso --ensemble 3 [--compute_dtype bfloat16] \
        [--steps_per_call 8]

    torchrun --nproc_per_node=N -m asvspoof2021_air_tpu_torch.cli.train \
        ... [--device cpu]

Under ``torchrun`` each process joins the process group
(``parallel/distributed.initialize_distributed``: NCCL on the card, one
GPU a process, gloo with ``--device cpu``) and ``train`` runs over the
ranks (``train/loop.py``): a single system data-parallel (the batch size
must split over the N processes), ``--ensemble M`` with its members spread
over them; rank 0 writes the run folder and prints the summary.

The argparse front of the JAX package's ``cli/train.py``, every flag of
it; ``--C`` and ``--model_scale`` narrow ECAPA and ``--device`` picks the
card or the CPU. ``-m`` takes the JAX CLI's choices, all six. RawNet2's
``rawnet_args`` come from a ``--config`` file, as in the JAX CLI.
``--ensemble M`` trains M systems in one step (``train/ensemble.py``).
``--num_centers`` is taken and unused, as in the JAX CLI; ``--test_only``
prints and returns, as there; ``--fused_pool``/``--fused_bn`` take
auto|on|off as in the JAX CLI: auto and on train through B4a/B4b and the
recompute VJPs (the port's "auto" is "on" on the card and on the CPU,
where JAX's is "on" only on a TPU), off trains the unfused model through
plain autograd (``train/loop.TrainConfig``); ``--visualize`` writes the
embeddings' t-SNE/PCA figure every third epoch (``visualize.py``). As in
the JAX CLI, ``--add_loss ocsoftmax`` from a ``--config`` file is
``ang_iso`` and an add-loss that does not train (amsoftmax) is refused,
and ``--test_on_eval`` scores only an ``eval_set`` handed to ``train()``;
the CLI hands none.
"""

from __future__ import annotations

import argparse
import json

from asvspoof2021_air_tpu_torch.parallel.distributed import (
    initialize_distributed)
from asvspoof2021_air_tpu_torch.parallel.mesh import world
from asvspoof2021_air_tpu_torch.train.loop import TrainConfig, train
from asvspoof2021_air_tpu_torch.train.steps import TRAINED_LOSSES
from asvspoof2021_air_tpu_torch.utils.seed import str2bool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seed", type=int, default=688)
    p.add_argument("-a", "--access_type", type=str, default="LA",
                   choices=["LA", "PA"])
    p.add_argument("-d", "--path_to_database", type=str, default="")
    p.add_argument("-f", "--path_to_features", type=str, default="")
    p.add_argument("--path_to_aug_features", type=str, default="")
    p.add_argument("-o", "--out_fold", type=str, required=True)
    p.add_argument("--ratio", type=float, default=0.5,
                   help="original:augmented mix in a training batch")
    p.add_argument("--feat", type=str, default="LFCC",
                   choices=["CQCC", "LFCC", "Melspec", "STFT"],
                   help="the feature cache's subdirectory (the on-the-fly "
                        "front-end is LFCC)")
    p.add_argument("--feat_len", type=int, default=750)
    p.add_argument("--feat_dim", type=int, default=60)
    p.add_argument("--pad_chop", type=str2bool, nargs="?", const=True,
                   default=True)
    p.add_argument("--padding", type=str, default="repeat",
                   choices=["zero", "repeat", "silence"])
    p.add_argument("--enc_dim", type=int, default=256)
    p.add_argument("-m", "--model", default="lcnn",
                   choices=["cnn", "resnet", "lcnn", "res2net", "ecapa",
                            "rawnet"])
    p.add_argument("--C", type=int, default=512)
    p.add_argument("--model_scale", type=int, default=8)
    p.add_argument("--num_epochs", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.0005)
    p.add_argument("--lr_decay", type=float, default=0.5)
    p.add_argument("--interval", type=int, default=30)
    p.add_argument("--beta_1", type=float, default=0.9)
    p.add_argument("--beta_2", type=float, default=0.999)
    p.add_argument("--eps", type=float, default=1e-8)
    p.add_argument("--base_loss", type=str, default="ce", choices=["ce", "bce"])
    p.add_argument("--add_loss", type=str, default=None,
                   choices=list(TRAINED_LOSSES))
    p.add_argument("--weight_loss", type=float, default=1.0)
    p.add_argument("--r_real", type=float, default=0.9)
    p.add_argument("--r_fake", type=float, default=0.2)
    p.add_argument("--alpha", type=float, default=20.0)
    p.add_argument("--num_centers", type=int, default=3,
                   help="taken and unused, as in the JAX CLI")
    p.add_argument("--visualize", action="store_true",
                   help="t-SNE/PCA figure of the dev (and eval) "
                        "embeddings every third epoch")
    p.add_argument("--test_only", action="store_true",
                   help="print and return (score with cli.generate_score)")
    p.add_argument("--early_stop_patience", type=int, default=500)
    p.add_argument("--continue_training", action="store_true")
    for flag in ("ADV_AUG", "LA_aug", "DF_aug", "LAPA_aug", "DFPA_aug"):
        p.add_argument(f"--{flag}", type=str2bool, nargs="?", const=True,
                       default=False)
    p.add_argument("--lambda_", type=float, default=0.05,
                   help="the gradient-reversal scale of the ADV_AUG channel "
                        "classifiers")
    p.add_argument("--lr_d", type=float, default=0.0001,
                   help="the ADV_AUG channel classifiers' learning rate")
    p.add_argument("--test_on_eval", action="store_true")
    p.add_argument("--ensemble", type=int, default=1,
                   help="train M independently initialized systems in one "
                        "step; dev and eval scores are averaged over them")
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="optimizer steps per call (on the card, one CUDA "
                        "graph of K steps)")
    p.add_argument("--profile", action="store_true",
                   help="trace the first ~20 steps into <out>/profile")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="model compute dtype (params always float32)")
    for flag in ("fused_pool", "fused_bn"):
        p.add_argument(f"--{flag}", type=str, default="auto",
                       choices=["auto", "on", "off"],
                       help="auto and on: train through B4a/B4b and the "
                            "recompute VJPs; off: the unfused model through "
                            "plain autograd")
    p.add_argument("--on_the_fly", type=str2bool, nargs="?", const=True,
                   default=False,
                   help="train straight from raw audio (-d): LFCC on the "
                        "card inside the step")
    p.add_argument("--on_device_aug", type=str2bool, nargs="?", const=True,
                   default=False,
                   help="a random channel per utterance each step, on the "
                        "card before LFCC (on_the_fly); dev monitoring "
                        "stays clean unless --dev_aug")
    p.add_argument("--apply_ir", type=str2bool, nargs="?", const=True,
                   default=False,
                   help="also convolve a random impulse response "
                        "(on_the_fly)")
    p.add_argument("--dev_aug", type=str2bool, nargs="?", const=True,
                   default=False,
                   help="monitor the dev loss on a fixed-draw augmented dev "
                        "view (on_the_fly + on_device_aug); scoring and "
                        "test_on_eval stay clean")
    p.add_argument("--auto_resume", type=str2bool, nargs="?", const=True,
                   default=False,
                   help="resume from the latest epoch checkpoint in out_fold")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    p.add_argument("--config", type=str, default=None,
                   help="JSON file of TrainConfig fields; CLI flags that are "
                        "explicitly set override it")
    return p


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    if not 0 < args.ratio <= 1:
        raise SystemExit(f"--ratio must be in (0, 1], got {args.ratio}")
    fields = set(TrainConfig.__dataclass_fields__)
    kwargs = {k: v for k, v in vars(args).items() if k in fields}
    add_loss = kwargs.get("add_loss")
    if add_loss == "ocsoftmax":   # a --config file's alias
        kwargs["add_loss"] = "ang_iso"
    elif add_loss not in TRAINED_LOSSES:
        raise SystemExit(
            f"--add_loss '{add_loss}' is not trainable; choose from "
            "isolate|iso_sq|ang_iso|p2sgrad (ocsoftmax is an alias of "
            "ang_iso)")
    return TrainConfig(**kwargs)


def parse_args(argv=None) -> argparse.Namespace:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.config:
        with open(args.config) as f:
            parser.set_defaults(**json.load(f))
        # file values act as defaults, explicit CLI flags override
        args = parser.parse_args(argv)
    return args


def main(argv=None):
    args = parse_args(argv)
    config = config_from_args(args)
    if args.test_only:
        print("test_only: use cli.generate_score for scoring")
        return
    initialize_distributed(device=args.device)
    summary = train(config, device=args.device)
    if world()[0] == 0:
        print(summary)


if __name__ == "__main__":
    main()
