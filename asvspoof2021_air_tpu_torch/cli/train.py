"""Training CLI of the PyTorch/CUDA port: ECAPA-TDNN trained on the fly
from raw waveforms.

    python -m asvspoof2021_air_tpu_torch.cli.train -d <database> -o <out> \\
        -m ecapa --add_loss ang_iso --on_the_fly [--device cuda]

The argparse front of the JAX package's ``cli/train.py`` for the flags the
port trains with; ``--C`` and ``--model_scale`` narrow the model. Flags of
the JAX CLI that the port does not cover are absent here, and
``train/loop.check_supported`` refuses them in a ``--config`` file.
"""

from __future__ import annotations

import argparse
import json

from asvspoof2021_air_tpu_torch.train.loop import TrainConfig, train
from asvspoof2021_air_tpu_torch.utils.seed import str2bool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seed", type=int, default=688)
    p.add_argument("-a", "--access_type", type=str, default="LA",
                   choices=["LA", "PA"])
    p.add_argument("-d", "--path_to_database", type=str, default="")
    p.add_argument("-o", "--out_fold", type=str, required=True)
    p.add_argument("--ratio", type=float, default=0.5,
                   help="original:augmented mix in a training batch")
    p.add_argument("--feat_len", type=int, default=750)
    p.add_argument("--feat_dim", type=int, default=60)
    p.add_argument("--padding", type=str, default="repeat",
                   choices=["zero", "repeat", "silence"])
    p.add_argument("--enc_dim", type=int, default=256)
    p.add_argument("-m", "--model", default="ecapa", choices=["ecapa"])
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
                   choices=[None, "ang_iso"])
    p.add_argument("--weight_loss", type=float, default=1.0)
    p.add_argument("--r_real", type=float, default=0.9)
    p.add_argument("--r_fake", type=float, default=0.2)
    p.add_argument("--alpha", type=float, default=20.0)
    p.add_argument("--early_stop_patience", type=int, default=500)
    p.add_argument("--on_the_fly", type=str2bool, nargs="?", const=True,
                   default=False,
                   help="train straight from raw audio (the port's only "
                        "mode: LFCC on the card inside the step)")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    p.add_argument("--config", type=str, default=None,
                   help="JSON file of TrainConfig fields; CLI flags that are "
                        "explicitly set override it")
    return p


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    if not 0 < args.ratio <= 1:
        raise SystemExit(f"--ratio must be in (0, 1], got {args.ratio}")
    off = [k for k in ("fused_pool", "fused_bn")
           if getattr(args, k, "auto") == "off"]
    if off:
        raise NotImplementedError(
            f"{'/'.join(off)}='off': the port always trains through B4a/B4b "
            "and the recompute VJP")
    fields = set(TrainConfig.__dataclass_fields__)
    kwargs = {k: v for k, v in vars(args).items() if k in fields}
    if kwargs.get("add_loss") == "ocsoftmax":   # a --config file's alias
        kwargs["add_loss"] = "ang_iso"
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
    summary = train(config_from_args(args), device=args.device)
    print(summary)


if __name__ == "__main__":
    main()
