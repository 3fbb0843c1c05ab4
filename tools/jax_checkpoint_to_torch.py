#!/usr/bin/env python3
"""Convert a JAX training run's checkpoint into a run folder of the
PyTorch/CUDA port.

    python3 tools/jax_checkpoint_to_torch.py --model_dir <jax run> \\
        --out <port run> [--checkpoint best|N]

Runs only where JAX (and Orbax, if the run was saved with it) is
installed: it imports the JAX package, which the port never does. It
reads the run's ``args.json``, rebuilds the train state as the JAX
``cli/generate_score.load_system`` does (``setup_training``, then
``restore_checkpoint`` of ``<model_dir>/best`` or ``checkpoint/<N>``),
maps it with the port's ``interop/flax_weights.from_flax_train_state``
(any model family; the loss module's parameters; an ADV_AUG run's
channel classifiers and their Adam states included; an ``--ensemble``
run's members split off the stacked member axis by the JAX
``member_state``, into the port's ensemble checkpoint) and
writes ``<out>/best.pt`` (the port's checkpoint dict) and ``<out>/args.json``
with the keys of the port's ``TrainConfig`` (``lambda_`` and ``lr_d``
among them; the others dropped, as the port's training CLI drops them;
ECAPA's ``C`` read from the weights). The port's
``cli.generate_score`` then scores that folder.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

MODEL_SCALE = 8     # the JAX package's ECAPA is always built at scale 8


def convert(model_dir: str, out_dir: str, checkpoint: str = "best") -> str:
    """Write the port's run folder for the JAX run at ``model_dir``; return
    the path of its ``best.pt``."""
    import torch

    from asvspoof2021_air_tpu.train.checkpoint import restore_checkpoint
    from asvspoof2021_air_tpu.train.ensemble import member_state
    from asvspoof2021_air_tpu.train.loop import TrainConfig as JaxConfig
    from asvspoof2021_air_tpu.train.loop import setup_training
    from asvspoof2021_air_tpu_torch.interop.flax_weights import (
        from_flax_train_state)
    from asvspoof2021_air_tpu_torch.train.loop import TrainConfig

    with open(os.path.join(model_dir, "args.json")) as f:
        cfg_dict = json.load(f)
    jax_fields = set(JaxConfig.__dataclass_fields__)
    jcfg = JaxConfig(**{k: v for k, v in cfg_dict.items() if k in jax_fields})
    _model, _loss, state, _ts, _es = setup_training(jcfg, steps_per_epoch=1)
    state = restore_checkpoint(os.path.join(model_dir, checkpoint), state)
    convert_state = lambda st: from_flax_train_state(
        st, MODEL_SCALE, jcfg.model, jcfg.feat_dim)
    if jcfg.ensemble > 1:
        # the member axis JAX stacks, split member by member
        members = [convert_state(member_state(state, i))
                   for i in range(jcfg.ensemble)]
        ckpt = {"step": members[0]["step"], "members": members}
        first = members[0]
    else:
        ckpt = first = convert_state(state)

    port_fields = set(TrainConfig.__dataclass_fields__)
    port_cfg = {k: v for k, v in cfg_dict.items() if k in port_fields}
    if port_cfg.get("add_loss") == "ocsoftmax":
        port_cfg["add_loss"] = "ang_iso"
    port_cfg["out_fold"] = out_dir
    if jcfg.model == "ecapa":
        port_cfg.update(model_scale=MODEL_SCALE,
                        C=int(first["model"]["conv1.weight"].shape[0]))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "args.json"), "w") as f:
        json.dump(dataclasses.asdict(TrainConfig(**port_cfg)), f, indent=2,
                  sort_keys=True)
    path = os.path.join(out_dir, "best.pt")
    torch.save(ckpt, path)
    return path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model_dir", required=True,
                   help="the JAX run folder (args.json, best/, checkpoint/)")
    p.add_argument("--out", required=True, help="the port's run folder")
    p.add_argument("--checkpoint", default="best",
                   help="'best' or an epoch N (checkpoint/N)")
    args = p.parse_args(argv)
    ckpt = args.checkpoint
    if ckpt != "best" and not os.path.isabs(ckpt):
        ckpt = os.path.join("checkpoint", ckpt)
    print(f"wrote {convert(args.model_dir, args.out, ckpt)}")


if __name__ == "__main__":
    main()
