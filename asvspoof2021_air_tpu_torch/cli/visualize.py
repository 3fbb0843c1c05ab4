"""Standalone embedding-visualization CLI: the port's counterpart of the
JAX package's ``cli.visualize`` (the reference's visualize.py as a
runnable command).

Loads a trained run folder (``args.json`` + checkpoint), extracts the dev
(and optionally eval) embeddings from cached features with the port's
eval-mode model on ``--device`` (default the card: ECAPA through its
serving graph, kernels B2 and B3), and writes the reference's 2x2
t-SNE/PCA PDF with the loss center(s) marked; t-SNE, PCA and the figure
run on the host.

    python -m asvspoof2021_air_tpu_torch.cli.visualize --model_folder <runs> \\
        -n <run> -f <features> [--eval_part eval] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from asvspoof2021_air_tpu_torch._device import resolve_device
from asvspoof2021_air_tpu_torch.cli.generate_score import load_system
from asvspoof2021_air_tpu_torch.data.datasets import (
    ASVspoof2019FeatureDataset)
from asvspoof2021_air_tpu_torch.data.pipeline import SequentialIterator
from asvspoof2021_air_tpu_torch.scoring import build_scoring_model
from asvspoof2021_air_tpu_torch.visualize import visualize_dev_and_eval


def extract(net, dataset, batch_size: int, feat_len: int, padding: str,
            device, limit: int = 5000):
    """(embeddings (N, E), labels (N,)) of up to ``limit`` trials of
    ``dataset``, in order, through ``net`` (feats -> (emb, logits))."""
    feats_out, labels_out = [], []
    n = 0
    with torch.no_grad():
        for batch in SequentialIterator(dataset, batch_size, feat_len,
                                        padding):
            valid = batch["valid"]
            emb, _ = net(torch.from_numpy(batch["feat"]).to(device))
            feats_out.append(emb.float().cpu().numpy()[valid])
            labels_out.append(np.asarray(batch["label"])[valid])
            n += int(valid.sum())
            if n >= limit:
                break
    return (np.concatenate(feats_out)[:limit],
            np.concatenate(labels_out)[:limit])


def main(argv=None) -> str:
    p = argparse.ArgumentParser("embedding visualization (t-SNE + PCA)")
    p.add_argument("--model_folder", type=str, default="./models")
    p.add_argument("-n", "--model_name", type=str, required=True)
    p.add_argument("-f", "--ori_features", type=str, required=True)
    p.add_argument("-a", "--access_type", type=str, default="LA")
    p.add_argument("--eval_part", type=str, default="",
                   help="also embed this part (e.g. 'eval') for the eval "
                        "panels; defaults to re-using dev")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--sample", type=int, default=5000)
    p.add_argument("--checkpoint", type=str, default="best")
    p.add_argument("-o", "--out_fold", type=str, default="")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model embeds (cuda or cpu)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    model_dir = os.path.join(args.model_folder, args.model_name)
    ckpt = args.checkpoint
    if ckpt != "best" and not os.path.isabs(ckpt):
        ckpt = os.path.join("checkpoint", ckpt)
    sd, loss_mod, cfg = load_system(model_dir, ckpt, dev)
    if cfg.ensemble > 1:        # member 0, as the training loop plots
        sd, loss_mod = sd[0], loss_mod[0]
    net = build_scoring_model(sd, cfg.model, model_scale=cfg.model_scale,
                              feat_dim=cfg.feat_dim,
                              rawnet_args=cfg.rawnet_args, device=dev)

    def embed(part: str):
        ds = ASVspoof2019FeatureDataset(args.access_type, args.ori_features,
                                        part, cfg.feat)
        return extract(net, ds, args.batch_size, cfg.feat_len, cfg.padding,
                       dev, args.sample)

    dev_feat, dev_labels = embed("dev")
    eval_feat, eval_labels = (embed(args.eval_part) if args.eval_part
                              else (dev_feat, dev_labels))
    if (cfg.add_loss in ("isolate", "iso_sq", "ang_iso")
            and loss_mod is not None):
        center = loss_mod.center.detach().float().cpu().numpy()
    else:
        center = dev_feat[dev_labels == 0].mean(0, keepdims=True)
    path = visualize_dev_and_eval(
        dev_feat, dev_labels, eval_feat, eval_labels, center,
        seed=cfg.seed, out_fold=args.out_fold or model_dir)
    print(f"wrote {path}")
    return path


def script() -> None:
    """The ``asvspoof-torch-visualize`` console script: :func:`main`
    without its return value (the figure's path), which ``sys.exit`` would
    take for a failure code."""
    main()


if __name__ == "__main__":
    main()
