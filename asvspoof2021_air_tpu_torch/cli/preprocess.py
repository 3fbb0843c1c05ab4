"""Feature materialization CLI of the PyTorch/CUDA port.

    python -m asvspoof2021_air_tpu_torch.cli.preprocess -d <database> \\
        -o <features> [--part train|dev|eval] \\
        [--feature LFCC|CQCC|STFT|Melspec] [--batch_size 32] \\
        [--dataset 2019|aug|2015|vcc2020|2021eval] [--device cuda|cpu]

The port's counterpart of the JAX package's ``cli/preprocess.py``, with
its flags and checks: utterances are sorted by length, padded to a
multiple of 16000 samples in batches of ``batch_size``, run through the
extractor on ``device`` and each written, trimmed to its ``1 + len // hop``
frames, as a (1, T, D) float32 ``.npy`` file named
``%06d_<fname>_<tag>_<label>[_<channel>[_<device>]].npy`` under
``<out>/<part>/<feature>/``, the names the feature datasets read.

On the card ``--feature LFCC`` runs ``ops/lfcc_cuda.CudaLFCC`` (kernel B1
with the lengths' masks and deltas), which computes the function of the JAX
CLI's LFCC; on the CPU the plain ``LFCC``. CQCC, STFT and Melspec are
plain PyTorch (``ops/cqcc.py``, ``ops/lfcc.py``). Corpus routes:
``--dataset 2019`` (default; ASVspoof 2019 train/dev/eval), ``aug`` (an
augmented wav tree, writing the ``_channel[_device]`` suffixes that
``--LA_aug``/``--LAPA_aug``/... training reads), ``2015``, ``vcc2020`` and
``2021eval``.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, List, Tuple

import numpy as np
import torch

from asvspoof2021_air_tpu_torch._device import resolve_device
from asvspoof2021_air_tpu_torch.data.datasets import (
    ASVspoof2015RawDataset, ASVspoof2021EvalRawDataset,
    AugmentedRawAudioDataset, RawAudioDataset, VCC2020RawDataset)
from asvspoof2021_air_tpu_torch.ops.cqcc import CQCC
from asvspoof2021_air_tpu_torch.ops.lfcc import LFCC, STFT, Melspec
from asvspoof2021_air_tpu_torch.ops.lfcc_cuda import CudaLFCC

FEATURES = ("LFCC", "CQCC", "STFT", "Melspec")


def build_extractor(feature: str, device="cuda"
                    ) -> Tuple[Callable, int]:
    """(extractor fn(wave, lengths) -> (B, T, D) on ``device``, hop). Every
    front-end emits ``1 + L // hop`` frames for an L-sample utterance, so
    the valid frames follow from the extractor's hop."""
    dev = resolve_device(device)
    if feature == "LFCC":
        lfcc = (CudaLFCC if dev.type == "cuda" else LFCC)(device=dev)
        return lfcc, lfcc.config.hop_length
    if feature == "CQCC":
        cqcc = CQCC(device=dev)
        return cqcc, cqcc.hop_length
    if feature == "STFT":
        stft = STFT(device=dev)
        return (lambda w, lengths: stft(w)), stft.hop_length
    if feature == "Melspec":
        mel = Melspec(device=dev)
        return (lambda w, lengths: mel(w).transpose(1, 2)), mel.hop_length
    raise ValueError(f"unknown feature '{feature}'")


def bucket_extract(extractor, hop: int, items: List[tuple], out_dir: str,
                   start_idx: int = 0, batch_size: int = 32,
                   bucket_quant: int = 16000, device="cuda") -> int:
    """Extract ``items`` (waveform, name suffix) in batches of utterances
    sorted by length, each batch zero-padded to a multiple of
    ``bucket_quant`` samples; write ``{start_idx + i:06d}_{suffix}.npy``
    trimmed to the utterance's valid frames. Returns the files written."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    order = sorted(range(len(items)), key=lambda i: len(items[i][0]))
    n_written = 0
    for s in range(0, len(order), batch_size):
        idx = order[s:s + batch_size]
        waves = [items[i][0] for i in idx]
        lens = np.array([len(w) for w in waves], np.int64)
        L = int(-(-lens.max() // bucket_quant) * bucket_quant)
        batch = np.zeros((len(waves), L), np.float32)
        for r, w in enumerate(waves):
            batch[r, :len(w)] = w
        with torch.no_grad():
            feats = extractor(torch.from_numpy(batch).to(dev),
                              torch.from_numpy(lens).to(dev))
        feats = feats.float().cpu().numpy()      # one copy per batch
        for r, i in enumerate(idx):
            out = feats[r:r + 1, :1 + lens[r] // hop, :]
            np.save(os.path.join(out_dir, f"{start_idx + i:06d}_"
                                          f"{items[i][1]}.npy"), out)
            n_written += 1
    return n_written


def collect_items(args) -> List[tuple]:
    """(waveform, file-name suffix) pairs of the selected corpus."""
    items = []
    if args.dataset == "2019":
        ds = RawAudioDataset(args.access_type, args.path_to_database,
                             args.part)
        tag_inv = {v: k for k, v in ds.tag.items()}
        label_inv = {v: k for k, v in ds.label.items()}
        for i in range(len(ds)):
            wav, fname, tag, label = ds[i]
            items.append((wav, f"{fname}_{tag_inv[tag]}_{label_inv[label]}"))
    elif args.dataset == "aug":
        protocol_dir = args.path_to_protocol or os.path.join(
            args.path_to_database, args.access_type,
            f"ASVspoof2019_{args.access_type}_cm_protocols")
        ds = AugmentedRawAudioDataset(args.aug_wav_dir, protocol_dir,
                                      args.part,
                                      with_device=args.with_device)
        tag_inv = {v: k for k, v in ds.tag.items()}
        label_inv = {v: k for k, v in ds.label.items()}
        for i in range(len(ds)):
            item = ds[i]
            wav, fname, tag, label = item[:4]
            suffix = f"{fname}_{tag_inv[tag]}_{label_inv[label]}_{item[4]}"
            if args.with_device:
                suffix += f"_{item[5]}"
            items.append((wav, suffix))
    elif args.dataset == "2015":
        ds = ASVspoof2015RawDataset(args.path_to_database,
                                    args.path_to_protocol, args.part)
        tag_inv = {v: k for k, v in ds.tag.items()}
        label_inv = {v: k for k, v in ds.label.items()}
        for i in range(len(ds)):
            wav, fname, tag, label = ds[i]
            items.append((wav, f"{fname}_{tag_inv[tag]}_{label_inv[label]}"))
    elif args.dataset == "vcc2020":
        ds = VCC2020RawDataset(args.path_to_spoof, args.path_to_bonafide)
        for i in range(len(ds)):
            wav, fname, tag, label = ds[i]
            items.append((wav, f"{fname}_{tag}_{label}"))
    elif args.dataset == "2021eval":
        ds = ASVspoof2021EvalRawDataset(args.path_to_database)
        for i in range(len(ds)):
            wav, fname = ds[i]
            items.append((wav, fname))
    else:
        raise ValueError(args.dataset)
    return items


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("materialize features to disk")
    p.add_argument("--dataset", type=str, default="2019",
                   choices=["2019", "aug", "2015", "vcc2020", "2021eval"])
    p.add_argument("-a", "--access_type", type=str, default="LA")
    p.add_argument("-d", "--path_to_database", type=str, default="")
    p.add_argument("-o", "--out_dir", type=str, required=True)
    p.add_argument("--part", type=str, default="train",
                   choices=["train", "dev", "eval"])
    p.add_argument("--feature", type=str, default="LFCC",
                   choices=list(FEATURES))
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--aug_wav_dir", type=str, default="",
                   help="root of augmented wavs (<root>/<part>/**.wav) "
                        "as written by the degrade CLI")
    p.add_argument("--with_device", action="store_true",
                   help="aug filenames carry _channel_device suffixes")
    p.add_argument("--path_to_protocol", type=str, default="",
                   help="protocol dir (aug/2015 datasets)")
    p.add_argument("--path_to_spoof", type=str, default="")
    p.add_argument("--path_to_bonafide", type=str, default="")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    # the JAX CLI's checks, at argparse
    if args.dataset in ("2019", "2021eval") and not args.path_to_database:
        p.error(f"--dataset {args.dataset} requires -d/--path_to_database")
    if args.dataset == "aug" and not args.aug_wav_dir:
        p.error("--dataset aug requires --aug_wav_dir")
    if args.dataset == "aug" and not (args.path_to_protocol
                                      or args.path_to_database):
        p.error("--dataset aug requires --path_to_protocol (or -d to derive "
                "the protocol dir)")
    if args.dataset == "2015" and not (args.path_to_database
                                       and args.path_to_protocol):
        p.error("--dataset 2015 requires -d and --path_to_protocol")
    if args.dataset == "vcc2020" and not (args.path_to_spoof
                                          and args.path_to_bonafide):
        p.error("--dataset vcc2020 requires --path_to_spoof and "
                "--path_to_bonafide")

    extractor, hop = build_extractor(args.feature, args.device)
    items = collect_items(args)
    out_dir = os.path.join(args.out_dir, args.part, args.feature)
    n = bucket_extract(extractor, hop, items, out_dir, 0, args.batch_size,
                       device=args.device)
    print(f"wrote {n} feature files to {out_dir}")
    return n


def script() -> None:
    """The ``asvspoof-torch-preprocess`` console script: :func:`main`
    without its return value (the count of files written), which
    ``sys.exit`` would take for a failure code."""
    main()


if __name__ == "__main__":
    main()
