"""Serving export of the PyTorch/CUDA port: a trained run's scoring
function as a ``torch.export`` artifact.

    python -m asvspoof2021_air_tpu_torch.cli.export --model_folder <runs> \\
        -n <run> -o <out>.pt2 [--raw [--wave_seconds 7.49]] [--check] \\
        [--quantize none|int8] [--batch_size 64] [--device cuda|cpu]

The port's counterpart of the JAX package's ``cli/export.py``, with its
flags plus ``--device``. The deployable unit is an ``ExportedProgram``
written by ``torch.export.save``: the weights are in it, the signature is
static (the batch size, and ``feat_len`` or the waveform's samples), and
it runs without the port's model code. Kernels B1 (LFCC), B2 (the Res2
chain) and B3 (the attention pooling) are custom ops of the namespace
``asv_torch`` (``ops/custom_ops.py``): an artifact exported on the card
launches them there, one exported on the CPU runs their plain versions.
Loading needs them registered:

    import torch
    import asvspoof2021_air_tpu_torch.ops.custom_ops  # registers asv_torch::*
    torch.backends.cudnn.allow_tf32 = False  # the f32 convs, as exported
    scores = torch.export.load("<out>.pt2").module()(feats)

(The live scorer turns TF32 off when it runs; the artifact holds the
graph, not that global switch, and PyTorch's default runs f32
convolutions on the card in TF32.)

Export surfaces, as in JAX:
- feature scoring (default): (batch, feat_len, feat_dim) f32 features ->
  (batch,) raw scores by the run's add-loss rule (``scoring.score_rule``,
  the rule ``cli.generate_score`` applies), through the model
  ``scoring.build_scoring_model`` builds (ECAPA's serving graph in f32);
- raw scoring (``--raw``): (batch, n_samples) f32 waveforms + (batch,)
  int32 lengths -> (batch,) scores, with the run's ``OnDeviceFrontend``
  (no augmenter) in the artifact; RawNet2 reads waveforms, so it exports
  only so, through its ``WaveformFrontend``;
- an ``--ensemble`` run exports one artifact scoring the mean of its
  members' scores (the members run one after another).

Writes <out> and <out>.json (the JAX metadata's keys, ``platforms`` the
torch device type, and the custom-op namespace that loading needs).
``--check`` loads the written bytes back and holds them against the live
scorer (rtol = atol = 1e-5) on ``default_rng(0)`` input; with
``--quantize int8`` it also reports the scores' deviation from the float
system and the share of score pairs the two order alike.
"""

from __future__ import annotations

import argparse
import io
import json
import os
from typing import Optional

import numpy as np
import torch

from asvspoof2021_air_tpu_torch._device import resolve_device
from asvspoof2021_air_tpu_torch.cli.generate_score import load_system
from asvspoof2021_air_tpu_torch.ops import custom_ops
from asvspoof2021_air_tpu_torch.scoring import build_scoring_model, score_rule


class MemberScore(torch.nn.Module):
    """feats -> (B,) raw scores of one system by the ``add_loss`` rule."""

    def __init__(self, net, loss_module, add_loss: Optional[str]):
        super().__init__()
        self.net, self.loss_module, self.add_loss = net, loss_module, add_loss

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        emb, logits = self.net(feats)
        return score_rule(self.add_loss, emb, logits,
                          self.loss_module).float()


class ScoreModule(torch.nn.Module):
    """The exported function: feats (B, T, F) -> (B,) scores, or with a
    ``frontend`` (wave (B, L), length (B,)) -> (B,); the members' mean for
    an ensemble (the JAX ``build_score_fn``)."""

    def __init__(self, members, frontend=None):
        super().__init__()
        self.members = torch.nn.ModuleList(members)
        self.frontend = frontend

    def score_feats(self, feats: torch.Tensor) -> torch.Tensor:
        if len(self.members) == 1:
            return self.members[0](feats)
        return torch.stack([m(feats) for m in self.members]).mean(dim=0)

    def forward(self, *args: torch.Tensor) -> torch.Tensor:
        if self.frontend is None:
            return self.score_feats(args[0])
        wave, length = args
        return self.score_feats(self.frontend({"wave": wave,
                                               "length": length}))


def build_score_module(state_dicts, loss_modules, cfg, frontend=None,
                       device="cuda") -> ScoreModule:
    """The scorer of a run's members (lists, one entry per member) in
    eval mode on ``device``, its weights frozen."""
    dev = resolve_device(device)
    add_loss = cfg.add_loss if cfg.add_loss not in (None, "None") else None
    members = []
    for sd, loss_mod in zip(state_dicts, loss_modules):
        net = build_scoring_model(sd, cfg.model, model_scale=cfg.model_scale,
                                  feat_dim=cfg.feat_dim,
                                  rawnet_args=cfg.rawnet_args, device=dev)
        if loss_mod is not None:
            loss_mod = loss_mod.to(dev).eval()
        members.append(MemberScore(net, loss_mod, add_loss))
    module = ScoreModule(members, frontend).eval()
    for p in module.parameters():
        p.requires_grad_(False)
    return module


def _frontend(cfg, raw: bool, device):
    if cfg.model == "rawnet":
        # raw-waveform model: there is no feature surface to export
        if not raw:
            raise ValueError(
                "rawnet consumes raw waveforms; export it with --raw")
        from asvspoof2021_air_tpu_torch.models.rawnet import (
            RAWNET2_DEFAULT_ARGS)
        from asvspoof2021_air_tpu_torch.train.frontend import WaveformFrontend

        nb_samp = (cfg.rawnet_args or RAWNET2_DEFAULT_ARGS)["nb_samp"]
        return WaveformFrontend(n_samples=nb_samp, augmenter=None,
                                device=device)
    if not raw:
        return None
    from asvspoof2021_air_tpu_torch.train.frontend import OnDeviceFrontend

    return OnDeviceFrontend(feat_len=cfg.feat_len, padding=cfg.padding,
                            augmenter=None, feature=cfg.feat, device=device)


def export_system(model_dir: str, output: str, batch_size: int = 64,
                  raw: bool = False, wave_seconds: float = 7.49,
                  checkpoint: str = "best", check: bool = False,
                  quantize: str = "none", device="cuda") -> dict:
    """Export a trained run to a ``torch.export`` artifact on ``device``;
    returns the metadata. ``quantize='int8'`` stores the matmul and conv
    weights as int8 with per-channel scales (``ops/quantize.py``) and
    reports their bytes."""
    dev = resolve_device(device)
    sds, loss_mods, cfg = load_system(model_dir, checkpoint, dev)
    if cfg.ensemble == 1:
        sds, loss_mods = [sds], [loss_mods]
    float_sds = sds
    if quantize == "int8":
        from asvspoof2021_air_tpu_torch.ops.quantize import (
            dequantize_state_dict, quantize_state_dict_int8, quantized_bytes)

        # JAX's docstrings say the dequantize is traced into the artifact;
        # its code dequantizes before jax.jit, so its artifact holds f32
        # constants. The port follows the code: the weights go through
        # int8 and back here, and the artifact holds the f32 result.
        qsds = [quantize_state_dict_int8(sd) for sd in sds]
        qbytes = sum(quantized_bytes(q)[0] for q in qsds)
        fbytes = sum(quantized_bytes(q)[1] for q in qsds)
        sds = [dequantize_state_dict(q) for q in qsds]
    elif quantize != "none":
        raise ValueError(f"unknown quantize mode {quantize!r}")
    frontend = _frontend(cfg, raw, dev)
    fn = build_score_module(sds, loss_mods, cfg, frontend, dev)

    if raw:
        n_samples = max(int(wave_seconds * 16000), frontend.min_samples())
        args = (torch.zeros((batch_size, n_samples), device=dev),
                torch.full((batch_size,), n_samples, dtype=torch.int32,
                           device=dev))
        signature = {"wave": [batch_size, n_samples, "float32"],
                     "length": [batch_size, "int32"]}
    else:
        args = (torch.zeros((batch_size, cfg.feat_len, cfg.feat_dim),
                            device=dev),)
        signature = {"feat": [batch_size, cfg.feat_len, cfg.feat_dim,
                              "float32"]}

    with torch.no_grad():
        exported = torch.export.export(fn, args, strict=False)
    # The zeros it was traced on: saved, they would double a --raw file.
    exported.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    blob = buf.getvalue()

    if check:
        back = torch.export.load(io.BytesIO(blob)).module()
        g = np.random.default_rng(0)
        if raw:
            test_args = (
                torch.from_numpy(g.standard_normal(
                    (batch_size, n_samples)).astype(np.float32)).to(dev),
                torch.full((batch_size,), n_samples, dtype=torch.int32,
                           device=dev))
        else:
            test_args = (torch.from_numpy(g.standard_normal(
                (batch_size, cfg.feat_len, cfg.feat_dim)).astype(
                    np.float32)).to(dev),)
        with torch.no_grad():
            got = back(*test_args).cpu().numpy()
            want = fn(*test_args).cpu().numpy()
        if not np.allclose(got, want, rtol=1e-5, atol=1e-5):
            raise RuntimeError(f"roundtrip check failed: max diff "
                               f"{np.abs(got - want).max()}")
        if quantize == "int8":
            # deviation of the quantized scorer from the float system
            float_fn = build_score_module(float_sds, loss_mods, cfg,
                                          frontend, dev)
            with torch.no_grad():
                ref = float_fn(*test_args).cpu().numpy()
            quant_dev = float(np.abs(got - ref).max())
            # score-ORDER agreement: EER and min-tDCF see only the order,
            # so the share of pairs the two scorers rank alike
            go = np.sign(got.ravel()[:, None] - got.ravel()[None, :])
            ro = np.sign(ref.ravel()[:, None] - ref.ravel()[None, :])
            quant_rank = float((go == ro).mean())

    meta = {
        "platforms": [dev.type],
        "signature": signature,
        "output": [batch_size, "float32"],
        "mode": "raw" if raw else "features",
        "model": cfg.model,
        "add_loss": cfg.add_loss,
        "ensemble": cfg.ensemble,
        "score_semantics": (
            "raw score; write -score to reproduce reference score files"),
        "bytes": len(blob),
        "quantize": quantize,
        "custom_op_namespace": custom_ops.NAMESPACE,
        "load": ("import asvspoof2021_air_tpu_torch.ops.custom_ops, then "
                 "torch.export.load(<file>).module(); f32 results as "
                 "exported need torch.backends.cudnn.allow_tf32 = False"),
    }
    if quantize == "int8":
        meta["param_bytes_int8"] = qbytes
        meta["param_bytes_f32"] = fbytes
        if check:
            meta["quantized_score_max_dev"] = quant_dev
            meta["quantized_rank_agreement"] = quant_rank
    os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)
    with open(output, "wb") as f:
        f.write(blob)
    with open(output + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("export a trained system for serving")
    p.add_argument("--model_folder", type=str, default="./models")
    p.add_argument("-n", "--model_name", type=str, required=True)
    p.add_argument("-o", "--output", type=str, required=True,
                   help="artifact path (metadata written to <output>.json)")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--raw", action="store_true",
                   help="export waveform->score with the LFCC front-end "
                        "in the artifact (cache-free serving)")
    p.add_argument("--wave_seconds", type=float, default=7.49,
                   help="static waveform length for --raw (reference "
                        "operating point: 750 LFCC frames)")
    p.add_argument("--checkpoint", type=str, default="best")
    p.add_argument("--check", action="store_true",
                   help="load the artifact back and verify it against the "
                        "live scorer before writing")
    p.add_argument("--quantize", type=str, default="none",
                   choices=["none", "int8"],
                   help="weights-only int8 with per-channel scales "
                        "(ops/quantize.py); --check reports the score "
                        "deviation from the float system")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    ckpt = args.checkpoint
    if ckpt != "best" and not os.path.isabs(ckpt):
        ckpt = os.path.join("checkpoint", ckpt)
    meta = export_system(
        os.path.join(args.model_folder, args.model_name), args.output,
        batch_size=args.batch_size, raw=args.raw,
        wave_seconds=args.wave_seconds, checkpoint=ckpt, check=args.check,
        quantize=args.quantize, device=args.device)
    print(json.dumps(meta))
    return meta


def script() -> None:
    """The ``asvspoof-torch-export`` console script: :func:`main` without
    its return value (the artifact's metadata), which ``sys.exit`` would
    take for a failure code."""
    main()


if __name__ == "__main__":
    main()
