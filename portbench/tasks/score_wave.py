"""Scoring waveforms: a closed loop over a pool of pinned host batches.

Each batch goes through the loop body of the port's
``scoring.score_raw_to_file``: the ``OnDeviceFrontend`` (LFCC through
kernel B1, repeat padding to the model's frames), the scoring model of
``scoring.build_scoring_model`` in the configuration's compute type, and
``scoring.score_rule``; then the scores are copied to pinned host memory
behind a CUDA event. The loop keeps ``in_flight`` batches handed off and
not yet on the host; a batch's latency runs from its hand-off to the
entry until its scores are on the host.

``correct`` compares every answer of the window with the plain reference
(LFCC, the model in float32 with TF32 off, OC-Softmax's score) on the
same pool batch: the largest absolute gap of a score.
"""

from __future__ import annotations

import collections
import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.harness import inputs, kernels
from portbench.reference import common

UNIT = "batch"
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Task:
    def __init__(self, cell, seed: int, device: torch.device,
                 weights: Dict[str, torch.Tensor]):
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg, self.traffic = cell.config, cell.traffic
        self.weights = weights
        self.batch = self.traffic["batch"]
        self.pool = None
        self.answers: List[tuple] = []
        self.next = 0

    # ---- the program ------------------------------------------------------

    def setup(self) -> None:
        """Build the entry and warm it up on the pool's first batches."""
        from asvspoof2021_air_tpu_torch.losses.registry import build_loss
        from asvspoof2021_air_tpu_torch.scoring import (
            build_scoring_model, score_rule)
        from asvspoof2021_air_tpu_torch.train.frontend import OnDeviceFrontend

        cfg, dev = self.cfg, self.device
        self.pool = inputs.wave_pool(self.traffic, self.seed, dev)
        sd = {k: v for k, v in self.weights.items()
              if not k.startswith("loss.")}
        frontend = OnDeviceFrontend(feat_len=cfg["feat_len"],
                                    padding=self.traffic["padding"],
                                    device=dev)
        net = build_scoring_model(sd, cfg["port_model"],
                                  dtype=DTYPES[cfg["compute_dtype"]],
                                  device=dev)
        lc = cfg["loss"]
        loss = build_loss(lc["name"], enc_dim=cfg["embedding"],
                          r_real=lc["r_real"], r_fake=lc["r_fake"],
                          alpha=lc["alpha"], device=dev)
        with torch.no_grad():
            loss.center.copy_(self.weights["loss.center"])
        loss.eval()

        def entry(wave, length):
            with torch.inference_mode():
                feats = frontend({"wave": wave, "length": length})
                emb, logits = net(feats)
                return score_rule(lc["name"], emb, logits, loss).float()

        self.entry = entry
        cuda = dev.type == "cuda"
        self.bufs = [inputs.pinned(torch.zeros(self.batch))
                     for _ in range(self.traffic["in_flight"] + 1)]
        self.event = (lambda: torch.cuda.Event()) if cuda else (lambda: None)
        # every shape the window uses: the one batch shape
        self.run(count=self.traffic["in_flight"] + 1, keep=False)
        self.answers = []

    def run(self, seconds: Optional[float] = None,
            count: Optional[int] = None, keep: bool = True) -> dict:
        """Hand off batches in turn, ``in_flight`` at a time, for
        ``seconds`` (then drain) or ``count`` batches; return the work done
        and each batch's latency."""
        P, depth = self.traffic["pool_batches"], self.traffic["in_flight"]
        pool, bufs = self.pool, self.bufs
        pending, lat = collections.deque(), []
        sync = torch.cuda.synchronize if self.device.type == "cuda" \
            else (lambda: None)

        waited = 0.0

        def complete():
            nonlocal waited
            k, t_sub, ev, buf = pending.popleft()
            t = time.perf_counter()
            if ev is not None:
                ev.synchronize()
            done = time.perf_counter()
            waited += done - t
            lat.append(done - t_sub)
            if keep:
                self.answers.append((k, buf.numpy().copy()))

        sync()
        t0 = time.perf_counter()
        i = 0
        while (count is None or i < count) and (
                seconds is None or time.perf_counter() - t0 < seconds):
            k = self.next % P
            self.next += 1
            t_sub = time.perf_counter()
            scores = self.entry(pool["wave"][k], pool["length"][k])
            buf = bufs[i % len(bufs)]
            buf.copy_(scores, non_blocking=True)
            ev = self.event()
            if ev is not None:
                ev.record()
            pending.append((k, t_sub, ev, buf))
            if len(pending) >= depth:
                complete()
            i += 1
        while pending:
            complete()
        t1 = time.perf_counter()
        return {"t0": t0, "seconds": t1 - t0, "units": i,
                "utterances": i * self.batch, "latency_s": lat,
                "waited_s": waited}

    def end_to_end(self, window: dict) -> Dict[str, float]:
        lat_ms = 1e3 * np.asarray(window["latency_s"])
        return {"score_utt_per_s": window["utterances"] / window["seconds"],
                "score_batch_p95_ms": float(np.percentile(lat_ms, 95))}

    def model_flops(self, window: dict) -> float:
        return window["utterances"] * self.cell.config_module.forward_flops(
            self.cfg, self.cfg["feat_len"])

    def kernel_work(self) -> dict:
        fe, L = self.cfg["frontend"], self.traffic["max_samples"]
        work = {"B1": kernels.lfcc_b1(self.batch, L, fe["win"], fe["hop"],
                                      fe["n_fft"], fe["n_filters"])}
        work.update(self.cell.config_module.kernel_work(
            self.cfg, self.batch, train=False))
        return work

    def release(self) -> None:
        self.entry = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- correct ----------------------------------------------------------

    def reference_scores(self, prec: Optional[str] = None) -> np.ndarray:
        """(P, B) scores of the pool's batches by the plain reference, in
        float32 with TF32 off, or with ``prec``'s operands."""
        common.full_f32()
        cfg, dev = self.cfg, self.device
        ref = self.cell.config_module.reference
        p = {k: v.to(dev) for k, v in self.weights.items()}
        out = []
        with torch.no_grad():
            for k in range(self.traffic["pool_batches"]):
                wave = self.pool["wave"][k].to(dev)
                length = self.pool["length"][k].to(dev)
                feats = common.lfcc(wave, length, cfg["frontend"])
                feats = common.repeat_pad(feats, length, cfg["frontend"]["hop"],
                                          cfg["feat_len"])
                emb, _ = ref.forward(p, feats, False, None, cfg, prec)
                lc = cfg["loss"]
                labels = torch.zeros(emb.shape[0], dtype=torch.long,
                                     device=dev)
                _, score = common.oc_softmax(emb, p["loss.center"], labels,
                                             lc["r_real"], lc["r_fake"],
                                             lc["alpha"])
                out.append(score.float().cpu().numpy())
        return np.stack(out)

    def numbers(self, answers=None, reference=None) -> Dict[str, float]:
        """The compared number: the largest |score - reference score| over
        ``answers`` (the window's by default)."""
        answers = self.answers if answers is None else answers
        ref = self.reference_scores() if reference is None else reference
        if not answers:
            return {"score_gap": float("inf")}
        gaps = [np.abs(a - ref[k]) for k, a in answers]
        if not all(np.isfinite(g).all() for g in gaps):
            return {"score_gap": float("inf")}
        return {"score_gap": max(float(g.max()) for g in gaps)}

    def failed(self) -> int:
        """Utterances whose score is not a finite number."""
        return int(sum(np.sum(~np.isfinite(a)) for _, a in self.answers))
