#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. print the card (nvidia-smi name and power limit); build the CUDA
   kernels from ``asvspoof2021_air_tpu_torch/csrc`` and print the build time;
2. hold each kernel against its plain PyTorch version on the card at the
   serving path's shapes (B1 LFCC at (64, 119840), at win 400 / hop 200,
   at an odd hop (win 318 / hop 159), at every other FFT size it is built
   for (n_fft 4 to 256) and on a padded input with digital silence after a
   loud stretch and a -60 dB tone, and two B1 launches bitwise equal; B2
   Res2 chain at (64, 750, 512), d = 2/3/4, in f32 (3xTF32, TF32 off in
   the plain version) and bf16, each with valid_len < T at each d and two
   launches bitwise equal, its f32 time beside the seven f32 ``x3 @ w``
   products and its 3xTF32 bound; B3 attention pooling at
   (64, 750, 1536), f32 with TF32 off and bf16, each at valid_len None,
   T - 50, a row-tile boundary and inside the first tile, with the rows
   past valid_len scaled by 7, and two launches bitwise equal), B2's rows
   past valid_len zero; print each kernel's error, its time, the plain
   version's and, for B1, ``torch.fft.rfft`` of the windowed frames as a
   yardstick (the port never calls it); B3's peak memory, its bound beside
   its design's floor (x read twice), and a profile of its three passes;
2b. hold the training kernels B4a (forward) and B4b (backward) of the
   differentiable attentive statistics against their plain versions at
   (64, 750, 1536), H = 128, x in f32 and in bf16, and in f32 at T = 749;
   check that two launches of each on the same inputs are bitwise equal;
   print the peak device memory of one backward, kernel and plain, their
   times, the plain versions' and one f32 ``h2 @ W2`` matmul as a
   yardstick (the port never calls it), B4a's and B4b's times against one
   and three of those, and their bounds at the 3xTF32 rate beside the
   f32-FMA ones;
3. drive the serving path at full width: ECAPA-TDNN C=512 (scale 8,
   embedding 256) and an OC-Softmax center from a numpy seed, 136 synthetic
   utterances written as FLAC (16-bit verbatim subframes, by the numpy
   writer below) under ``flac/`` with a protocol, read by
   ``RawAudioDataset`` (decoded waveforms checked against the samples
   written) and scored by ``score_raw_to_file`` in bf16 at batch 64 (two
   full requests and a partial one); check the score file (one finite score
   per utterance), the kernels' launch counts over that run, that a WAV
   copy of the corpus scores the same (its host time printed beside the
   FLAC one), an unlabeled ``ASVspoof2021EvalRawDataset`` tree of WAV and
   FLAC mixed (a 2-column file), and the bf16 embeddings' cosine against
   the plain f32 path (unfused ECAPA, plain LFCC) on the card;
3b. drive feature-file scoring through ``cli.generate_score`` at full
   width: a port run folder (``args.json``, ``best.pt``) from seed
   weights, ``19dev`` and ``LA`` trees of 136 LFCC ``.npy`` files each
   (T = 750 mostly, some shorter, some longer), scored in f32 (the
   default), in bf16 and in f32 with ``--scan_batches 2`` (a CUDA graph);
   check B2 (3 per batch) and B3 (1 per batch) launches in the f32 and bf16
   scorers, the files' rows against the datasets, the f32 scores against a
   plain f32 ECAPA on the same batches (1e-4), bf16 against f32 (0.03),
   the scanned file against K = 1 (1e-6); then ``cli.evaluate_tdcf`` with
   a synthetic ASV score file and ``cli.score_fusion -m avg / wght`` over
   the f32 and bf16 files; print the CLI's host ms per batch, the scorer's
   forward ms (CUDA events) and a profile of the f32 forward;
4. drive the training path at full width: ``train`` of ECAPA-TDNN C=512
   with OC-Softmax (ang_iso), on the fly from 4 x 64 synthetic train wavs
   and 64 dev wavs, batch 64, 750 frames, 2 epochs (8 steps, 2 dev
   passes), f32 with TF32 off; check the losses (finite, falling), that
   the weights and BN statistics moved, the logs and checkpoints, that a
   checkpoint restores to the live state, and the launch counts of B1,
   B4a and B4b over that run; then hold one step through B4a/B4b against
   the same step through their plain versions (loss, every gradient, BN
   statistics); print ms per step (CUDA events), utterances/s, a profile
   of one step by kernel group and the device's busy share;
4b. drive bf16 training at full width as the JAX package runs it in
   production: ``train`` with ``compute_dtype="bfloat16"`` and
   ``steps_per_call=8`` (one CUDA graph of 8 steps, replayed) from a
   synthetic ``LA_aug`` tree of LFCC ``.npy`` files (320 original and
   160 augmented train files, ratio 0.5: 10 steps an epoch, a call of 8
   and a tail of 2) with ``test_on_eval`` over an eval tree, 2 epochs;
   check the losses (finite), that weights, BN statistics and the center
   moved, the log's step numbers, one ``test_loss.log`` line per epoch,
   and the B4a/B4b launch counts (warm-up + capture + tails; on the card
   capture x replays + eager); then ``auto_resume`` to a third epoch
   (step count carried over) and ``continue_training`` loading
   ``best.pt``; 8 graph-replayed steps against 8 eager steps of the same
   capturable step from one state (rtol 1e-6, cuDNN deterministic;
   bitwise equality printed); one bf16 step through B4a/B4b against
   their plain versions (phase 4's bars, the losses and BN statistics to
   one bf16 ulp relative); the bf16 forward's embeddings against f32's
   (cosine 0.9996); an on-the-fly bf16 run of 18 steps at K = 8, so that
   B1 replays from a graph too, with ``profile`` on (a trace of its
   first steps, the capture and a replay inside); print ms per step and
   utterances/s by CUDA events for f32 K=1 (phase 4's), bf16 K=1 and
   bf16 K=8 on the fly and from features, peak memory, and profiles of a
   bf16 step and of one 8-step replay by kernel group with the device's
   busy share;
4c. drive channel-robust training at full width: ``train`` with
   ``ADV_AUG`` (the GRL channel classifier over the 60 LA channels) in
   bf16 with ``steps_per_call=8`` from a synthetic ``LA_aug`` tree whose
   augmented files carry 59 channels, 2 epochs of 10 steps, so that the
   adversarial gate flips from 0 to 1 between two replays of one graph;
   check the launch counts, the losses, that the classifier moved in
   epoch 0, that ``auto_resume`` restores it; 8 replayed steps against 8
   eager steps at gate 0 and at gate 1 (rtol 1e-6; ``adv_loss``,
   ``clf_loss``, ``clf_acc`` finite, and the total loss ang_iso + gate x
   adv_loss in the replay); one ADV bf16 step through B4a/B4b against
   their plain versions at gate 1 (phase 4's bars); then ADV_AUG in f32
   at one step a call with two classifiers (channels and devices) from a
   ``LAPA_aug`` tree; then on the fly, bf16, K = 8, with the channel
   augmenter (``on_device_aug``, ``apply_ir``, ``dev_aug``), 18 steps;
   the augmenter on the card against the same augmenter on the CPU with
   the same draws at (64, 119840) (1e-5; the G.711 families' samples
   99.9% within 1e-5 and the rest one code step away); 8 replayed steps
   against 8 eager ones with the augmenter on; print ms per step and
   utt/s by CUDA events on the fly with and without the augmenter and
   from features with and without ADV_AUG (bf16, K = 8), the augmenter's
   own ms at (64, 119840), peak memory, and a profile of one replay with
   the augmenter;
4d. drive the LCNN and ResNet18 families at full width (B = 64, T = 750,
   weights from a seed): ``train`` of ResNet18 + ang_iso (2 epochs of 2
   steps) and LCNN + iso_sq (one epoch of 2 steps) in f32 at one step a
   call on the fly, so B1 runs on two new paths, each step's and dev
   batch's launch counted; the losses finite, BN statistics and the loss
   module moved; one on-the-fly step through B1 against the same step
   through B1's plain version at phase 4's bars (the model's dropout or
   noise drawn from the run's seed and the step, so both steps draw the
   same); then LCNN + p2sgrad and ResNet18 + isolate in bf16 at
   ``steps_per_call=8`` from feature files (2 epochs of 8 steps: one
   capture, one replay), 8 replayed steps against 8 eager ones (rtol 1e-6,
   cuDNN deterministic) with the model's draws as static inputs of the
   graph; then ``cli.generate_score`` over a 19dev tree of 136 LFCC files
   for run folders of both families with every add-loss (None, ang_iso,
   isolate, iso_sq, p2sgrad, amsoftmax) and every ``-l`` rule (softmax,
   ocsoftmax, ang_iso, isolate, iso_sq, p2sgrad, amsoftmax): the files'
   rows, finite scores, the first 8 against the same scorer on the CPU
   (1e-4), and ``cli.evaluate_tdcf``; print ms per step, utt/s and peak
   memory by CUDA events for the four configurations and a profile of
   each with the device's busy share;
4e. drive the last three families of the JAX registry at full width
   (B = 64, weights from a seed): ``train`` of SE-Res2Net50 (base width
   26, scale 4, layers 3/4/6/3) + ang_iso and ConvNet (enc_dim 256) +
   ang_iso in f32 at one step a call on the fly (one epoch of 2 steps, T =
   750), B1 counted under ``train_res2net_otf`` / ``train_cnn_otf``, one
   step through B1 against the same step through its plain version at
   phase 4's bars; both families from feature files at
   ``compute_dtype="bfloat16"`` and ``steps_per_call=8`` (2 epochs of 8
   steps), checked to compute in f32 as in JAX, 8 replayed steps against
   8 eager ones (rtol 1e-6); RawNet2 at its default arguments (64600
   samples, a cuDNN GRU of 3 x 1024) with CE on the fly with the channel
   augmenter at K = 8, replay against eager, no B1 launch; then
   ``cli.generate_score`` over the two feature-file run folders and
   ``score_raw_to_file`` of RawNet2 over 136 FLAC utterances, the first 8
   scores of each against the CPU (1e-4); print ms per step, utt/s, peak
   memory, profiles by kernel group with the busy share, and the scorers'
   forward ms;
5. drive feature materialization: ``cli.preprocess`` of a synthetic
   ASVspoof 2019 LA dev part of 256 FLAC utterances of 1.0 - 8.0 s (from
   a seed) to LFCC files on the card at batch 32 (B1 once per bucket
   batch, 8 in all, buckets up to (32, 128000)); each file within 5e-4
   of the plain LFCC of its utterance alone, unpadded, on the card; the
   names and arrays of a CPU run (5e-4); ``build_task_dataset`` and
   ``RatioMixIterator`` reading the tree back; ``--dataset aug
   --with_device`` over 8 augmented WAVs and their suffixes; STFT,
   Melspec and CQCC on 8 utterances: the card's distance to their
   float64 value (the port's modules with float64 constants, on the card)
   within twice the CPU run's, and the card's distance to the CPU run
   within the sum of the two; print utterances/s by the host clock and
   B1's ms at (32, 128000);
5b. drive ensembles on one card: ``train`` with ``ensemble=3``
   (ECAPA-TDNN-512 + ang_iso, B = 64, T = 750, bf16, ``steps_per_call=8``:
   the 3 x 8 member-steps one CUDA graph) from an ``LA_aug`` tree as
   phase 4b's for one epoch with dev (B4a/B4b launched per member), then
   on the fly with the channel augmenter (16 steps: a capture and a
   replay; the front-end once a step over the 192-row tiled batch, so B1
   once a step); the launch counts, a checkpoint of every member, every
   member moved and the members apart; from features and on the fly, 8
   replayed ensemble steps against 8 eager ones (rtol 1e-6) and each
   member's ensemble step against a single-system step from its state
   (rtol 1e-6; bitwise counted), on the fly on rows i B .. (i + 1) B - 1
   of the tiled batch's features, which B1 computes within 5e-4 of the
   plain LFCC under the same augmenter draws; then ``cli.generate_score``
   over 136 LFCC files with the 3-member folder (B2/B3 per member): the
   fused file the mean of the member files (1e-6), and ``--fusion wght``
   over 136 files without class signal: the members' EERs differ and the
   fused file is their entropy-weighted sum (1e-6); print ms per step and
   utterances/s (B a step, and M B member-utterances), peak memory and
   profiles of both graphs with the busy share;
6. drive the int8 serving tiers at full width (ECAPA-TDNN-512, B = 64, T
   = 750 padded to 752 as JAX's fused chain pads, bf16, LFCC of synthetic
   utterances through B1): ``quantize`` True, "mfa" and False, each with
   dynamic and with calibrated activation scales
   (``calibrate_act_scales`` in f32 over two other batches); B1, B2 and
   B3's launches over one forward of each tier; each tier against the f32
   serving graph at JAX's bars (embedding cosine > 0.999, logits atol
   0.05 / rtol 0.1) and against its twin with B2/B3's plain versions on
   the card (cosine > 0.9999, the same logit bars); each tier's ms a
   batch (CUDA events, LFCC included, as phase 3's forward) beside phase
   3's; the device time of ``aten::_int_mm`` against ``aten::mm`` in each
   tier and a profile of the int8 forward; then ``cli.export`` of a
   full-width ECAPA + ang_iso run folder for features, for ``--raw``
   (7.49 s) and with ``--quantize int8``, each with ``--check``: the
   launches of those runs, each loaded artifact's custom ops in its graph,
   the B1/B2/B3 launches of one run of it, its scores against the live
   scorer (1e-5), its ms a batch against the live scorer's and its bytes;
   the int8 export's parameter bytes and score deviation.

7. drive the multi-GPU layer on the one card (``parallel/``): 7b, two
   ranks spawned over gloo with CUDA tensors (NCCL refuses two ranks on
   one device), the data-parallel f32 ECAPA-512 step on the fly at a
   global B = 64 (32 a rank; B1, B4a and B4b in each rank) against the
   one-process B = 64 step at phase 4's bars (the loss rtol 1e-4, each
   gradient's error norm within max(1e-2, 4 x the one-process step's
   spread, the batch reversed among it), each BN statistic by
   ``bn_ulp_bars``), the two ranks' states bitwise equal; sharded scoring
   of 2 B + 3 feature files (B2, B3 in each rank) against the one-process
   file (1e-5, row for row); the member-parallel M = 2 step (one member a
   rank) against the one-card ensemble step (rtol 1e-6, cuDNN's
   deterministic algorithms, from a state one step on); 7c, four ranks
   over gloo, two steps of the 2 x 2 member x data step from features at
   B = 16 (8 a data shard): each member's replicas bitwise equal, the
   members apart; the two rank groups run together while this process
   computes their references. Then 7a in this process over NCCL at world
   size 1: ``train()`` bf16 K = 8 on the fly (the NCCL all-reduces
   captured in the CUDA graph; launch counts as phase 4b's), the eager
   data-parallel step against the one-process step at phase 4b's bars, 8
   replayed against 8 eager data-parallel steps (rtol 1e-6), and the
   one-process and data-parallel K-step graphs' ms a step, in turns,
   beside phase 4b's. Kernel launches count under ``train_dp``,
   ``score_dp``, ``train_member_dp`` and ``train_member_data_dp``, summed
   over the ranks; a rank that fails or hangs (killed after 300 s) fails
   the phase.

8. drive the augmented pipeline without JAX (the degraded corpus): 8a,
   on the host, 32 + 32 synthetic WAVs of 3.0-4.0 s (train, dev) through
   ``cli.degrade`` channel ``--sampling random --fidelity native`` at
   -j 1 and -j 4 (the trees byte-equal), compression, make-irs and device
   with 3 IRs; every output named as the CLI names it, of its source's
   length, finite and unlike its source; utterances/s of each mode;
   whether the system codec tier (libavcodec + libopus) is present, and
   ``--fidelity system`` over 4 files only where it is (an absent tier
   is printed as such and checks nothing); 8b, ``cli.preprocess`` of the
   original and degraded parts through B1 (``preprocess_aug``), ADV_AUG's
   channel labels read back as the degraded names' codecs, ``train()``
   of ECAPA-TDNN-512 + ang_iso in bf16 at K = 8 with LA_aug + ADV_AUG
   from those trees (B = 8, 16 steps, B4a/B4b counted under
   ``train_laaug``), one step at B = 64 through B4a/B4b against their
   plain versions (phase 4c's ADV step at gate 1, phase 4b's bars), then
   ``cli.generate_score -t 19laaugdev`` (B2, B3 under ``score_laaug``),
   its first 8 scores against the CPU's (1e-4); ms a step (an 8-step
   replay of K batches of 64, the tree's 32 originals and 32 degraded
   files reshuffled and cropped anew each batch: the other training
   cells' batch) and ms a batch of the f32 scorer by CUDA events; 8c,
   one f32 ECAPA-TDNN-512 step at B = 64, T = 750 plain, with
   ``fused_chain`` and with ``remat_policy="conv_dot"`` from one state
   and batch: loss,
   gradients and BN statistics at phase 4's bars against the plain step,
   each one's ms and ``torch.cuda.max_memory_allocated``.

9. drive the training configurations ported last, at B = 64, T = 750,
   C = 512 from seeded features: 9a, one ECAPA step with fused_pool and
   fused_bn off (plain autograd; no B4a/B4b launch) against the fused
   step from one state, f32 at phase 8c's bars and bf16 at phase 4b's
   (the losses, every gradient beside the unfused step's spread on the
   batch reversed, the BN statistics; the attention's two biases, whose
   gradients are rounding noise, under 1e-4 / 1e-2 of the largest
   gradient element), both steps' peak memory, their K = 1 ms and the
   bf16 K = 8 graphs' ms a step, in turns; 9b, ``remat_policy=
   "conv_dot"`` through the K = 8 CUDA graph in bf16 (B4a/B4b under
   ``train_conv_dot_graph``), 8 replayed against 8 eager steps
   (``check_replay``); 9c, ``fused_chain`` inside the data-parallel K = 8
   bf16 graph over NCCL at world size 1 (B4a/B4b under
   ``train_dp_fused_chain``) against the one-process ``fused_chain``
   graph, replays from one state, cuDNN deterministic, at
   ``check_replay``'s bars; 9d, the ECAPA variant ``context=False``,
   ``encoder_type="SAP"``, ``out_bn=False``: its f32 eval forward on the
   card against the CPU's on 8 utterances (1e-4 of the largest) and its
   recompute-VJP training step (no B4a/B4b launch: a one-channel
   attention never fuses) against the plain autograd step at phase 8c's
   bars.

Every profile prints the device's busy share as the union of the profiled
call's device intervals over its window (CUDA events inside the profiled
call), beside the former reading (summed device time over a window timed
apart).

The native codec library is built from ``native/augment`` after the
kernels, its time printed. Each phase's seconds are printed.

The line before the last is a JSON object with one entry per kernel; the
last line is the device JSON. The script imports only the port, torch and
numpy. It exits non-zero without a GPU or without the port beside it.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and
# FLOP/s by operand type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12}

B, L, T, C, D = 64, 119840, 750, 512, 1536
DEVICE = "cuda"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over iters back-to-back calls (CUDA
    events), after warmup calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bound(nbytes: float, flops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def peak_mib(torch, fn) -> float:
    """Peak device memory of one call of fn above what was allocated before
    it, its outputs included, in MiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    del out
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def bf16_ulp(v):
    """One bf16 ulp at each |v| > 0: 2^(floor(log2 |v|) - 7)."""
    import torch

    return torch.exp2((torch.frexp(v.float())[1] - 8).float())


KERNEL_GROUPS = (
    ("B4a softmax_stats fwd", ("softmax_stats_fwd_kernel",)),
    ("B4b softmax_stats bwd", ("softmax_stats_bwd_",)),
    ("B1 lfcc", ("lfcc_kernel",)),
    ("B2 res2_chain", ("res2_chain_",)),
    ("B3 attn_pool", ("proj_stats_", "context_bias_kernel",
                      "attentive_pool_kernel")),
    # cuDNN's convolutions run implicit-GEMM kernels ("..._xmma_wgrad_
    # implicit_gemm_..."), so they are matched before cuBLAS's GEMMs.
    ("FFT (cuFFT)", ("fft",)),
    # RawNet2's GRU (cuDNN's recurrent kernels), before the convolutions
    ("GRU (cuDNN RNN)", ("rnn", "gru", "persist")),
    ("conv (cuDNN)", ("conv", "cudnn", "implicit", "wgrad", "dgrad",
                      "fprop")),
    ("matmul (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
)


# B3's three passes, for its own profile.
B3_PASSES = (
    ("B3 pass A proj_stats (x @ Wx, column sums)", ("proj_stats_",)),
    ("B3 pass B context_bias (mean, std, c)", ("context_bias_kernel",)),
    ("B3 pass C attentive_pool (h @ Wb, softmax over T)",
     ("attentive_pool_kernel",)),
)


def union_us(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


def _annotation(ev) -> bool:
    """A range that annotates the device's timeline (such as
    ``Optimizer.step#Adam.step``), not device work."""
    return (bool(getattr(ev, "is_user_annotation", False))
            or ev.key.startswith(("Optimizer.", "ProfilerStep#")))


def profile_device(torch, fn, fn_ms: float, what: str,
                   kernel_groups=KERNEL_GROUPS):
    """Device time of one call of fn by kernel group (torch.profiler, device
    events only: kernels, copies and sets, not the ranges that annotate
    them on the device's timeline), and the device's busy share: the union
    of those events' intervals over the call's window, timed by CUDA
    events recorded inside the profiled call (the window taken as at least
    the span from the first event's start to the last one's end, so that
    the share is at most 100%). Beside it the former reading: the events'
    summed time over ``fn_ms``, the call's CUDA-event time measured apart
    without the profiler, which counts overlapping kernels twice and
    divides by a window the profiler did not slow."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
    window_ms = start.elapsed_time(stop)
    intervals = [(ev.time_range.start, ev.time_range.end)
                 for ev in prof.events()
                 if str(getattr(ev, "device_type", "")).endswith("CUDA")
                 and not _annotation(ev)]
    other = "other (elementwise, reductions, copies)"
    groups = {name: 0.0 for name, _ in kernel_groups}
    groups[other] = 0.0
    kernels, ranges = [], []
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        us = float(getattr(ev, "self_device_time_total", 0.0) or 0.0)
        if _annotation(ev):
            ranges.append(f"{ev.key} {us / 1e3:.3f} ms")
            continue
        kernels.append((us, ev.count, ev.key))
        key = ev.key.lower()
        for name, pats in kernel_groups:
            if any(p in key for p in pats):
                groups[name] += us
                break
        else:
            groups[other] += us
    summed = sum(groups.values()) / 1e3
    union = union_us(intervals) / 1e3
    span = ((max(b for _, b in intervals) - min(a for a, _ in intervals))
            / 1e3 if intervals else 0.0)
    window = max(window_ms, span)
    busy = 100 * union / window if window > 0 else 0.0
    print(f"profile of one {what}: device busy {busy:.1f}% = the union of "
          f"{len(intervals)} device intervals, {union:.3f} ms, over the "
          f"profiled call's window {window:.3f} ms (CUDA events inside the "
          f"profiled call {window_ms:.3f} ms, device events' span "
          f"{span:.3f} ms); former reading {100 * summed / fn_ms:.1f}% "
          f"(summed device time {summed:.3f} ms over the {fn_ms:.3f} ms "
          f"{what} timed without the profiler)")
    check(busy <= 100.0, f"busy share of one {what}: {busy}")
    for name, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {name}: {us / 1e3:.3f} ms")
    print(f"  annotation ranges left out: {ranges or 'none'}")
    for us, count, key in sorted(kernels, reverse=True)[:12]:
        print(f"    {us / 1e3:8.3f} ms  x{count:<4d} {key[:90]}")
    return busy


def kernel_checks(torch, gen):
    """Phase 2. Returns the kernel entries (without launches)."""
    from asvspoof2021_air_tpu_torch.ops import attn_pool_cuda as ap
    from asvspoof2021_air_tpu_torch.ops import lfcc_cuda as lc
    from asvspoof2021_air_tpu_torch.ops import res2_chain_cuda as rc
    from asvspoof2021_air_tpu_torch.ops.lfcc import LFCCConfig, emphasize

    dev = torch.device(DEVICE)
    randn = lambda *s, scale=1.0: torch.randn(
        *s, generator=gen, device=dev) * scale
    entries = {}

    # B1: LFCC. f32 only (the front-end's bar rules out lower precision).
    # The serving configurations; an odd hop and frame offset (the kernel's
    # unpaired loads); every other FFT size it is built for, where from
    # n_fft 64 down several frames share a warp.
    cfgs = [LFCCConfig(), LFCCConfig(win_length=400, hop_length=200),
            LFCCConfig(win_length=318, hop_length=159),
            LFCCConfig(n_fft=256, win_length=200, hop_length=100)]
    cfgs += [LFCCConfig(n_fft=n, win_length=n, hop_length=n // 2)
             for n in (4, 8, 16, 32, 64, 128)]
    errs = []
    for cfg in cfgs:
        fe = lc.CudaLFCC(cfg, device=dev)
        consts = (fe.window, fe.twiddle, fe.bands, fe.weights, fe.dct)
        x = emphasize(randn(B, L, scale=0.3), cfg, None).contiguous()
        got = lc.lfcc_kernel(x, *consts, cfg)
        want = lc.lfcc_plain(x, fe.cs, fe.fb, fe.dct, cfg)
        err = max_err(got, want)
        print(f"B1 lfcc n_fft={cfg.n_fft} win={cfg.win_length} "
              f"hop={cfg.hop_length} shape={tuple(got.shape)} "
              f"max_abs_err={err:.3e} (atol 5e-4)")
        check(err <= 5e-4, f"B1 disagrees with its plain version: {err}")
        errs.append(err)
        if cfg != LFCCConfig():
            continue
        # Two launches on the same input agree bit for bit.
        check(torch.equal(got, lc.lfcc_kernel(x, *consts, cfg)),
              "two B1 launches on the same input differ")
        # A padded batch: a loud stretch, digital silence right after it,
        # then a -60 dB tone, each utterance cut at its own length.
        n = torch.arange(L, device=dev)
        loud_end = (L // 3 + 37 * torch.arange(B, device=dev))[:, None]
        tone = 1e-3 * torch.sin(2 * np.pi * 440.0 / 16000.0 * n.float())
        wave = torch.where(n < loud_end, randn(B, L, scale=0.3),
                           torch.where(n < 2 * L // 3, 0.0, tone))
        lengths = torch.randint(L // 2, L + 1, (B,), generator=gen,
                                device=dev)
        lengths[0] = L
        xp = emphasize(wave, cfg, lengths).contiguous()
        got_p = lc.lfcc_kernel(xp, *consts, cfg)
        want_p = lc.lfcc_plain(xp, fe.cs, fe.fb, fe.dct, cfg)
        err = max_err(got_p, want_p)
        print(f"B1 lfcc padded (lengths, silence after loud, -60 dB tone) "
              f"max_abs_err={err:.3e} (atol 5e-4); two launches bitwise "
              f"equal")
        check(err <= 5e-4, f"B1 disagrees with its plain version on the "
                           f"padded input: {err}")
        errs.append(err)
        T1 = got.shape[1]
        ms = time_ms(torch, lambda: lc.lfcc_kernel(x, *consts, cfg))
        plain_ms = time_ms(torch, lambda: lc.lfcc_plain(
            x, fe.cs, fe.fb, fe.dct, cfg))
        frames = torch.nn.functional.pad(x, (cfg.hop_length,) * 2).unfold(
            1, cfg.win_length, cfg.hop_length)[:, :T1]
        off = (cfg.n_fft - cfg.win_length) // 2
        framed = torch.nn.functional.pad(
            (frames * fe.window).reshape(-1, cfg.win_length),
            (off, cfg.n_fft - cfg.win_length - off))
        fft_ms = time_ms(torch, lambda: torch.fft.rfft(framed, dim=-1))
        # The bound counts what the function needs: a real FFT of n_fft
        # gives the bins in 2.5 n log2 n flops per frame; then the window,
        # re^2 + im^2, the filterbank's nonzero weights, the log and the
        # DCT. Bytes: the waveform read, the constants, the cepstra written.
        n_fft, nf = cfg.n_fft, cfg.n_filters
        n_bins = fe.fb.shape[0]
        fb_nnz = int((fe.fb != 0).sum())
        nbytes = 4 * (x.numel() + cfg.win_length + n_fft + fb_nnz
                      + fe.dct.numel() + got.numel())
        flops = B * T1 * (2.5 * n_fft * float(np.log2(n_fft))
                          + cfg.win_length + 3 * n_bins + 2 * fb_nnz + nf
                          + 2 * nf * nf)
        print(f"B1 work: the function needs {flops / 1e9:.3f} GFLOP (FFT) "
              f"and {nbytes / 1e6:.1f} MB; yardstick (never called by the "
              f"port): torch.fft.rfft of the windowed ({B * T1}, {n_fft}) "
              f"frames {fft_ms:.4f} ms")
        entries["B1"] = dict(
            name="B1 lfcc (fused LFCC front-end)",
            source="asvspoof2021_air_tpu_torch/csrc/lfcc.cu",
            replaces="asvspoof2021_air_tpu/ops/lfcc_pallas.py:98 "
                     "(_lfcc_lane128_kernel) and :45 (_lfcc_kernel)",
            ms=ms, plain_ms=plain_ms, bytes=nbytes, flops=flops,
            kind="f32", extra={"fft_ms": fft_ms})
    entries["B1"]["max_abs_err"] = max(errs)

    # B2: Res2 chain, f32 and bf16, d = 2/3/4, and one padded case.
    sd = {}
    for j in range(7):
        sd[f"l.convs.{j}.weight"] = randn(64, 64, 3, scale=1 / 192 ** 0.5)
        sd[f"l.convs.{j}.bias"] = randn(64, scale=0.05)
        sd[f"l.bns.{j}.weight"] = 1 + randn(64, scale=0.1)
        sd[f"l.bns.{j}.bias"] = randn(64, scale=0.1)
        sd[f"l.bns.{j}.running_mean"] = randn(64, scale=0.1)
        sd[f"l.bns.{j}.running_var"] = 1 + randn(64, scale=0.1).abs()
    packed = rc.pack_chain_params(sd, "l")
    # the kernel takes w in x's type, cast once (as ServingECAPA does)
    packed_of = {torch.float32: packed,
                 torch.bfloat16: (packed[0].bfloat16(), *packed[1:])}
    x32 = randn(B, T, C)
    xbf = x32.bfloat16()
    errs, times, plain_times, times32 = [], [], [], []
    # valid_len inside an earlier tile (600), and inside the last (700, 730)
    # for the 64- and 128-row tiles the kernel could take
    valid_of = {2: T - 150, 3: T - 50, 4: T - 20}
    for d in (2, 3, 4):
        # f32: atol 1e-4. bf16, at every element, in ulps of max(|want|, 1):
        # <= i + 1 in group i = 0..6 and 0 in the passed-through group 7;
        # and at most 1e-5 of the elements over 1 ulp. The chain rounds to
        # bf16 after each of its 7 convs, and a sum taken in another order
        # can flip one of those roundings by one ulp. Group 0's conv reads
        # only x, so it differs by at most that flip; group i also reads,
        # through its conv, the flips of the i steps before it, each worth
        # up to about one more ulp. Flips are rare, so few elements may
        # exceed one ulp.
        cases = [(x32, None), (x32, valid_of[d]), (xbf, None),
                 (xbf, valid_of[d])]
        for x, valid in cases:
            p = packed_of[x.dtype]
            got = rc.res2_chain_kernel(x, *p, dilation=d, valid_len=valid)
            want = rc.res2_chain_plain(x, *p, dilation=d, valid_len=valid)
            err = max_err(got, want)
            if x.dtype == torch.float32:
                ok, bar = err <= 1e-4, "atol 1e-4"
            else:
                diff = (got.float() - want.float()).abs()
                ulps = diff / bf16_ulp(want.float().abs().clamp(min=1.0))
                g = ulps.unflatten(-1, (8, C // 8)).amax(dim=(0, 1, 3))
                bars = torch.tensor([1.0, 2, 3, 4, 5, 6, 7, 0], device=dev)
                n_over = int((ulps > 1).sum())
                ok = bool((g <= bars).all()) and n_over <= 1e-5 * ulps.numel()
                bar = (f"bf16 ulp of max(|want|, 1) per group "
                       f"{[round(v, 3) for v in g.tolist()]}, bars "
                       f"1..7/0; {n_over} of {ulps.numel()} elements over "
                       f"1 ulp, bar {1e-5 * ulps.numel():.0f}")
            print(f"B2 res2_chain d={d} {str(x.dtype)[6:]} valid={valid} "
                  f"max_abs_err={err:.3e} ({bar})")
            check(ok, f"B2 disagrees with its plain version (d={d}, "
                      f"{x.dtype}, valid={valid}): {err}")
            if valid is not None:
                check(bool((got[:, valid:] == 0).all()),
                      f"B2 rows past valid_len are not zero ({x.dtype})")
                continue
            if x is x32:
                errs.append(err)
            check(torch.equal(got, rc.res2_chain_kernel(x, *p, dilation=d)),
                  f"two B2 launches on the same input differ ({x.dtype})")
            print(f"B2 res2_chain d={d} {str(x.dtype)[6:]}: two launches "
                  f"bitwise equal")
        p = packed_of[torch.bfloat16]
        times.append(time_ms(torch, lambda: rc.res2_chain_kernel(
            xbf, *p, dilation=d)))
        plain_times.append(time_ms(torch, lambda: rc.res2_chain_plain(
            xbf, *p, dilation=d)))
        # f32, the feature-file scorer's default: B2's 3xTF32 kernel
        times32.append(time_ms(torch, lambda: rc.res2_chain_kernel(
            x32, *packed_of[torch.float32], dilation=d)))
        print(f"B2 res2_chain d={d} bf16 {times[-1]:.4f} ms (plain "
              f"{plain_times[-1]:.4f} ms), f32 {times32[-1]:.4f} ms")
    w16 = packed_of[torch.bfloat16][0][0]
    x3 = torch.cat([xbf[..., :64]] * 3, dim=-1).reshape(-1, 192)
    matmul_ms = 7 * time_ms(torch, lambda: x3 @ w16)
    # f32 yardstick: the seven f32 x3 @ w products, TF32 off (never called
    # by the port)
    w32 = packed[0][0]
    x3 = x3.float()
    matmul32_ms = 7 * time_ms(torch, lambda: x3 @ w32)
    del x3
    entries["B2"] = dict(
        name="B2 res2_chain (inference Res2 chain, one launch per block)",
        source="asvspoof2021_air_tpu_torch/csrc/res2_chain.cu",
        replaces="asvspoof2021_air_tpu/ops/res2_chain_pallas.py:54 "
                 "(_chain_kernel)",
        ms=float(np.mean(times)), plain_ms=float(np.mean(plain_times)),
        matmul_ms=matmul_ms, max_abs_err=max(errs),
        bytes=2 * 2 * B * T * C + 2 * packed[0].numel()
        + 4 * 3 * packed[1].numel(),
        flops=2 * B * T * 192 * 64 * 7, kind="bf16")
    # f32 runs its products in 3xTF32: three TF32 products each, at the TF32
    # rate. The bound at the f32-FMA rate, which held the earlier FMA
    # design, is printed beside.
    f32_bytes = (2 * 4 * B * T * C + 4 * packed[0].numel()
                 + 4 * 3 * packed[1].numel())
    f32_flops = 2 * B * T * 192 * 64 * 7
    f32_bound = bound(f32_bytes, 3 * f32_flops, "tf32")
    fma_bound = bound(f32_bytes, f32_flops, "f32")
    entries["B2"]["extra"] = {"ms_f32": float(np.mean(times32)),
                              "bound_ms_f32": f32_bound[0],
                              "matmul_ms_f32": matmul32_ms}
    print(f"B2 res2_chain f32 (3xTF32 kernel) {np.mean(times32):.4f} ms per "
          f"launch, mean of d = 2/3/4, against the seven f32 x3 @ w "
          f"products (TF32 off) {matmul32_ms:.4f} ms; bound "
          f"{f32_bound[0]:.4f} ms by {f32_bound[1]} at the 3xTF32 rate "
          f"(3 x {f32_flops / 1e9:.2f} GFLOP at 495 TFLOP/s), "
          f"{fma_bound[0]:.4f} ms at the f32-FMA rate (the earlier FMA "
          f"design's bound)")

    # B3: attention pooling, f32 and bf16 x. Both products keep f32's
    # accuracy (x @ Wx against two bf16 planes of Wx for bf16 x, in 3xTF32
    # for f32 x; h @ Wb in 3xbf16), so one tolerance: sums over T = 750 in
    # another order. valid_len: none; T - 50 (inside the last row tile);
    # 640 (a boundary of every row tile and chunk the kernel could take: 64
    # and 128 rows); 37 (inside the first tile). Rows at and past valid_len
    # are scaled by 7: the kernel must leave them out of every statistic.
    # Two launches agree bit for bit.
    sdp = {
        "attention.0.weight": randn(128, 3 * D, 1, scale=0.02),
        "attention.0.bias": randn(128, scale=0.05),
        "attention.2.weight": 1 + randn(128, scale=0.1),
        "attention.2.bias": randn(128, scale=0.1),
        "attention.2.running_mean": randn(128, scale=0.1),
        "attention.2.running_var": 1 + randn(128, scale=0.1).abs(),
        "attention.3.weight": randn(D, 128, 1, scale=0.05),
        "attention.3.bias": randn(D, scale=0.05),
    }
    pp = ap.pack_pool_params(sdp)
    xp32 = torch.relu(randn(B, T, D))
    xpbf = xp32.bfloat16()
    errs = []
    for x0 in (xp32, xpbf):
        for valid in (None, T - 50, 640, 37):
            x = x0
            if valid is not None:
                x = x0.clone()
                x[:, valid:] *= 7
            got = ap.attention_pooling_kernel(x, pp, valid)
            want = ap.attention_pooling_plain(x, pp, valid)
            err = max_err(got, want)
            ok = torch.allclose(got, want, atol=1e-4, rtol=1e-4)
            same = torch.equal(got, ap.attention_pooling_kernel(x, pp, valid))
            print(f"B3 attn_pool {str(x.dtype)[6:]} valid={valid} "
                  f"max_abs_err={err:.3e} (atol 1e-4, rtol 1e-4); two "
                  f"launches bitwise equal: {same}")
            check(ok, f"B3 disagrees with its plain version ({x.dtype}, "
                      f"valid={valid}): {err}")
            check(same, f"two B3 launches differ ({x.dtype}, valid={valid})")
            errs.append(err)
            del x, got, want
    ms = time_ms(torch, lambda: ap.attention_pooling_kernel(xpbf, pp))
    ms32 = time_ms(torch, lambda: ap.attention_pooling_kernel(xp32, pp))
    plain_ms = time_ms(torch, lambda: ap.attention_pooling_plain(xpbf, pp))
    wx16 = pp.wx.bfloat16()
    matmul_ms = 2 * time_ms(torch, lambda: xpbf @ wx16)
    mib = peak_mib(torch, lambda: ap.attention_pooling_kernel(xpbf, pp))
    nbytes = (2 * xpbf.numel() + 4 * sum(t.numel() for t in pp[:8])
              + 4 * B * 2 * D)
    flops = 2 * B * T * D * 128 * 2 + 2 * B * 2 * D * 128
    fn_bound = bound(nbytes, flops, "bf16")
    # The design reads x twice and writes and reads P (B, T, 128) f32.
    floor_bytes = nbytes + 2 * xpbf.numel() + 2 * 4 * B * T * 128
    print(f"B3 attn_pool bf16 {ms:.4f} ms, f32 {ms32:.4f} ms (plain, bf16, "
          f"{plain_ms:.4f} ms; yardstick: two bf16 x @ Wx products, never "
          f"called by the port, {matmul_ms:.4f} ms); peak device memory of "
          f"one bf16 call {mib:.1f} MiB (output included); bound "
          f"{fn_bound[0]:.4f} ms by {fn_bound[1]} (the function reads x "
          f"once: {nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP bf16); this "
          f"design's floor, x read twice and P written and read: "
          f"{floor_bytes / 1e6:.1f} MB = "
          f"{floor_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    profile_device(torch, lambda: ap.attention_pooling_kernel(xpbf, pp), ms,
                   "B3 call (bf16)", kernel_groups=B3_PASSES)
    entries["B3"] = dict(
        name="B3 attn_pool (context attentive-statistics pooling)",
        source="asvspoof2021_air_tpu_torch/csrc/attn_pool.cu",
        replaces="asvspoof2021_air_tpu/ops/attn_pool_pallas.py:31 (_kernel)",
        ms=ms, plain_ms=plain_ms, matmul_ms=matmul_ms, max_abs_err=max(errs),
        bytes=nbytes, flops=flops, kind="bf16",
        extra={"ms_f32": ms32, "peak_mib": mib})
    return entries


def vjp_checks(torch, gen, entries):
    """Phase 2b: B4a and B4b against their plain versions. Adds the B4a and
    B4b entries (without launches) to ``entries``."""
    from asvspoof2021_air_tpu_torch.ops import attn_pool_vjp as vj

    dev = torch.device(DEVICE)
    randn = lambda *s, scale=1.0: torch.randn(
        *s, generator=gen, device=dev) * scale
    H = vj.HIDDEN
    w2 = randn(H, D, scale=H ** -0.5)          # lecun-normal's scale
    b2 = randn(D, scale=0.05)
    errs = {"B4a": [], "B4b": []}
    for dtype, t in ((torch.float32, T), (torch.bfloat16, T),
                     (torch.float32, T - 1)):
        x = torch.relu(randn(B, t, D)).to(dtype)
        h2 = randn(B, t, H).to(dtype)
        gmu, ge2 = randn(B, D), randn(B, D, scale=0.1)
        tag = f"{str(dtype)[6:]} T={t}"
        # (mu, e2) in f32 from inputs of either type: sums over T in
        # another order, atol = rtol = 1e-4.
        res = vj.softmax_stats_fwd_kernel(x, h2, w2, b2)
        want = vj.softmax_stats_fwd_plain(x, h2, w2, b2)
        err = max(max_err(g, w) for g, w in zip(res[:2], want[:2]))
        ok = all(torch.allclose(g, w, atol=1e-4, rtol=1e-4)
                 for g, w in zip(res[:2], want[:2]))
        print(f"B4a softmax_stats fwd {tag} max_abs_err={err:.3e} "
              f"(mu, e2: atol 1e-4, rtol 1e-4)")
        check(ok, f"B4a disagrees with its plain version ({tag}): {err}")
        errs["B4a"].append(err)
        # dx, dh2: rtol 1e-4, atol 1e-5 on the f32 values; in bf16 both
        # round their f32 value once, which may flip one bf16 ulp, so one
        # ulp of |want| is added. dW2 (sums of B T = 48000 terms): each
        # element within 1e-4 max|want|.
        got_b = vj.softmax_stats_bwd_kernel(x, h2, w2, b2, res, gmu, ge2)
        want_b = vj.softmax_stats_bwd_plain(x, h2, w2, b2, want, gmu, ge2)
        msgs, oks = [], []
        for name, g, w in zip(("dx", "dh2"), got_b[:2], want_b[:2]):
            check(g.dtype == dtype, f"B4b {name} is {g.dtype}, not {dtype}")
            g, w = g.float(), w.float()
            tol = 1e-5 + 1e-4 * w.abs()
            if dtype == torch.bfloat16:
                tol = tol + bf16_ulp(w.abs().clamp(min=1e-30))
            oks.append(bool(((g - w).abs() <= tol).all()))
            msgs.append(f"{name} {max_err(g, w):.3e}")
        dw_err = max_err(got_b[2], want_b[2])
        dw_bar = 1e-4 * float(want_b[2].abs().max())
        oks.append(dw_err <= dw_bar)
        msgs.append(f"dW2 {dw_err:.3e} (bar {dw_bar:.3e})")
        ulp = ", + 1 bf16 ulp" if dtype == torch.bfloat16 else ""
        print(f"B4b softmax_stats bwd {tag} max_abs_err: {', '.join(msgs)} "
              f"(dx, dh2: rtol 1e-4, atol 1e-5{ulp})")
        check(all(oks), f"B4b disagrees with its plain version ({tag}): "
                        f"{msgs}")
        errs["B4b"].append(max(max_err(g, w) for g, w in zip(got_b, want_b)))

    # db2 is exactly zero through the autograd Function.
    args = [x, h2, w2.clone().requires_grad_(), b2.clone().requires_grad_()]
    mu, e2 = vj.FusedSoftmaxStats.apply(*args)
    torch.autograd.backward((mu, e2), (gmu, ge2))
    check(bool((args[3].grad == 0).all()), "db2 is not exactly zero")
    print("B4b db2 through FusedSoftmaxStats: exactly 0")

    # Times at the training path's type, f32.
    x = torch.relu(randn(B, T, D))
    h2 = randn(B, T, H)
    res = vj.softmax_stats_fwd_kernel(x, h2, w2, b2)

    # Two launches on the same inputs agree bit for bit: every sum of B4a
    # and B4b runs in a fixed order, with no atomics.
    res2 = vj.softmax_stats_fwd_kernel(x, h2, w2, b2)
    check(all(torch.equal(a, b) for a, b in zip(res, res2)),
          "two B4a launches on the same inputs differ")
    outs = [vj.softmax_stats_bwd_kernel(x, h2, w2, b2, res, gmu, ge2)
            for _ in range(2)]
    check(all(torch.equal(a, b) for a, b in zip(*outs)),
          "two B4b launches on the same inputs differ (dx, dh2 or dW2)")
    print("B4a (mu, e2) and B4b (dx, dh2, dW2): two launches on the same "
          "inputs are bitwise equal")
    del res2, outs

    # Peak device memory of one backward call (its outputs dx, dh2, dW2
    # included), kernel against plain.
    bwd_mib = peak_mib(torch, lambda: vj.softmax_stats_bwd_kernel(
        x, h2, w2, b2, res, gmu, ge2))
    bwd_plain_mib = peak_mib(torch, lambda: vj.softmax_stats_bwd_plain(
        x, h2, w2, b2, res, gmu, ge2))
    print(f"B4b peak device memory of one backward ({B} x {T} x {D}, f32, "
          f"outputs included): kernel {bwd_mib:.1f} MiB (bar 360), plain "
          f"{bwd_plain_mib:.1f} MiB")
    check(bwd_mib <= 360, f"B4b's backward peaks at {bwd_mib:.1f} MiB")

    fwd_ms = time_ms(torch, lambda: vj.softmax_stats_fwd_kernel(x, h2, w2, b2))
    fwd_plain_ms = time_ms(torch, lambda: vj.softmax_stats_fwd_plain(
        x, h2, w2, b2))
    bwd_ms = time_ms(torch, lambda: vj.softmax_stats_bwd_kernel(
        x, h2, w2, b2, res, gmu, ge2))
    bwd_plain_ms = time_ms(torch, lambda: vj.softmax_stats_bwd_plain(
        x, h2, w2, b2, res, gmu, ge2))
    h2d = h2.reshape(-1, H)
    matmul_ms = time_ms(torch, lambda: h2d @ w2)   # f32, TF32 off
    print(f"B4 yardstick: one f32 h2 @ W2 ({B * T} x {H} x {D}, TF32 off, "
          f"torch.matmul, never called by the port) {matmul_ms:.4f} ms")
    flop = 2.0 * B * T * H * D
    xh_bytes = 4 * (x.numel() + h2.numel() + w2.numel() + b2.numel())
    bwd_bytes = xh_bytes + 4 * (2 * B * D + x.numel() + h2.numel()
                                + w2.numel())
    # B4a runs its product (flop) and B4b its three (3 flop) in 3xTF32:
    # three TF32 products each, at the TF32 rate. The bounds at the f32-FMA
    # rate, which held the kernels' earlier FMA designs, are printed beside.
    fwd_bytes = xh_bytes + 4 * 2 * B * D
    for name, ms, nbytes, n in (("B4a", fwd_ms, fwd_bytes, 1),
                                ("B4b", bwd_ms, bwd_bytes, 3)):
        tf32_bound = bound(nbytes, 3 * n * flop, "tf32")
        fma_bound = bound(nbytes, n * flop, "f32")
        print(f"{name} {ms:.4f} ms against {n} x the h2 @ W2 yardstick "
              f"{n * matmul_ms:.4f} ms; bound {tf32_bound[0]:.4f} ms by "
              f"{tf32_bound[1]} at the 3xTF32 rate (3 x {n * flop / 1e9:.1f} "
              f"GFLOP at 495 TFLOP/s), {fma_bound[0]:.4f} ms at the f32-FMA "
              f"rate (the earlier FMA design's bound)")
    entries["B4a"] = dict(
        name="B4a softmax_stats fwd (differentiable attentive statistics)",
        source="asvspoof2021_air_tpu_torch/csrc/attn_pool_vjp.cu",
        replaces="asvspoof2021_air_tpu/ops/attn_pool_vjp.py:53 (_fwd_kernel)",
        ms=fwd_ms, plain_ms=fwd_plain_ms, matmul_ms=matmul_ms,
        max_abs_err=max(errs["B4a"]), bytes=fwd_bytes, flops=3 * flop,
        kind="tf32")
    entries["B4b"] = dict(
        name="B4b softmax_stats bwd (its VJP: dx, dh2, dW2; db2 = 0)",
        source="asvspoof2021_air_tpu_torch/csrc/attn_pool_vjp.cu",
        replaces="asvspoof2021_air_tpu/ops/attn_pool_vjp.py:72 (_bwd_kernel)",
        ms=bwd_ms, plain_ms=bwd_plain_ms, matmul_ms=matmul_ms,
        max_abs_err=max(errs["B4b"]), bytes=bwd_bytes, flops=3 * 3 * flop,
        kind="tf32", extra={"peak_mib": bwd_mib})


@contextlib.contextmanager
def plain_b4(reverse_t: bool = False):
    """B4a/B4b's plain versions in place of the kernels, for FusedSoftmaxStats
    on CUDA tensors (the step the kernel path is held against). With
    ``reverse_t`` they run on x and h2 reversed along T: the same function
    with its sums over T taken in another order."""
    from asvspoof2021_air_tpu_torch.ops import attn_pool_vjp as vj

    fwd, bwd = vj.softmax_stats_fwd_plain, vj.softmax_stats_bwd_plain
    if reverse_t:
        r = lambda t: t.flip(1)

        def fwd(x, h2, w2, b2):
            return vj.softmax_stats_fwd_plain(r(x), r(h2), w2, b2)

        def bwd(x, h2, w2, b2, res, gmu, ge2):
            dx, dh2, dw2 = vj.softmax_stats_bwd_plain(r(x), r(h2), w2, b2,
                                                      res, gmu, ge2)
            return r(dx), r(dh2), dw2

    saved = vj.softmax_stats_fwd_kernel, vj.softmax_stats_bwd_kernel
    vj.softmax_stats_fwd_kernel, vj.softmax_stats_bwd_kernel = fwd, bwd
    try:
        yield
    finally:
        vj.softmax_stats_fwd_kernel, vj.softmax_stats_bwd_kernel = saved


def _crc_table(poly: int, width: int) -> np.ndarray:
    """Byte table of the MSB-first CRC of ``width`` bits (init 0)."""
    top, mask = 1 << (width - 1), (1 << width) - 1
    table = []
    for b in range(256):
        crc = b << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) & mask if crc & top else (crc << 1) & mask
        table.append(crc)
    return np.array(table, np.uint32)


CRC8, CRC16 = _crc_table(0x07, 8), _crc_table(0x8005, 16)


def _crc16_rows(rows: np.ndarray) -> np.ndarray:
    """FLAC's CRC-16 of each row of a (n, length) uint8 array."""
    crc = np.zeros(len(rows), np.uint32)
    for j in range(rows.shape[1]):
        crc = ((crc << 8) & 0xFFFF) ^ CRC16[(crc >> 8) ^ rows[:, j]]
    return crc


def _utf8_number(v: int) -> bytes:
    """A frame number in FLAC's UTF-8-like coding."""
    if v < 0x80:
        return bytes([v])
    n = (v.bit_length() - 2) // 5     # continuation bytes: 5 n + 6 bits
    out = [0x80 | ((v >> (6 * i)) & 0x3F) for i in range(n)][::-1]
    return bytes([((0xFF00 >> (n + 1)) & 0xFF) | (v >> (6 * n))] + out)


def write_flac_files(items, sr: int = 16000, block: int = 4096) -> None:
    """Write each (path, int16 samples) as a mono 16-bit FLAC stream of
    verbatim subframes, with valid header CRC-8 and frame CRC-16 (computed
    for all frames of one length at once)."""
    streams, frames = [], []
    for k, (path, pcm) in enumerate(items):
        n = len(pcm)
        info = ((block << 128) | (block << 112) | (sr << 44) | (15 << 36)
                | n).to_bytes(18, "big") + bytes(16)
        streams.append(bytearray(b"fLaC" + bytes([0x80, 0, 0, 34]) + info))
        for f, start in enumerate(range(0, n, block)):
            blk = pcm[start:start + block]
            head = (bytes([0xFF, 0xF8, 0x70, 0x08]) + _utf8_number(f)
                    + (len(blk) - 1).to_bytes(2, "big"))
            crc = 0
            for b in head:
                crc = int(CRC8[crc ^ b])
            frames.append((k, head + bytes([crc, 0x02])
                           + blk.astype(">i2").tobytes()))
    by_len = {}
    for i, (_k, body) in enumerate(frames):
        by_len.setdefault(len(body), []).append(i)
    crcs = [0] * len(frames)
    for idx in by_len.values():
        rows = np.frombuffer(b"".join(frames[i][1] for i in idx),
                             np.uint8).reshape(len(idx), -1)
        for i, c in zip(idx, _crc16_rows(rows)):
            crcs[i] = int(c)
    for (k, body), crc in zip(frames, crcs):
        streams[k] += body + crc.to_bytes(2, "big")
    for (path, _pcm), data in zip(items, streams):
        with open(path, "wb") as f:
            f.write(bytes(data))


def write_corpus(root: str, n: int, seed: int, part: str = "eval",
                 fmt: str = "wav", lengths=None, spoof_tag: str = "A07"):
    """ASVspoof2019-layout corpus part of n utterances (bona fide: noise,
    spoof: a tone + noise, tagged ``spoof_tag``), mostly 7.49 s, a few
    shorter and two longer (or of the given ``lengths`` in samples), as
    16-bit WAVs under ``wav/`` or FLACs under ``flac/``. Returns
    {filename: int16 samples written}."""
    from asvspoof2021_air_tpu_torch.data.audio_io import write_wav

    g = np.random.default_rng(seed)
    audio_dir = os.path.join(root, "LA", f"ASVspoof2019_LA_{part}", fmt)
    proto_dir = os.path.join(root, "LA", "ASVspoof2019_LA_cm_protocols")
    os.makedirs(audio_dir)
    os.makedirs(proto_dir, exist_ok=True)
    lines, written, flacs = [], {}, []
    for i in range(n):
        length = L
        if lengths is not None:
            length = int(lengths[i])
        elif i % 23 == 5:
            length = int(g.integers(L // 8, L // 2))
        elif i in (7, 70):
            length = L + 20000
        label = i % 2
        wav = 0.1 * g.standard_normal(length)
        if label:
            t = np.arange(length) / 16000.0
            wav = 0.3 * np.sin(2 * np.pi * (300 + 7 * i) * t) + 0.02 * wav
        fname = f"LA_{part[0].upper()}_{i:07d}"
        # write_wav's quantization, kept for the FLAC copy
        pcm = np.round(np.clip(wav.astype(np.float32), -1.0, 1.0)
                       * 32767.0).astype(np.int16)
        written[fname] = pcm
        path = os.path.join(audio_dir, f"{fname}.{fmt}")
        if fmt == "flac":
            flacs.append((path, pcm))
        else:
            write_wav(path, wav)
        lines.append(f"LA_0001 {fname} - {spoof_tag if label else '-'} "
                     f"{'spoof' if label else 'bonafide'}")
    write_flac_files(flacs)
    with open(os.path.join(proto_dir, f"ASVspoof2019.LA.cm.{part}.trl.txt"),
              "w") as f:
        f.write("\n".join(lines) + "\n")
    return written


def main_path(torch, gpu: str, entries):
    """Phase 3: the serving path at full width through score_raw_to_file,
    reading FLAC."""
    from asvspoof2021_air_tpu_torch.data.datasets import (
        ASVspoof2021EvalRawDataset, RawAudioDataset)
    from asvspoof2021_air_tpu_torch.interop.flax_weights import (
        from_flax_variables, random_flax_variables)
    from asvspoof2021_air_tpu_torch.losses.one_class import OCSoftmax
    from asvspoof2021_air_tpu_torch.metrics.eer import eer_from_score_file
    from asvspoof2021_air_tpu_torch.models.ecapa import ECAPA_TDNN
    from asvspoof2021_air_tpu_torch.ops import attn_pool_cuda as ap
    from asvspoof2021_air_tpu_torch.ops import lfcc_cuda as lc
    from asvspoof2021_air_tpu_torch.ops import res2_chain_cuda as rc
    from asvspoof2021_air_tpu_torch.ops.lfcc import LFCC
    from asvspoof2021_air_tpu_torch.scoring import score_raw_to_file
    from asvspoof2021_air_tpu_torch.serving.ecapa_serving import ServingECAPA
    from asvspoof2021_air_tpu_torch.train.frontend import OnDeviceFrontend

    sd = from_flax_variables(random_flax_variables(
        0, C=C, model_scale=8, enc_dim=256), model_scale=8)
    center = np.random.default_rng(1).uniform(-1, 1, (1, 256))
    oc = OCSoftmax(feat_dim=256, r_real=0.9, r_fake=0.2, alpha=20.0,
                   device=DEVICE)
    with torch.no_grad():
        oc.center.copy_(torch.from_numpy(center))
    n_utt = 2 * B + 8
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        written = write_corpus(tmp, n_utt, seed=2, fmt="flac")
        flac_write_s = time.perf_counter() - t0
        wav_root = os.path.join(tmp, "wav_copy")
        write_corpus(wav_root, n_utt, seed=2, fmt="wav")
        ds = RawAudioDataset("LA", tmp, "eval")
        check(ds.audio_dir.endswith("flac") and ds.audio_ext == ".flac",
              "RawAudioDataset does not read the flac/ tree")
        for i in range(len(ds)):
            wav, fname = ds[i][:2]
            check(np.array_equal(
                wav, written[fname].astype(np.float32) / 32768.0),
                f"decoded FLAC {fname} differs from the samples written")
        print(f"FLAC: {n_utt} utterances written in {flac_write_s:.2f} s "
              f"(verbatim subframes) decode to the samples written, exactly")
        fe = OnDeviceFrontend(feat_len=T, padding="repeat", device=DEVICE)
        score = lambda dataset, path, labeled=True: score_raw_to_file(
            sd, dataset, path, labeled=labeled, frontend=fe, loss_module=oc,
            add_loss="ocsoftmax", batch_size=B, dtype=torch.bfloat16,
            device=DEVICE)
        out = os.path.join(tmp, "scores.txt")
        score(ds, out)                          # warm-up (cuBLAS, cuDNN)
        torch.cuda.synchronize()
        lc.launches = rc.launches = ap.launches = 0
        t0 = time.perf_counter()
        score(ds, out)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"B1": lc.launches, "B2": rc.launches, "B3": ap.launches}
        n_batches = -(-n_utt // B)
        print(f"main path launches over {n_batches} batches: {counts}")
        check(counts["B1"] >= n_batches, "B1 did not run on the main path")
        check(counts["B2"] >= 3 * n_batches, "B2 did not run 3x per batch")
        check(counts["B3"] >= n_batches, "B3 did not run on the main path")
        for k, v in counts.items():
            entries[k]["launches_serve"] = v

        with open(out) as f:
            rows = [line.split() for line in f]
        check(len(rows) == n_utt, f"{len(rows)} score lines for {n_utt}")
        check(sorted(r[0] for r in rows)
              == sorted(e.filename for e in ds.entries), "fnames differ")
        scores = np.array([float(r[1]) for r in rows])
        check(bool(np.isfinite(scores).all()), "non-finite scores")
        check(all(len(r) == 3 and r[2] in ("bonafide", "spoof")
                  for r in rows), "malformed score lines")
        print(f"score file: {len(rows)} lines, scores in "
              f"[{scores.min():.4f}, {scores.max():.4f}], "
              f"EER {eer_from_score_file(out):.4f} (random weights)")

        # The same corpus as WAV: the same samples, so the same scores;
        # its host time beside the FLAC one.
        wav_ds = RawAudioDataset("LA", wav_root, "eval")
        wav_out = os.path.join(tmp, "scores_wav.txt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        score(wav_ds, wav_out)
        torch.cuda.synchronize()
        wav_wall = time.perf_counter() - t0
        with open(wav_out) as f:
            wav_rows = [line.split() for line in f]
        check([r[0] for r in wav_rows] == [r[0] for r in rows],
              "the WAV copy's fnames differ")
        diff = max(abs(float(a[1]) - float(b[1]))
                   for a, b in zip(rows, wav_rows))
        print(f"FLAC vs WAV copy of the corpus: largest score difference "
              f"{diff:.3e} (bitwise: {wav_rows == rows})")
        check(diff <= 1e-6, "FLAC and WAV copies of a corpus score apart")

        # An unlabeled ASVspoof2021 eval tree, WAV and FLAC mixed: a
        # 2-column file.
        eval_root = os.path.join(tmp, "LA_eval")
        n_flac = (B + 8) // 2
        for fmt, (lo, hi) in (("flac", (0, n_flac)), ("wav", (n_flac,
                                                              B + 8))):
            os.makedirs(os.path.join(eval_root, fmt))
            for fname in list(written)[lo:hi]:
                shutil.copyfile(os.path.join(
                    tmp if fmt == "flac" else wav_root, "LA",
                    "ASVspoof2019_LA_eval", fmt, f"{fname}.{fmt}"),
                    os.path.join(eval_root, fmt,
                                 f"{fname.replace('_E_', '_X_')}.{fmt}"))
        eval_ds = ASVspoof2021EvalRawDataset(eval_root)
        eval_out = score(eval_ds, os.path.join(tmp, "eval.txt"),
                         labeled=False)
        with open(eval_out) as f:
            eval_rows = [line.split() for line in f]
        check(len(eval_rows) == len(eval_ds) == B + 8
              and all(len(r) == 2 for r in eval_rows)
              and [r[0] for r in eval_rows] == [
                  os.path.splitext(os.path.basename(p))[0]
                  for p in eval_ds.files]
              and np.isfinite([float(r[1]) for r in eval_rows]).all(),
              "malformed unlabeled ASVspoof2021 eval score file")
        print(f"ASVspoof2021 eval tree ({n_flac} FLAC + {B + 8 - n_flac} "
              f"WAV): "
              f"{len(eval_rows)} unlabeled 2-column lines, finite")

        # One full batch: device time of the forward, and the bf16
        # embeddings against the plain f32 path.
        from asvspoof2021_air_tpu_torch.data.pipeline import WaveformIterator
        batch = next(WaveformIterator(ds, B, fe.min_samples(), seed=0,
                                      shuffle=False).epoch())
        wave = {"wave": torch.from_numpy(batch["wave"]).to(DEVICE),
                "length": torch.from_numpy(batch["length"]).to(DEVICE)}
        model = ServingECAPA(sd, dtype=torch.bfloat16, device=DEVICE)
        with torch.inference_mode():
            fwd_ms = time_ms(torch, lambda: model(fe(wave)), iters=5)
            emb, _ = model(fe(wave))
            ref_fe = OnDeviceFrontend(feat_len=T, padding="repeat",
                                      device=DEVICE)
            ref_fe.extractor = LFCC(device=DEVICE)
            ref = ECAPA_TDNN(C=C, model_scale=8, enc_dim=256,
                             device=DEVICE).eval()
            ref.load_state_dict(sd)
            ref_emb, _ = ref(ref_fe(wave))
            profile_device(torch, lambda: model(fe(wave)), fwd_ms, "forward")
        cos = torch.nn.functional.cosine_similarity(emb, ref_emb, dim=1)
        print(f"bf16 vs plain f32 embedding cosine: min {float(cos.min()):.6f}"
              f" mean {float(cos.mean()):.6f} (bar 0.9996)")
        check(bool((cos >= 0.9996).all()), "bf16 embedding cosine < 0.9996")
    per_batch = wall * 1e3 / n_batches
    print(f"main path [{gpu}]: score_raw_to_file {n_utt} utts from FLAC in "
          f"{wall * 1e3:.1f} ms = {per_batch:.2f} ms/batch (host clock, "
          f"FLAC decoding included), {n_utt / wall:.1f} utt/s; the same "
          f"corpus from WAV {wav_wall * 1e3 / n_batches:.2f} ms/batch; "
          f"forward (LFCC + ECAPA, B={B}, bf16) {fwd_ms:.3f} ms/batch = "
          f"{B / fwd_ms * 1e3:.1f} utt/s (CUDA events)")
    return fwd_ms


def write_feature_tree(root: str, n: int, seed: int, labeled: bool,
                       suffix="", shift: float = 0.5):
    """n LFCC-shaped feature files (1, T', 60) .npy with the reference
    cache's names (``suffix`` appended, such as an augmented copy's
    ``_<channel>``; a function of the file's index for one per file): T' =
    750 mostly, some shorter (repeat-padded), some longer (cropped); the
    spoofed ones' first 20 dims shifted by ``shift``. Returns the
    filenames in the dataset's order."""
    g = np.random.default_rng(seed)
    os.makedirs(root)
    names = []
    for i in range(n):
        t = T if i % 9 else (T * 14 // 25 if i % 2 else T * 6 // 5)
        label = i % 2
        x = g.standard_normal((1, t, 60)).astype(np.float32)
        if label:
            x[..., :20] += shift
        if labeled:
            fname = f"LA_D_{1000000 + i}"
            sfx = suffix(i) if callable(suffix) else suffix
            base = (f"{i:06d}_{fname}_{'A0' + str(1 + i % 6) if label else '-'}"
                    f"_{'spoof' if label else 'bonafide'}{sfx}")
        else:
            fname = base = f"LA_E_{2000000 + i}"
            base = f"{i:06d}_{fname}"
        np.save(os.path.join(root, base + ".npy"), x)
        names.append(fname)
    return names


def score_path(torch, gpu: str, entries):
    """Phase 3b: feature-file scoring through the CLI at full width."""
    import ast
    import contextlib
    import dataclasses
    import io

    from asvspoof2021_air_tpu_torch.cli import evaluate_tdcf, score_fusion
    from asvspoof2021_air_tpu_torch.cli import generate_score
    from asvspoof2021_air_tpu_torch.data.datasets import (
        ASVspoof2019FeatureDataset)
    from asvspoof2021_air_tpu_torch.data.pipeline import SequentialIterator
    from asvspoof2021_air_tpu_torch.interop.flax_weights import (
        from_flax_variables, random_flax_variables)
    from asvspoof2021_air_tpu_torch.models.ecapa import ECAPA_TDNN
    from asvspoof2021_air_tpu_torch.ops import attn_pool_cuda as ap
    from asvspoof2021_air_tpu_torch.ops import res2_chain_cuda as rc
    from asvspoof2021_air_tpu_torch.scoring import make_score_fn
    from asvspoof2021_air_tpu_torch.serving.stream import make_scanned_infer
    from asvspoof2021_air_tpu_torch.train.checkpoint import save_checkpoint
    from asvspoof2021_air_tpu_torch.train.loop import (
        TrainConfig, setup_training)

    n_utt = 2 * B + 8
    n_batches = -(-n_utt // B)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)              # the 19* tasks write under ./scores
        try:
            run = os.path.join(tmp, "runs", "sys")
            cfg = TrainConfig(out_fold=run, model="ecapa", add_loss="ang_iso",
                              on_the_fly=True, C=C, feat_len=T)
            state = setup_training(cfg, 1, device=DEVICE)[2]
            sd = from_flax_variables(random_flax_variables(
                5, C=C, model_scale=8, enc_dim=256), model_scale=8)
            state.model.load_state_dict(sd)
            with torch.no_grad():
                state.loss_module.center.copy_(torch.from_numpy(
                    np.random.default_rng(6).uniform(-1, 1, (1, 256))))
            os.makedirs(run)
            with open(os.path.join(run, "args.json"), "w") as f:
                json.dump(dataclasses.asdict(cfg), f)
            save_checkpoint(os.path.join(run, "best.pt"), state)
            ori = os.path.join(tmp, "feats")
            dev_names = write_feature_tree(
                os.path.join(ori, "dev", "LFCC"), n_utt, 7, labeled=True)
            la_names = write_feature_tree(
                os.path.join(tmp, "la_eval", "LFCC"), n_utt, 8,
                labeled=False)
            base = ["--model_folder", os.path.join(tmp, "runs"), "-n", "sys",
                    "--ori_features", ori, "--la_eval",
                    os.path.join(tmp, "la_eval"), "--batch_size", str(B),
                    "--device", DEVICE]

            def cli(task, *extra):
                """Run the CLI; keep its file (the next run rewrites it)."""
                with contextlib.redirect_stdout(io.StringIO()):
                    path = generate_score.main([*base, "-t", task, *extra])
                keep = os.path.join(tmp, f"{task}{'_'.join(extra)}.txt")
                shutil.copyfile(path, keep)
                return keep

            cli("19dev")                            # warm-up
            files, walls, counts = {}, {}, {}
            for dtype in ("float32", "bfloat16"):
                torch.cuda.synchronize()
                rc.launches = ap.launches = 0
                t0 = time.perf_counter()
                for task in ("19dev", "LA"):
                    files[task, dtype] = cli(task, "--dtype", dtype)
                torch.cuda.synchronize()
                walls[dtype] = time.perf_counter() - t0
                counts[dtype] = {"B2": rc.launches, "B3": ap.launches}
                print(f"score path launches, CLI {dtype}, 19dev + LA "
                      f"({2 * n_batches} batches): {counts[dtype]}")
                check(counts[dtype]["B2"] >= 3 * 2 * n_batches,
                      f"B2 did not run 3x per batch in the {dtype} scorer")
                check(counts[dtype]["B3"] >= 2 * n_batches,
                      f"B3 did not run once per batch in the {dtype} scorer")
            for k in ("B2", "B3"):
                entries[k]["launches_score"] = sum(c[k] for c in
                                                   counts.values())
            rc.launches = ap.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for task in ("19dev", "LA"):
                files[task, "scan"] = cli(task, "--scan_batches", "2")
            torch.cuda.synchronize()
            walls["scan"] = time.perf_counter() - t0
            print(f"score path launches, CLI f32 --scan_batches 2 (counted "
                  f"at warm-up and capture, not on replay): "
                  f"{{'B2': {rc.launches}, 'B3': {ap.launches}}}")

            read = lambda p: [line.split() for line in open(p)]
            for task, names in (("19dev", dev_names), ("LA", la_names)):
                rows = {k: read(files[task, k])
                        for k in ("float32", "bfloat16", "scan")}
                for k, r in rows.items():
                    check([x[0] for x in r] == names,
                          f"{task} {k}: fnames differ from the dataset")
                    check(all(len(x) == (3 if task == "19dev" else 2)
                              for x in r), f"{task} {k}: column count")
                    check(bool(np.isfinite([float(x[1]) for x in r]).all()),
                          f"{task} {k}: non-finite scores")
                s = {k: np.array([float(x[1]) for x in r])
                     for k, r in rows.items()}
                bf = float(np.abs(s["bfloat16"] - s["float32"]).max())
                scan = float(np.abs(s["scan"] - s["float32"]).max())
                print(f"{task}: bf16 vs f32 file, largest difference {bf:.3e}"
                      f" (bar 0.03); --scan_batches 2 vs K = 1 {scan:.3e} "
                      f"(bar 1e-6, bitwise: {rows['scan'] == rows['float32']})")
                check(bf <= 0.03, f"{task}: bf16 scores off the f32 ones")
                check(scan <= 1e-6, f"{task}: the scanned file differs")

            # The f32 file against a plain f32 ECAPA (eval, unfused) on
            # the same batches.
            sd_dev = {k: v.to(DEVICE) for k, v in sd.items()}
            ref = ECAPA_TDNN(C=C, model_scale=8, enc_dim=256,
                             device=DEVICE).eval()
            ref.load_state_dict(sd_dev)
            oc = state.loss_module.eval()
            ref_scores = []
            dev_ds = ASVspoof2019FeatureDataset("LA", ori, "dev")
            with torch.no_grad():
                for batch in SequentialIterator(dev_ds, B, T):
                    emb, _ = ref(torch.from_numpy(batch["feat"]).to(DEVICE))
                    score = oc(emb, torch.zeros(B, dtype=torch.long,
                                                device=DEVICE))[1]
                    ref_scores.append(-score.cpu().numpy()[batch["valid"]])
            ref_scores = np.concatenate(ref_scores)
            got = np.array([float(x[1]) for x in read(files["19dev",
                                                            "float32"])])
            err = float(np.abs(got - ref_scores).max())
            print(f"19dev f32 file vs the plain f32 ECAPA on the card: "
                  f"largest difference {err:.3e} (bar 1e-4)")
            check(err <= 1e-4, "f32 scores off the plain f32 model")

            # Evaluate and fuse.
            asv = os.path.join(tmp, "asv.txt")
            g = np.random.default_rng(9)
            with open(asv, "w") as f:
                for i in range(300):
                    kind = ("target", "nontarget", "spoof")[i % 3]
                    f.write(f"LA_{i:04d} {kind} "
                            f"{g.standard_normal() + 2.0 * (i % 3 != 1)}\n")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                evaluate_tdcf.main([files["19dev", "float32"],
                                    "--asv_score_file", asv])
            result = ast.literal_eval(buf.getvalue().strip().splitlines()[-1])
            print(f"evaluate_tdcf on the 19dev f32 file: {result}")
            check(all(np.isfinite(v) for v in result.values()),
                  "EER or min-tDCF not finite")
            for method in ("avg", "wght"):
                buf = io.StringIO()
                out_dir = os.path.join(tmp, f"fuse_{method}")
                with contextlib.redirect_stdout(buf):
                    score_fusion.main(["-i", files["19dev", "float32"],
                                       files["19dev", "bfloat16"], "-m",
                                       method, "-o", out_dir])
                fused_eer = float(buf.getvalue().strip().splitlines()[-1])
                fused = read(os.path.join(out_dir, "avg_fuse_score"))
                print(f"score_fusion -m {method} (f32 + bf16 files): EER "
                      f"{fused_eer:.4f}, {len(fused)} rows")
                check(np.isfinite(fused_eer) and len(fused) == n_utt,
                      f"score_fusion -m {method}")

            # Forward times of the scorer and the f32 forward's profile.
            x = torch.from_numpy(next(iter(SequentialIterator(
                dev_ds, B, T)))["feat"]).to(DEVICE)
            fwd = {}
            for name, dtype in (("f32", torch.float32),
                                ("bf16", torch.bfloat16)):
                fn = make_score_fn(sd, oc, "ang_iso", dtype=dtype,
                                   device=DEVICE)
                fwd[name] = time_ms(torch, lambda: fn(x), iters=10)
                if name == "f32":
                    profile_device(torch, lambda: fn(x), fwd[name],
                                   "f32 feature-file forward")
                    # two batches as one CUDA graph replay, per batch
                    scan = make_scanned_infer(fn, DEVICE)
                    pair = torch.stack([x, x.flip(0)])
                    fwd["f32 graph"] = time_ms(torch, lambda: scan(pair),
                                               iters=10) / 2
        finally:
            os.chdir(cwd)
    for run, what in (("float32", "float32"), ("bfloat16", "bfloat16"),
                      ("scan", "float32 --scan_batches 2")):
        print(f"score path [{gpu}]: cli.generate_score {what}, 19dev + LA "
              f"({2 * n_utt} utts, {2 * n_batches} batches) "
              f"{walls[run] * 1e3 / (2 * n_batches):.2f} ms/batch (host "
              f"clock: model build, checkpoint, .npy reading included)")
    print(f"score path [{gpu}]: make_score_fn forward (B={B}, T={T}, "
          f"C={C}) f32 {fwd['f32']:.3f} ms/batch = "
          f"{B / fwd['f32'] * 1e3:.1f} utt/s, bf16 {fwd['bf16']:.3f} "
          f"ms/batch = {B / fwd['bf16'] * 1e3:.1f} utt/s; f32 in a CUDA "
          f"graph of two batches {fwd['f32 graph']:.3f} ms/batch (CUDA "
          f"events)")


RUNNING = ("running_mean", "running_var")


def step_vs_plain(torch, fresh_state, live, step, fbatch, tag: str):
    """One training step from state ``live`` on ``fbatch`` through B4a/B4b
    against the same step through their plain versions (phases 4, 4b,
    4c, 8b)."""
    runs = []
    # The kernel step twice (its own spread), the plain step, and the
    # plain step with its sums over T reversed (the spread of the same
    # function in another summation order).
    for ctx in (contextlib.nullcontext, contextlib.nullcontext, plain_b4,
                lambda: plain_b4(reverse_t=True)):
        st = fresh_state()
        st.load_state_dict(live)
        with ctx():
            metrics = step(st, fbatch)
        grads = {n: p.grad.clone() for n, p in st.model.named_parameters()}
        grads["center"] = st.loss_module.center.grad.clone()
        runs.append((metrics, grads, {
            k: v.clone() for k, v in st.model.state_dict().items()
            if k.endswith(RUNNING)}))
    (m_k, g_k, s_k), (_, g_k2, _), (m_p, g_p, s_p), (_, g_r, s_r) = runs
    # Loss: rtol 1e-4 (mu, e2 summed in another order, through
    # train-mode BN over the batch and the softplus); in bf16 one bf16
    # ulp, 2^-8, relative: [mu || sigma] is rounded to bf16 before bn5,
    # so where (mu, e2) move by 1e-7 an element may move by an ulp (the
    # logged CE moved by 1.2e-4 on an H100 80GB HBM3 at 700 W). Gradients:
    # each tensor's error norm within max(1e-2, 4 x the plain step's own
    # with its sums over T reversed) of its norm. B4's rounding
    # differences of about 1e-7 grow through sigma = sqrt(e2 - mu^2),
    # which cancels, and the backward of 34 train-mode BNs, into
    # differences of 1e-4 to 3e-3 in every tensor, as large as the
    # reversed plain step's and varying with the trained state; on an
    # H100 80GB HBM3 at 700 W the largest single element reached
    # 4.9e-3 of its tensor's largest, over bars of 1e-3 and then 5e-3
    # of it. A kernel that is wired wrong misses by O(1); B4's own
    # precision is held in phase 2b. The attention BN's bias shifts h2
    # by one vector at every frame, which softmax over T cancels: its
    # gradient is zero but for rounding, so both steps must keep it
    # under 1e-4 of the model's largest gradient element (in f32; bf16
    # rounds h2 after the shift, so there the bar is the plain step's
    # own reading times 4, or 1e-4). Gradients that are exactly zero in
    # the plain step (the Function's db2, the zeros given to fc7 and bn7)
    # are exactly zero in the kernel step. BN statistics: atol 1e-5 and
    # the losses' rtol, or, where larger, what one ulp of the compute
    # type at each of the statistic's inputs moves it by (bn_ulp_bars).
    rtol = 1e-4 if tag == "f32" else 2.0 ** -8
    for k in m_k:
        a, b = float(m_k[k]), float(m_p[k])
        if k.endswith("_acc"):
            # a channel classifier's accuracy over the batch (phase 4c):
            # an argmax among ReLU outputs may flip on one utterance
            print(f"{tag} kernel vs plain step: {k} {a:.5f} vs {b:.5f} "
                  f"(bar one utterance, {1 / B:.5f})")
            check(abs(a - b) <= 1 / B + 1e-7, f"{tag} step {k}: {a} vs {b}")
            continue
        print(f"{tag} kernel vs plain step: {k} {a:.7f} vs {b:.7f} (rtol "
              f"{rtol:.2e})")
        check(abs(a - b) <= rtol * abs(b), f"{tag} step {k}: {a} vs {b}")
    top = max(float(g.abs().max()) for g in g_p.values())
    shift = "attention.2.bias"
    noise_k = float(g_k[shift].abs().max()) / top
    noise_p = float(g_p[shift].abs().max()) / top
    noise_bar = max(1e-4, 4 * noise_p) if tag != "f32" else 1e-4
    print(f"{tag} kernel vs plain step: {shift} gradient {noise_k:.3e} "
          f"(plain {noise_p:.3e}) of the largest gradient element "
          f"{top:.3e} (bar {noise_bar:.1e})")
    check(max(noise_k, noise_p if tag == "f32" else 0) <= noise_bar,
          f"{tag} {shift} gradient is not zero: {noise_k}, {noise_p}")
    names = [n for n in g_p if n != shift and g_p[n].abs().max() > 0]

    def norm_err(got, want):
        """(largest |got - want| / |want| over the tensors, its name)."""
        return max((float((got[n] - want[n]).norm() / want[n].norm()), n)
                   for n in names)

    worst, rev, spread = (norm_err(g_k, g_p), norm_err(g_r, g_p),
                          norm_err(g_k2, g_k))
    elem = max((max_err(g_k[n], g_p[n]) / float(g_p[n].abs().max()), n)
               for n in names)
    bar = max(1e-2, 4 * rev[0])
    print(f"{tag} kernel vs plain step: largest gradient error norm "
          f"{worst[0]:.3e} of its tensor's ({worst[1]}; bar {bar:.3e}), "
          f"largest element {elem[0]:.3e} of its tensor's largest "
          f"({elem[1]}); plain step with sums over T reversed "
          f"{rev[0]:.3e} ({rev[1]}); two kernel steps {spread[0]:.3e} "
          f"({spread[1]})")
    check(worst[0] <= bar, f"{tag} step gradients disagree: {worst}")
    for n in g_p:
        if float(g_p[n].abs().max()) == 0:
            check(bool((g_k[n] == 0).all()), f"{tag} gradient {n} not zero")
    ulp_bars = bn_ulp_bars(torch, st.model, live["model"], s_p,
                           2.0 ** -23 if tag == "f32" else 2.0 ** -7)
    worst_stat = max((max_err(s_k[k], s_p[k]), k) for k in s_p)
    worst_rev = max((max_err(s_r[k], s_p[k]), k) for k in s_p)
    print(f"{tag} kernel vs plain step: BN statistics largest difference "
          f"{worst_stat[0]:.3e} ({worst_stat[1]}; rtol {rtol:.2e}, atol "
          f"1e-5, or one input ulp); plain step with sums over T reversed "
          f"{worst_rev[0]:.3e} ({worst_rev[1]})")
    for k in s_p:
        bar = torch.maximum(rtol * s_p[k].abs() + 1e-5, ulp_bars[k])
        diff = (s_k[k] - s_p[k]).abs()
        if not torch.allclose(s_k[k], s_p[k], rtol=rtol, atol=1e-5):
            print(f"{tag} BN statistic {k}: kernel vs plain "
                  f"{float(diff.max()):.3e} past rtol/atol, within "
                  f"{float(ulp_bars[k].max()):.3e} (one input ulp)"
                  if bool((diff <= bar).all()) else
                  f"{tag} BN statistic {k}: kernel vs plain "
                  f"{float(diff.max()):.3e}, bar {float(bar.max()):.3e}")
        check(bool((diff <= bar).all()),
              f"{tag} step BN statistic {k} disagrees")


def bn_ulp_bars(torch, model, before, after, eps: float):
    """For each running statistic in ``after`` (a model's BN buffers after
    one train-mode step from ``before``), how far it moves when each input
    of the batch statistic moves by one ulp of its type, ``eps`` |x| (bf16:
    2^-7; f32: 2^-23). The batch statistics follow from the update rule
    r' = m r + (1 - m) b: with ms = var + mu^2 and rms = sqrt(ms), the
    mean moves by at most eps rms and the variance by 2 eps (ms + |mu|
    rms); a running statistic by (1 - m) times that. In bf16 a logit that
    moves by one ulp (the sums over T in another order suffice) moves
    bn7's batch mean by ulp / B, past 2^-8 of a mean near zero (on an H100
    80GB HBM3 at 700 W, bn7's running mean 0.0074014 plain, 0.0072549
    reversed and through B4a)."""
    modules = dict(model.named_modules())
    bars = {}
    for k in after:
        name = k.rsplit(".", 1)[0]
        m = modules[name].momentum
        mu, var = ((after[f"{name}.{s}"] - m * before[f"{name}.{s}"]) / (1 - m)
                   for s in RUNNING)
        ms = var.clamp(min=0) + mu * mu
        rms = ms.sqrt()
        d = eps * rms if k.endswith("running_mean") else \
            2 * eps * (ms + mu.abs() * rms)
        bars[k] = (1 - m) * d
    return bars


def check_replay(torch, m_graph, after_graph, m_eager, after_eager,
                 start: int, k: int, what: str,
                 against: str = "eager steps") -> None:
    """K graph-replayed steps against K eager steps (or the K steps
    ``against`` names) from one state: the metrics and every tensor of the
    two states after them (model, center, classifiers, every Adam state),
    rtol 1e-6, atol 1e-9 (phases 4b, 4c)."""
    pairs = [(f"metric {n}", m_graph[n], torch.stack([m[n] for m in
                                                      m_eager]))
             for n in m_graph]
    for part, got in after_graph.items():
        want = after_eager[part]
        if part == "step" or got is None:
            continue
        for n, v in got.items():
            if isinstance(v, dict):         # an Adam state per parameter
                pairs += [(f"{part} {n} {key}", t, want[n][key])
                          for key, t in v.items()]
            else:
                pairs.append((f"{part} {n}", v, want[n]))
    bitwise = sum(torch.equal(a, b) for _, a, b in pairs)
    worst = max((float(((a.double() - b.double()).abs()
                         / b.double().abs().clamp(min=1e-30)).max()),
                 name) for name, a, b in pairs)
    print(f"{k} graph-replayed steps vs {k} {against} of {what}: "
          f"{bitwise} of {len(pairs)} tensors bitwise equal; largest "
          f"relative difference {worst[0]:.3e} ({worst[1]}) (bar rtol "
          f"1e-6, atol 1e-9)")
    check(all(torch.allclose(a, b, rtol=1e-6, atol=1e-9)
              for _, a, b in pairs),
          f"graph replay disagrees with eager steps ({what}): {worst}")
    check(after_graph["step"] == after_eager["step"] == start + k,
          f"graph replay step count ({what})")


def train_path(torch, gpu: str, entries):
    """Phase 4: the training path at full width through ``train``."""
    from asvspoof2021_air_tpu_torch.data.datasets import RawAudioDataset
    from asvspoof2021_air_tpu_torch.data.pipeline import WaveformIterator
    from asvspoof2021_air_tpu_torch.ops import attn_pool_vjp as vj
    from asvspoof2021_air_tpu_torch.ops import lfcc_cuda as lc
    from asvspoof2021_air_tpu_torch.train.checkpoint import (
        restore_checkpoint)
    from asvspoof2021_air_tpu_torch.train.frontend import OnDeviceFrontend
    from asvspoof2021_air_tpu_torch.train.loop import (
        TrainConfig, setup_training, train)

    n_steps = 4
    with tempfile.TemporaryDirectory() as tmp:
        write_corpus(tmp, n_steps * B, seed=3, part="train")
        write_corpus(tmp, B, seed=4, part="dev")
        out = os.path.join(tmp, "run")
        cfg = TrainConfig(out_fold=out, path_to_database=tmp, model="ecapa",
                          add_loss="ang_iso", on_the_fly=True, batch_size=B,
                          feat_len=T, num_epochs=2, ratio=1.0, C=C)
        fresh_state = lambda: setup_training(cfg, n_steps, device=DEVICE)[2]
        init = fresh_state().state_dict()

        torch.cuda.synchronize()
        lc.launches = vj.fwd_launches = vj.bwd_launches = 0
        t0 = time.perf_counter()
        summary, state = train(cfg, device=DEVICE, return_state=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"B1": lc.launches, "B4a": vj.fwd_launches,
                  "B4b": vj.bwd_launches}
        steps = cfg.num_epochs * n_steps
        print(f"training path launches over {steps} steps and "
              f"{cfg.num_epochs} dev passes: {counts}")
        check(counts["B1"] >= steps + cfg.num_epochs,
              "B1 did not run on every training step and dev batch")
        check(counts["B4a"] >= steps + cfg.num_epochs,
              "B4a did not run on every training step and dev batch")
        check(counts["B4b"] >= steps, "B4b did not run on every step")
        for k, v in counts.items():
            entries[k]["launches_train"] = v
        print(f"train summary: {summary}")

        with open(os.path.join(out, "train_loss.log")) as f:
            rows = [line.split() for line in f.readlines()[1:]]
        losses = np.array([float(r[2]) for r in rows])
        epochs = np.array([int(r[0]) for r in rows])
        check(len(rows) == steps, f"{len(rows)} train_loss.log rows")
        check(bool(np.isfinite(losses).all()), f"non-finite loss: {losses}")
        first, last = losses[epochs == 0].mean(), losses[epochs == 1].mean()
        print(f"ang_iso loss per step: {np.round(losses, 5).tolist()}; "
              f"epoch means {first:.5f} -> {last:.5f}")
        check(last < first, "the ang_iso loss did not fall over the run")
        with open(os.path.join(out, "dev_loss.log")) as f:
            dev_rows = f.readlines()[1:]
        check(len(dev_rows) == cfg.num_epochs, "dev_loss.log rows")
        for name in ("args.json", "train_meta.json", "best.pt",
                     os.path.join("checkpoint", "1.pt"),
                     os.path.join("checkpoint", "2.pt")):
            check(os.path.exists(os.path.join(out, name)), f"no {name}")

        live = state.state_dict()
        moved = {k for k, v in live["model"].items()
                 if not torch.equal(v, init["model"][k])}
        stats = {k for k in live["model"] if k.endswith(RUNNING)}
        check(stats <= moved, f"BN statistics that did not move: "
                              f"{sorted(stats - moved)}")
        # Zero-initialized parameters that the loss gives no gradient stay
        # at zero: the logits' biases (the logits feed only the logged CE)
        # and the attention conv's bias (softmax over T cancels it).
        still = set(live["model"]) - moved
        check(still == {"fc7.bias", "bn7.bias", "attention.3.bias"},
              f"unexpected unchanged parameters: {sorted(still)}")
        check(not torch.equal(live["loss_module"]["center"],
                              init["loss_module"]["center"]),
              "the center did not move")
        print(f"moved: {len(moved)} of {len(live['model'])} model tensors "
              f"(all BN statistics), the center; unchanged: {sorted(still)}")

        back = restore_checkpoint(os.path.join(out, "checkpoint", "2.pt"),
                                  fresh_state()).state_dict()
        check(back["step"] == live["step"] == steps, "restored step")
        for part in ("model", "loss_module"):
            for k, v in live[part].items():
                check(torch.equal(back[part][k], v), f"restored {part} {k}")
        check(set(back["optimizer"]) == set(live["optimizer"]),
              "restored optimizer names")
        for name, st in live["optimizer"].items():
            for k, v in st.items():
                check(torch.equal(back["optimizer"][name][k].to(v.device), v),
                      f"restored Adam {name} {k}")
        print("checkpoint 2.pt restores to the live state exactly")

        # One step through B4a/B4b against the same step through their
        # plain versions: same state, same features.
        fe = OnDeviceFrontend(feat_len=T, device=DEVICE)
        raw = next(WaveformIterator(RawAudioDataset("LA", tmp, "train"), B,
                                    fe.min_samples(), seed=5).epoch())
        wave = {k: torch.from_numpy(raw[k]) for k in ("wave", "length",
                                                      "label")}
        with torch.no_grad():
            feats = fe(wave)
        step_vs_plain(torch, fresh_state, live,
                      setup_training(cfg, n_steps, device=DEVICE)[3],
                      {"feat": feats, "label": wave["label"]}, "f32")

        # Time and profile the full step (waveforms in, B1 included).
        full_step = setup_training(cfg, n_steps, frontend=fe,
                                   device=DEVICE)[3]
        st = fresh_state()
        st.load_state_dict(live)
        torch.cuda.reset_peak_memory_stats()
        step_ms = time_ms(torch, lambda: full_step(st, wave), iters=5)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        profile_device(torch, lambda: full_step(st, wave), step_ms,
                       "training step")
    print(f"training path [{gpu}]: train() {steps} steps + "
          f"{cfg.num_epochs} dev passes in {wall:.2f} s (host clock, wav "
          f"reading, checkpoints and first-call set-up included); one step "
          f"(B={B}, T={T}, C={C}, f32, TF32 off) {step_ms:.3f} ms = "
          f"{B / step_ms * 1e3:.1f} utt/s (CUDA events); peak memory "
          f"{peak:.2f} GiB")
    return step_ms, peak


class Repeat:
    """A dataset's items ``n`` times over (item i is item i mod len)."""

    def __init__(self, data, n: int):
        self.data, self.n = data, n

    def __len__(self):
        return self.n * len(self.data)

    def __getitem__(self, i):
        return self.data[i % len(self.data)]


def graph_launches(steps_per_epoch: int, k: int, epochs: int):
    """(launches counted, launches run) of a kernel that runs once per
    training step of ``train`` with ``steps_per_call`` k: the first call
    runs its k steps eagerly, then captures them (k counted, none run);
    each later call replays them (k run, none counted); the epoch tails
    run eagerly."""
    calls, tail = divmod(steps_per_epoch, k)
    replays = calls * epochs - 1
    return 2 * k + tail * epochs, k + k * replays + tail * epochs, replays


def train_bf16_path(torch, gpu: str, entries, f32_ms: float):
    """Phase 4b: bf16 training from cached, augmented LFCC feature files
    with 8 steps per call as a CUDA graph, resume, the eval-set EER; an
    on-the-fly bf16 run of the same kind; the graph against eager steps;
    the bf16 step's kernels against their plain versions; times. Returns
    the on-the-fly bf16 K = 8 graph's ms a step."""
    import dataclasses

    from asvspoof2021_air_tpu_torch.data.datasets import (
        ASVspoof2019FeatureDataset, AugmentedFeatureDataset,
        RawAudioDataset)
    from asvspoof2021_air_tpu_torch.data.pipeline import (
        RatioMixIterator, WaveformIterator)
    from asvspoof2021_air_tpu_torch.models.ecapa import ECAPA_TDNN
    from asvspoof2021_air_tpu_torch.ops import attn_pool_vjp as vj
    from asvspoof2021_air_tpu_torch.ops import lfcc_cuda as lc
    from asvspoof2021_air_tpu_torch.train.checkpoint import (
        restore_checkpoint)
    from asvspoof2021_air_tpu_torch.train.frontend import OnDeviceFrontend
    from asvspoof2021_air_tpu_torch.train.loop import (
        TrainConfig, setup_training, train)
    from asvspoof2021_air_tpu_torch.train.steps import make_multi_step

    K, n_ori, n_aug, n_eval = 8, 5 * B, 5 * B // 2, B + B // 2 + 4
    spe = -(-n_ori // (B // 2))           # ratio 0.5: 10 steps an epoch
    channel = "amr[br=5k9]"
    with tempfile.TemporaryDirectory() as tmp:
        feats, aug = os.path.join(tmp, "feats"), os.path.join(tmp, "aug")
        for root, part, n, seed, sfx in (
                (feats, "train", n_ori, 20, ""), (feats, "dev", B, 21, ""),
                (feats, "eval", n_eval, 22, ""),
                (aug, "train", n_aug, 23, f"_{channel}"),
                (aug, "dev", B, 24, f"_{channel}")):
            write_feature_tree(os.path.join(root, part, "LFCC"), n, seed,
                               True, sfx)
        out = os.path.join(tmp, "run")
        cfg = TrainConfig(
            out_fold=out, path_to_features=feats, path_to_aug_features=aug,
            LA_aug=True, ratio=0.5, model="ecapa", add_loss="ang_iso",
            batch_size=B, feat_len=T, num_epochs=2, C=C,
            compute_dtype="bfloat16", steps_per_call=K, test_on_eval=True,
            auto_resume=True)
        eval_set = ASVspoof2019FeatureDataset("LA", feats, "eval")
        init = setup_training(cfg, spe, device=DEVICE)[2].state_dict()

        # ---- the main path: train() bf16, K = 8, LA_aug features ----
        torch.cuda.synchronize()
        lc.launches = vj.fwd_launches = vj.bwd_launches = 0
        t0 = time.perf_counter()
        summary, state = train(cfg, eval_set=eval_set, device=DEVICE,
                               return_state=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"B1": lc.launches, "B4a": vj.fwd_launches,
                  "B4b": vj.bwd_launches}
        E = cfg.num_epochs
        counted, run, replays = graph_launches(spe, K, E)
        # dev batches (64 original, 64 augmented at ratio 0.5) and eval
        # batches
        evals = E * (2 + -(-len(eval_set) // B))
        print(f"bf16 K={K} training path launches over {E * spe} steps "
              f"({E} x ({spe // K} call of {K} + a tail of {spe % K}); "
              f"one capture, {replays} replay(s)), {E} dev and {E} eval "
              f"passes: {counts}; B4b counted {counted} (warm-up {K} + "
              f"capture {K} + tails), run on the card {run} (= capture "
              f"{K} x {replays} replays + {counted - K} eager)")
        check(counts == {"B1": 0, "B4a": counted + evals, "B4b": counted},
              f"bf16 K={K} launch counts {counts}, expected B4a "
              f"{counted + evals}, B4b {counted}")
        for k, v in counts.items():
            entries[k]["launches_train_bf16"] = v
        print(f"bf16 train summary: {summary}")
        with open(os.path.join(out, "train_loss.log")) as f:
            rows = [line.split() for line in f.readlines()[1:]]
        losses = np.array([float(r[2]) for r in rows])
        check([(int(r[0]), int(r[1])) for r in rows]
              == [(e, i) for e in range(E) for i in range(spe)],
              "train_loss.log steps")
        check(bool(np.isfinite(losses).all()), f"non-finite loss: {losses}")
        print(f"bf16 ang_iso loss per step: {np.round(losses, 5).tolist()}")
        with open(os.path.join(out, "test_loss.log")) as f:
            test_rows = f.readlines()[1:]
        check(len(test_rows) == E, f"test_loss.log rows {test_rows}")
        print(f"test_on_eval: {[r.strip() for r in test_rows]}")
        live = state.state_dict()
        moved = {k for k, v in live["model"].items()
                 if not torch.equal(v, init["model"][k])}
        stats = {k for k in live["model"] if k.endswith(RUNNING)}
        check(stats <= moved, "bf16: BN statistics that did not move: "
                              f"{sorted(stats - moved)}")
        still = set(live["model"]) - moved
        check(still == {"fc7.bias", "bn7.bias", "attention.3.bias"},
              f"bf16: unexpected unchanged parameters: {sorted(still)}")
        check(not torch.equal(live["loss_module"]["center"],
                              init["loss_module"]["center"]),
              "bf16: the center did not move")
        print(f"bf16: moved {len(moved)} of {len(live['model'])} model "
              f"tensors (all BN statistics), the center")

        # ---- resume: auto_resume continues at epoch 3 from 2.pt;
        # continue_training loads best.pt ----
        summary3, state3 = train(dataclasses.replace(cfg, num_epochs=3),
                                 eval_set=eval_set, device=DEVICE,
                                 return_state=True)
        with open(os.path.join(out, "train_loss.log")) as f:
            rows = [line.split() for line in f.readlines()[1:]]
        check(summary3["epochs"] == 3 and state3.step == 3 * spe
              and [int(r[0]) for r in rows[-spe:]] == [2] * spe
              and len(rows) == 3 * spe,
              f"auto_resume: {summary3}, step {state3.step}, {len(rows)} "
              f"rows")
        print(f"auto_resume: epoch 3 of 3 from checkpoint/2.pt, step "
              f"{2 * spe} -> {state3.step}; {summary3}")
        _, cont = train(dataclasses.replace(
            cfg, continue_training=True, auto_resume=False, num_epochs=0),
            eval_set=eval_set, device=DEVICE, return_state=True)
        best = restore_checkpoint(os.path.join(out, "best.pt"))
        check(all(torch.equal(v.cpu(), best["model"][k]) for k, v in
                  cont.model.state_dict().items())
              and cont.step == best["step"],
              "continue_training did not load best.pt")
        print(f"continue_training: best.pt loaded (step {cont.step})")
        live = state3.state_dict()
        del state, state3, cont

        # ---- K graph-replayed steps against K eager steps of the same
        # capturable step, from one state, with cuDNN's deterministic
        # algorithms (some of its default ones sum with atomics) ----
        train_ds = AugmentedFeatureDataset(feats, aug, "train")
        it = RatioMixIterator(train_ds, B, 0.5, feat_len=T, seed=7,
                              steps_per_epoch=2 * K).epoch()
        fb = [{k: torch.from_numpy(b[k]) for k in ("feat", "label")}
              for b in it]
        stack = lambda bs: {k: torch.stack([b[k] for b in bs])
                            for k in bs[0]}
        torch.backends.cudnn.deterministic = True
        _, _, st, step, _ = setup_training(cfg, spe, device=DEVICE)
        st.load_state_dict(live)
        multi = make_multi_step(step, K)
        multi(st, stack(fb[:K]))                  # eager K steps, capture
        st.load_state_dict(live)
        m_graph = multi(st, stack(fb[K:]))         # replay
        after_graph = copy.deepcopy(st.state_dict())
        st.load_state_dict(live)
        m_eager = [step(st, b) for b in fb[K:]]
        after_eager = st.state_dict()
        torch.backends.cudnn.deterministic = False
        check_replay(torch, m_graph, after_graph, m_eager, after_eager,
                     live["step"], K, "the same capturable step")
        del st, multi

        # ---- one bf16 step through B4a/B4b against their plain
        # versions, and the bf16 forward against f32 ----
        k1 = dataclasses.replace(cfg, steps_per_call=1)
        fbatch = {"feat": fb[0]["feat"].to(DEVICE), "label": fb[0]["label"]}
        step_vs_plain(torch, lambda: setup_training(k1, spe,
                                                    device=DEVICE)[2],
                      live, setup_training(k1, spe, device=DEVICE)[3],
                      fbatch, "bf16")
        embs = []
        for dtype in (None, torch.bfloat16):
            m = ECAPA_TDNN(C=C, fused_pool=True, dtype=dtype,
                           device=DEVICE).eval()
            m.load_state_dict(live["model"])
            with torch.no_grad():
                embs.append(m(fbatch["feat"])[0])
        cos = torch.nn.functional.cosine_similarity(embs[1], embs[0], dim=1)
        print(f"bf16 vs f32 eval forward of the trained weights: embedding "
              f"cosine min {float(cos.min()):.6f} (bar 0.9996)")
        check(bool((cos >= 0.9996).all()), f"bf16 embeddings: {cos.min()}")
        del m, embs

        # ---- on the fly, bf16, K = 8: B1 replays from the graph too ----
        write_corpus(tmp, B, seed=8, part="train")
        write_corpus(tmp, B, seed=9, part="dev")
        n_otf = 18
        otf = TrainConfig(
            out_fold=os.path.join(tmp, "otf"), path_to_database=tmp,
            on_the_fly=True, ratio=1.0, model="ecapa", add_loss="ang_iso",
            batch_size=B, feat_len=T, num_epochs=1, C=C,
            compute_dtype="bfloat16", steps_per_call=K, profile=True)
        raw_train = Repeat(RawAudioDataset("LA", tmp, "train"), n_otf)
        torch.cuda.synchronize()
        lc.launches = vj.fwd_launches = vj.bwd_launches = 0
        summary = train(otf, train_set=raw_train,
                        dev_set=RawAudioDataset("LA", tmp, "dev"),
                        device=DEVICE)
        torch.cuda.synchronize()
        counts = {"B1": lc.launches, "B4a": vj.fwd_launches,
                  "B4b": vj.bwd_launches}
        counted, run, replays = graph_launches(n_otf, K, 1)
        print(f"on the fly, bf16, K={K}: {n_otf} steps (one capture, "
              f"{replays} replay(s)) and one dev batch: launches {counts}; "
              f"per kernel of the step counted {counted}, run {run}")
        check(counts == {"B1": counted + 1, "B4a": counted + 1,
                         "B4b": counted},
              f"on-the-fly bf16 launch counts {counts}")
        for k, v in counts.items():
            entries[k]["launches_train_bf16_otf"] = v
        with open(os.path.join(otf.out_fold, "train_loss.log")) as f:
            losses = np.array([float(line.split()[2])
                               for line in f.readlines()[1:]])
        check(len(losses) == n_otf and bool(np.isfinite(losses).all()),
              f"on-the-fly bf16 losses {losses}")
        trace_path = os.path.join(otf.out_fold, "profile", "trace.json")
        with open(trace_path) as f:
            traced = [e.get("name", "") for e in json.load(f)["traceEvents"]
                      if e.get("cat") == "kernel"]
        check(any("softmax_stats_bwd" in n for n in traced),
              "the profile of the first steps holds no B4b kernel")
        print(f"on-the-fly bf16 summary: {summary}; profile of the first "
              f"{min(20, n_otf)} steps (capture and replay inside): "
              f"{len(traced)} kernel events, {os.path.getsize(trace_path)} "
              f"bytes")

        # ---- times: bf16 K = 1 and K = 8, on the fly and from features --
        fe = OnDeviceFrontend(feat_len=T, device=DEVICE)
        waves = [{k: torch.from_numpy(b[k]) for k in ("wave", "length",
                                                      "label")}
                 for b in WaveformIterator(raw_train, B, fe.min_samples(),
                                           seed=5, steps_per_epoch=K).epoch()]
        times = {}
        for name, batches, frontend in (("on the fly", waves, fe),
                                        ("from features", fb[:K], None)):
            k1o = dataclasses.replace(k1, on_the_fly=frontend is not None)
            _, _, st, step, _ = setup_training(k1o, spe, frontend=frontend,
                                               device=DEVICE)
            st.load_state_dict(live)
            torch.cuda.reset_peak_memory_stats()
            ms1 = time_ms(torch, lambda: step(st, batches[0]), iters=5)
            peak1 = torch.cuda.max_memory_allocated() / 2 ** 30
            if frontend is not None:
                profile_device(torch, lambda: step(st, batches[0]), ms1,
                               "bf16 training step")
            del st
            _, _, st, step, _ = setup_training(
                dataclasses.replace(k1o, steps_per_call=K), spe,
                frontend=frontend, device=DEVICE)
            st.load_state_dict(live)
            multi = make_multi_step(step, K)
            stacked = stack(batches)
            torch.cuda.reset_peak_memory_stats()
            ms8 = time_ms(torch, lambda: multi(st, stacked), iters=3,
                          warmup=2) / K
            peak8 = torch.cuda.max_memory_allocated() / 2 ** 30
            if frontend is not None:
                profile_device(torch, lambda: multi(st, stacked), K * ms8,
                               f"bf16 {K}-step graph replay")
            del st, multi
            times[name] = (ms1, peak1, ms8, peak8)
    print(f"bf16 training path [{gpu}]: train() {E * spe} steps, {E} dev "
          f"and {E} eval passes in {wall:.2f} s (host clock, .npy reading, "
          f"checkpoints, first-call set-up and the capture included)")
    for name, (ms1, peak1, ms8, peak8) in times.items():
        print(f"training step {name} [{gpu}] (B={B}, T={T}, C={C}; CUDA "
              f"events, host-to-device copies of the batches included): "
              + (f"f32 K=1 {f32_ms:.3f} ms = {B / f32_ms * 1e3:.1f} utt/s; "
                 if name == "on the fly" else "")
              + f"bf16 K=1 {ms1:.3f} ms = {B / ms1 * 1e3:.1f} utt/s (peak "
              f"{peak1:.2f} GiB); bf16 K={K} graph {ms8:.3f} ms/step = "
              f"{B / ms8 * 1e3:.1f} utt/s (peak {peak8:.2f} GiB)")
    return times["on the fly"][2]


def _codes(torch, x, law: str):
    """The 8-bit code nearest to each sample of a G.711 law's output, in
    float64."""
    from asvspoof2021_air_tpu_torch.ops import dsp

    x = x.double().clamp(-1, 1)
    if law == "u":
        y = torch.sign(x) * torch.log1p(255 * x.abs()) / np.log1p(255)
        return torch.floor((y + 1) / 2 * 255 + 0.5)
    return torch.round(dsp.alaw_encode(x) * 127)


def augmenter_vs_cpu(torch, augmenter, cpu_augmenter, wave, draws) -> float:
    """The augmenter on the card against the same augmenter on the CPU
    with the same draws: the family and IR indices equal; per utterance,
    1e-5, or for a G.711 family 99.9% of the samples within 1e-5 and
    every other one code step away (an FFT's rounding can move a sample
    across a code boundary). u-law's boundary between codes 127 and 128
    is 0 itself, so a silent stretch (the zero padding of a short
    utterance, filtered to FFT rounding noise) takes the sign of that
    noise: such samples are counted apart from the 99.9%, and held to the
    one code step. Returns the largest difference."""
    got, fam, ir = augmenter(wave, draws, apply_ir=True)
    want, fam_c, ir_c = cpu_augmenter(
        wave.cpu(), {k: v.cpu() for k, v in draws.items()}, apply_ir=True)
    check(torch.equal(fam.cpu(), fam_c) and torch.equal(ir.cpu(), ir_c),
          "augmenter: family or IR indices differ between card and CPU")
    got = got.cpu()
    worst, worst_linear, flips, silent = 0.0, 0.0, 0, 0
    for i, f in enumerate(fam_c.long().tolist()):
        law = augmenter.families[f].law
        diff = (got[i] - want[i]).abs()
        worst = max(worst, float(diff.max()))
        if law is None:
            worst_linear = max(worst_linear, float(diff.max()))
            check(float(diff.max()) <= 1e-5,
                  f"augmenter utterance {i} ({augmenter.families[f].name}) "
                  f"differs by {float(diff.max())}")
            continue
        far = diff > 1e-5
        c_got, c_want = _codes(torch, got[i], law), _codes(torch, want[i], law)
        step = (c_got - c_want).abs()
        zero = (far & (torch.minimum(c_got, c_want) == 127)
                & (torch.maximum(c_got, c_want) == 128)) if law == "u" \
            else torch.zeros_like(far)
        flips += int((far & ~zero).sum())
        silent += int(zero.sum())
        check(float((far & ~zero).float().mean()) <= 1e-3
              and bool((step[far] <= 1).all()),
              f"augmenter utterance {i} ({augmenter.families[f].name}): "
              f"{int(far.sum())} samples past 1e-5 ({int(zero.sum())} of "
              f"them across u-law's zero), code steps "
              f"{step[far].max() if far.any() else 0}")
    names = sorted({augmenter.families[f].name
                    for f in fam_c.long().tolist()})
    print(f"augmenter on the card vs the CPU, same draws, "
          f"{tuple(wave.shape)}, families drawn {names}: largest difference "
          f"{worst:.3e} ({worst_linear:.3e} without G.711; bar 1e-5), "
          f"{flips} G.711 samples one code step apart, and {silent} u-law "
          f"samples of silence on the two sides of zero")
    return worst


def train_adv_path(torch, gpu: str, entries):
    """Phase 4c: channel-robust training at full width. ADV_AUG in bf16 at
    K = 8 from an LA_aug tree (the gate flipping between replays), in f32
    at K = 1 with two classifiers from a LAPA_aug tree, and the channel
    augmenter on the fly in bf16 at K = 8; the graphs against eager steps,
    the ADV step's kernels against their plain versions, the augmenter on
    the card against the CPU; times."""
    import dataclasses

    from asvspoof2021_air_tpu_torch.data import protocol as proto
    from asvspoof2021_air_tpu_torch.data.datasets import (
        AugmentedFeatureDataset, RawAudioDataset)
    from asvspoof2021_air_tpu_torch.data.pipeline import (
        RatioMixIterator, WaveformIterator)
    from asvspoof2021_air_tpu_torch.ops import attn_pool_vjp as vj
    from asvspoof2021_air_tpu_torch.ops import lfcc_cuda as lc
    from asvspoof2021_air_tpu_torch.ops.augment import (
        ChannelAugmenter, synthetic_ir_bank)
    from asvspoof2021_air_tpu_torch.train.checkpoint import (
        restore_checkpoint)
    from asvspoof2021_air_tpu_torch.train.frontend import OnDeviceFrontend
    from asvspoof2021_air_tpu_torch.train.loop import (
        TrainConfig, setup_training, train)
    from asvspoof2021_air_tpu_torch.train.steps import make_multi_step

    K, n_ori, n_aug, E = 8, 5 * B, 5 * B // 2, 2
    spe = -(-n_ori // (B // 2))           # ratio 0.5: 10 steps an epoch
    channels, devices = proto.LA_CHANNELS[1:], proto.DEVICES[:-1]
    channel = lambda i: f"_{channels[i % len(channels)]}"
    both = lambda i: f"{channel(i)}_{devices[i % len(devices)]}"
    stack = lambda bs: {k: torch.stack([b[k] for b in bs]) for k in bs[0]}

    def zero():
        lc.launches = vj.fwd_launches = vj.bwd_launches = 0

    counts = lambda: {"B1": lc.launches, "B4a": vj.fwd_launches,
                      "B4b": vj.bwd_launches}
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        feats, aug, aug_pa = (os.path.join(tmp, d)
                              for d in ("feats", "aug", "aug_pa"))
        for root, part, n, seed, sfx in (
                (feats, "train", n_ori, 40, ""), (feats, "dev", B, 41, ""),
                (aug, "train", n_aug, 42, channel),
                (aug, "dev", B, 43, channel),
                (aug_pa, "train", n_aug, 44, both),
                (aug_pa, "dev", B, 45, both)):
            write_feature_tree(os.path.join(root, part, "LFCC"), n, seed,
                               True, sfx)

        # ---- the main path: train() ADV_AUG, bf16, K = 8, LA_aug ----
        cfg = TrainConfig(
            out_fold=os.path.join(tmp, "adv"), path_to_features=feats,
            path_to_aug_features=aug, LA_aug=True, ADV_AUG=True, ratio=0.5,
            model="ecapa", add_loss="ang_iso", batch_size=B, feat_len=T,
            num_epochs=E, C=C, compute_dtype="bfloat16", steps_per_call=K,
            auto_resume=True)
        init = setup_training(cfg, spe, device=DEVICE)[2].state_dict()
        torch.cuda.synchronize()
        zero()
        t0 = time.perf_counter()
        summary, state = train(cfg, device=DEVICE, return_state=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        counted, run, replays = graph_launches(spe, K, E)
        evals = E * 2                     # 64 original + 64 augmented dev
        print(f"ADV_AUG bf16 K={K} training path launches over {E * spe} "
              f"steps (one capture, {replays} replay(s); the gate 0 in "
              f"epoch 0, 1 in epoch 1) and {E} dev passes: {got}; B4b "
              f"counted {counted}, run on the card {run}")
        check(got == {"B1": 0, "B4a": counted + evals, "B4b": counted},
              f"ADV_AUG launch counts {got}, expected B4a "
              f"{counted + evals}, B4b {counted}")
        for k, v in got.items():
            entries[k]["launches_train_adv"] = v
        print(f"ADV_AUG train summary: {summary}")
        with open(os.path.join(cfg.out_fold, "train_loss.log")) as f:
            rows = [line.split() for line in f.readlines()[1:]]
        losses = np.array([float(r[2]) for r in rows])
        check(len(rows) == E * spe and bool(np.isfinite(losses).all()),
              f"ADV_AUG train_loss.log: {len(rows)} rows, {losses}")
        ep1 = restore_checkpoint(os.path.join(cfg.out_fold, "checkpoint",
                                              "1.pt"))
        check(all(not torch.equal(v, init["classifier"][k].cpu())
                  for k, v in ep1["classifier"].items()),
              "the channel classifier did not move in epoch 0")
        live = state.state_dict()
        print(f"ADV_AUG: the classifier over {len(proto.LA_CHANNELS)} LA "
              f"channels moved in epoch 0 (every tensor); ang_iso loss per "
              f"step: {np.round(losses, 5).tolist()}")
        # auto_resume with no epoch left restores the classifier
        _, again = train(cfg, device=DEVICE, return_state=True)
        back = again.state_dict()
        check(back["step"] == live["step"]
              and all(torch.equal(v, live["classifier"][k])
                      for k, v in back["classifier"].items())
              and all(torch.equal(t, live["clf_optimizer"][n][k])
                      for n, st_ in back["clf_optimizer"].items()
                      for k, t in st_.items()),
              "auto_resume did not restore the classifier and its Adam")
        print(f"auto_resume: the classifier and its Adam state restored "
              f"from checkpoint/{E}.pt (step {back['step']})")
        del state, again

        # ---- 8 replayed steps vs 8 eager steps at gate 0 and gate 1 ----
        train_ds = AugmentedFeatureDataset(feats, aug, "train")
        it = RatioMixIterator(train_ds, B, 0.5, feat_len=T, seed=7,
                              steps_per_epoch=3 * K).epoch()
        fb = [{k: torch.from_numpy(b[k]) for k in ("feat", "label",
                                                    "channel")}
              for b in it]
        torch.backends.cudnn.deterministic = True
        _, _, st, step, _ = setup_training(cfg, spe, device=DEVICE)
        st.load_state_dict(live)
        multi = make_multi_step(step, K)
        multi(st, stack(fb[:K]))          # eager K steps, capture at gate 0
        for gate, part in ((0.0, fb[K:2 * K]), (1.0, fb[2 * K:])):
            st.load_state_dict(live)
            m_graph = multi(st, stack(part), None, gate)
            after_graph = copy.deepcopy(st.state_dict())
            st.load_state_dict(live)
            m_eager = [step(st, b, None, gate) for b in part]
            after_eager = st.state_dict()
            check_replay(torch, m_graph, after_graph, m_eager, after_eager,
                         live["step"], K, f"the ADV_AUG step at gate {gate}")
            for k in ("adv_loss", "clf_loss", "clf_acc", "adv_acc"):
                check(bool(torch.isfinite(m_graph[k]).all()),
                      f"replayed {k} {m_graph[k]}")
            check(torch.allclose(m_graph["total_loss"], m_graph["ang_iso"]
                                 + gate * m_graph["adv_loss"], rtol=1e-6),
                  f"the replay at gate {gate} did not add gate x adv_loss")
            print(f"replay at gate {gate}: adv_loss "
                  f"{np.round(m_graph['adv_loss'].cpu().numpy(), 4).tolist()}"
                  f", clf_loss "
                  f"{np.round(m_graph['clf_loss'].cpu().numpy(), 4).tolist()}"
                  f", clf_acc {m_graph['clf_acc'].cpu().numpy().tolist()}, "
                  f"total = ang_iso + {gate} x adv_loss")
        torch.backends.cudnn.deterministic = False
        del st, multi

        # ---- one ADV bf16 step (gate 1) through B4a/B4b vs plain ----
        k1 = dataclasses.replace(cfg, steps_per_call=1)
        fbatch = {"feat": fb[0]["feat"].to(DEVICE), "label": fb[0]["label"],
                  "channel": fb[0]["channel"]}
        step1 = setup_training(k1, spe, device=DEVICE)[3]
        step_vs_plain(torch, lambda: setup_training(k1, spe,
                                                    device=DEVICE)[2],
                      live, lambda s, b: step1(s, b, None, 1.0), fbatch,
                      "bf16 ADV_AUG")

        # ---- ADV_AUG, f32, K = 1, two classifiers (LAPA_aug) ----
        dual = TrainConfig(
            out_fold=os.path.join(tmp, "adv_pa"), path_to_features=feats,
            path_to_aug_features=aug_pa, LAPA_aug=True, ADV_AUG=True,
            ratio=0.5, model="ecapa", add_loss="ang_iso", batch_size=B,
            feat_len=T, num_epochs=E, C=C)
        init = setup_training(dual, spe, device=DEVICE)[2].state_dict()
        torch.cuda.synchronize()
        zero()
        summary, state = train(dual, device=DEVICE, return_state=True)
        torch.cuda.synchronize()
        got = counts()
        check(got == {"B1": 0, "B4a": E * spe + evals, "B4b": E * spe},
              f"dual-classifier launch counts {got}")
        for k, v in got.items():
            entries[k]["launches_train_adv_dual"] = v
        end = state.state_dict()
        for name, n in (("classifier", len(proto.LA_CHANNELS)),
                        ("classifier2", len(proto.DEVICES))):
            check(all(not torch.equal(v, init[name][k])
                      for k, v in end[name].items())
                  and end[name]["classifier.3.bias"].numel() == n,
                  f"{name} did not train over {n} classes")
        with open(os.path.join(dual.out_fold, "train_loss.log")) as f:
            losses = np.array([float(r.split()[2])
                               for r in f.readlines()[1:]])
        check(len(losses) == E * spe and bool(np.isfinite(losses).all()),
              f"dual-classifier losses {losses}")
        print(f"ADV_AUG f32 K=1, LAPA_aug: {E * spe} steps, launches {got}; "
              f"both classifiers ({len(proto.LA_CHANNELS)} channels, "
              f"{len(proto.DEVICES)} devices) moved; {summary}")
        del state

        # ---- from features, bf16, K = 8: times with and without ADV ----
        for name, c in (("ADV_AUG", cfg),
                        ("no ADV_AUG", dataclasses.replace(cfg,
                                                           ADV_AUG=False))):
            _, _, st, step, _ = setup_training(c, spe, device=DEVICE)
            st.load_state_dict(live)
            multi = make_multi_step(step, K)
            stacked = stack(fb[:K])
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(torch, lambda: multi(st, stacked, None, 1.0),
                         iters=3, warmup=2) / K
            times[f"from features, {name}"] = (
                ms, torch.cuda.max_memory_allocated() / 2 ** 30)
            del st, multi

        # ---- on the fly, bf16, K = 8, with the channel augmenter ----
        write_corpus(tmp, B, seed=46, part="train")
        write_corpus(tmp, B, seed=47, part="dev")
        n_otf = 18
        otf = TrainConfig(
            out_fold=os.path.join(tmp, "otf"), path_to_database=tmp,
            on_the_fly=True, ratio=1.0, model="ecapa", add_loss="ang_iso",
            batch_size=B, feat_len=T, num_epochs=1, C=C,
            compute_dtype="bfloat16", steps_per_call=K, on_device_aug=True,
            apply_ir=True, dev_aug=True)
        raw_train = Repeat(RawAudioDataset("LA", tmp, "train"), n_otf)
        torch.cuda.synchronize()
        zero()
        summary, state = train(otf, train_set=raw_train,
                               dev_set=RawAudioDataset("LA", tmp, "dev"),
                               device=DEVICE, return_state=True)
        torch.cuda.synchronize()
        got = counts()
        counted, run, replays = graph_launches(n_otf, K, 1)
        print(f"on the fly, bf16, K={K}, channel augmenter with IRs: "
              f"{n_otf} steps (one capture, {replays} replay(s)) and one "
              f"augmented dev batch: launches {got}; per kernel of the "
              f"step counted {counted}, run {run}; {summary}")
        check(got == {"B1": counted + 1, "B4a": counted + 1,
                      "B4b": counted},
              f"on-the-fly augmenter launch counts {got}")
        for k, v in got.items():
            entries[k]["launches_train_aug_otf"] = v
        with open(os.path.join(otf.out_fold, "train_loss.log")) as f:
            losses = np.array([float(r.split()[2])
                               for r in f.readlines()[1:]])
        check(len(losses) == n_otf and bool(np.isfinite(losses).all()),
              f"on-the-fly augmenter losses {losses}")
        live = state.state_dict()
        del state

        augmenter = ChannelAugmenter(ir_bank=synthetic_ir_bank(),
                                     device=DEVICE)
        cpu_augmenter = ChannelAugmenter(ir_bank=synthetic_ir_bank(),
                                         device="cpu")
        fe = OnDeviceFrontend(feat_len=T, augmenter=augmenter,
                              apply_ir=True, device=DEVICE)
        waves = [{k: torch.from_numpy(b[k]) for k in ("wave", "length",
                                                      "label")}
                 for b in WaveformIterator(raw_train, B, fe.min_samples(),
                                           seed=5,
                                           steps_per_epoch=2 * K).epoch()]
        wave = waves[0]["wave"].to(DEVICE)
        draws = augmenter.draw(wave.shape, torch.Generator(
            device=DEVICE).manual_seed(11))
        aug_err = augmenter_vs_cpu(torch, augmenter, cpu_augmenter, wave,
                                   draws)
        gen = torch.Generator(device=DEVICE)
        torch.cuda.reset_peak_memory_stats()
        aug_ms = time_ms(torch, lambda: augmenter(wave, draws,
                                                  apply_ir=True))
        aug_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        draw_ms = time_ms(torch, lambda: augmenter.draw(
            wave.shape, gen.manual_seed(12)))

        # 8 replayed steps vs 8 eager ones, with the augmenter on
        rng = otf.seed ^ 0x5EED
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = True
        _, _, st, step, _ = setup_training(otf, n_otf, frontend=fe,
                                           device=DEVICE)
        st.load_state_dict(live)
        multi = make_multi_step(step, K)
        multi(st, stack(waves[:K]), rng, 0.0, fe.params)
        st.load_state_dict(live)
        m_graph = multi(st, stack(waves[K:]), rng, 0.0, fe.params)
        after_graph = copy.deepcopy(st.state_dict())
        st.load_state_dict(live)
        m_eager = [step(st, b, rng, 0.0, fe.params) for b in waves[K:]]
        after_eager = st.state_dict()
        torch.backends.cudnn.deterministic = False
        check_replay(torch, m_graph, after_graph, m_eager, after_eager,
                     live["step"], K, "the step with the channel augmenter")
        del st, multi

        # times on the fly with and without the augmenter
        clean = OnDeviceFrontend(feat_len=T, device=DEVICE)
        stacked = stack(waves[:K])
        for name, frontend in (("on the fly, augmenter", fe),
                               ("on the fly, no augmenter", clean)):
            _, _, st, step, _ = setup_training(otf, n_otf,
                                               frontend=frontend,
                                               device=DEVICE)
            st.load_state_dict(live)
            multi = make_multi_step(step, K)
            run_k = lambda: multi(st, stacked, rng, 0.0, frontend.params)
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(torch, run_k, iters=3, warmup=2) / K
            times[name] = (ms, torch.cuda.max_memory_allocated() / 2 ** 30)
            if frontend is fe:
                profile_device(torch, run_k, K * ms,
                               f"bf16 {K}-step graph replay with the channel "
                               f"augmenter")
            del st, multi
    print(f"ADV_AUG training path [{gpu}]: train() {E * spe} steps and {E} "
          f"dev passes in {wall:.2f} s (host clock, .npy reading, "
          f"checkpoints, first-call set-up and the capture included)")
    print(f"channel augmenter [{gpu}] at {tuple(wave.shape)} with IRs "
          f"(n_fft {augmenter.n_fft}): {aug_ms:.3f} ms (CUDA events; peak "
          f"{aug_peak:.2f} GiB), its draws {draw_ms:.3f} ms; card vs CPU "
          f"{aug_err:.3e}")
    for name, (ms, peak) in times.items():
        print(f"training step {name} [{gpu}] (bf16, K={K} graph, B={B}, "
              f"T={T}, C={C}; CUDA events, host-to-device copies of the "
              f"batches included): {ms:.3f} ms/step = {B / ms * 1e3:.1f} "
              f"utt/s (peak {peak:.2f} GiB)")


@contextlib.contextmanager
def plain_b1():
    """B1's plain version in place of the kernel for ``CudaLFCC`` on CUDA
    tensors (the step the kernel path is held against in phase 4d)."""
    from asvspoof2021_air_tpu_torch.ops import lfcc_cuda as lc

    saved = lc.CudaLFCC.cepstra
    lc.CudaLFCC.cepstra = lambda self, x: lc.lfcc_plain(
        x, self.cs, self.fb, self.dct, self.config)
    try:
        yield
    finally:
        lc.CudaLFCC.cepstra = saved


def family_step_vs_plain(torch, fresh_state, live, step, wave, rng,
                         tag: str, reverse: bool = False):
    """One on-the-fly training step of ResNet or LCNN from state ``live``
    on the waveform batch ``wave`` with its features through B1, against
    the same step with B1's plain version (phase 4d), at phase 4's bars:
    the metrics rtol 1e-4; each gradient's error norm within max(1e-2, 4 x
    two kernel steps' own) of its norm, and the gradients that are zero in
    the plain step zero in the kernel step; BN statistics rtol 1e-4 and
    atol 1e-5, or one input ulp (``bn_ulp_bars``). Both steps draw the
    model's dropout or noise from (rng, step): the same draws. With
    ``reverse`` (a model that draws nothing) the spread also counts the
    plain step on the batch in reverse order, equal in exact arithmetic:
    where ReLU inputs that round to the other side of zero move whole BN
    channels' gradients (SE-Res2Net50), the kernel step's features, 1e-6
    from the plain ones, move them as far as the order of the sums does."""
    runs = []
    flip = {k: v.flip(0) for k, v in wave.items()}
    for ctx, batch in ((contextlib.nullcontext, wave),
                       (contextlib.nullcontext, wave), (plain_b1, wave),
                       *(((plain_b1, flip),) if reverse else ())):
        st = fresh_state()
        st.load_state_dict(live)
        with ctx():
            metrics = step(st, batch, rng)
        grads = {n: p.grad.clone() for n, p in st.model.named_parameters()}
        grads.update({f"loss.{n}": p.grad.clone()
                      for n, p in st.loss_module.named_parameters()})
        runs.append((metrics, grads, {
            k: v.clone() for k, v in st.model.state_dict().items()
            if k.endswith(RUNNING)}))
    (m_k, g_k, s_k), (_, g_k2, _), (m_p, g_p, s_p) = runs[:3]
    for k in m_k:
        a, b = float(m_k[k]), float(m_p[k])
        print(f"{tag} B1 vs plain step: {k} {a:.7f} vs {b:.7f} (rtol 1e-4)")
        check(abs(a - b) <= 1e-4 * abs(b), f"{tag} step {k}: {a} vs {b}")
    names = [n for n in g_p if g_p[n].abs().max() > 0]
    norm_err = lambda got, want: max(
        (float((got[n] - want[n]).norm() / want[n].norm()), n)
        for n in names)
    worst, spread = norm_err(g_k, g_p), norm_err(g_k2, g_k)
    if reverse:
        rev = norm_err(runs[3][1], g_p)
        print(f"{tag} plain step vs the plain step on the batch reversed: "
              f"{rev[0]:.3e} ({rev[1]})")
        spread = max(spread, rev)
    bar = max(1e-2, 4 * spread[0])
    print(f"{tag} B1 vs plain step: largest gradient error norm "
          f"{worst[0]:.3e} of its tensor's ({worst[1]}; bar {bar:.3e}); "
          f"spread {spread[0]:.3e} ({spread[1]})")
    check(worst[0] <= bar, f"{tag} step gradients disagree: {worst}")
    for n in g_p:
        if float(g_p[n].abs().max()) == 0:
            check(bool((g_k[n] == 0).all()), f"{tag} gradient {n} not zero")
    ulp_bars = bn_ulp_bars(torch, st.model, live["model"], s_p, 2.0 ** -23)
    worst_stat = max((max_err(s_k[k], s_p[k]), k) for k in s_p)
    print(f"{tag} B1 vs plain step: BN statistics largest difference "
          f"{worst_stat[0]:.3e} ({worst_stat[1]}; rtol 1e-4, atol 1e-5, or "
          f"one input ulp)")
    for k in s_p:
        bar = torch.maximum(1e-4 * s_p[k].abs() + 1e-5, ulp_bars[k])
        check(bool(((s_k[k] - s_p[k]).abs() <= bar).all()),
              f"{tag} step BN statistic {k} disagrees")


def family_times(torch, cfg, spe, live, batches, frontend, rng, what: str):
    """(ms per step by CUDA events, peak GiB) of ``cfg``'s step from state
    ``live`` (K = ``cfg.steps_per_call``: one replay of the K-step graph
    over ``batches`` per call; K = 1: one step on ``batches[0]``), and a
    profile of one call with the device's busy share."""
    from asvspoof2021_air_tpu_torch.train.loop import setup_training
    from asvspoof2021_air_tpu_torch.train.steps import make_multi_step

    k = cfg.steps_per_call
    _, _, st, step, _ = setup_training(cfg, spe, frontend=frontend,
                                       device=DEVICE)
    st.load_state_dict(live)
    if k == 1:
        call = lambda: step(st, batches[0], rng)
    else:
        multi = make_multi_step(step, k)
        stacked = {n: torch.stack([b[n] for b in batches[:k]])
                   for n in batches[0]}
        call = lambda: multi(st, stacked, rng)
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(torch, call, iters=3 if k > 1 else 5) / k
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    profile_device(torch, call, k * ms, what)
    return ms, peak


def train_families_path(torch, gpu: str, entries):
    """Phase 4d: ResNet18 and LCNN at full width, on the fly through B1
    and from feature files as CUDA graphs of 8 steps, and their scoring
    through ``cli.generate_score`` with every ``-l`` rule."""
    import ast
    import dataclasses
    import io

    from asvspoof2021_air_tpu_torch.cli import evaluate_tdcf, generate_score
    from asvspoof2021_air_tpu_torch.data.datasets import (
        ASVspoof2019FeatureDataset, RawAudioDataset)
    from asvspoof2021_air_tpu_torch.data.pipeline import (
        RatioMixIterator, SequentialIterator, WaveformIterator)
    from asvspoof2021_air_tpu_torch.interop.flax_weights import (
        from_flax_variables, random_flax_variables)
    from asvspoof2021_air_tpu_torch.losses.registry import build_loss
    from asvspoof2021_air_tpu_torch.ops import lfcc_cuda as lc
    from asvspoof2021_air_tpu_torch.scoring import make_score_fn
    from asvspoof2021_air_tpu_torch.train.frontend import OnDeviceFrontend
    from asvspoof2021_air_tpu_torch.train.loop import (
        TrainConfig, setup_training, train)
    from asvspoof2021_air_tpu_torch.train.steps import make_multi_step

    K, rng = 8, 688 ^ 0x5EED           # the loop's seed for the draws
    times = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        # ---- on the fly, f32, K = 1: ResNet18 + ang_iso, LCNN + iso_sq --
        write_corpus(tmp, 2 * B, seed=30, part="train")
        write_corpus(tmp, B, seed=31, part="dev")
        fe = OnDeviceFrontend(feat_len=T, device=DEVICE)
        raw = next(WaveformIterator(RawAudioDataset("LA", tmp, "train"), B,
                                    fe.min_samples(), seed=5).epoch())
        wave = {k: torch.from_numpy(raw[k]) for k in ("wave", "length",
                                                      "label")}
        for family, add_loss, epochs in (("resnet", "ang_iso", 2),
                                         ("lcnn", "iso_sq", 1)):
            cfg = TrainConfig(
                out_fold=os.path.join(tmp, f"otf_{family}"),
                path_to_database=tmp, model=family, add_loss=add_loss,
                on_the_fly=True, batch_size=B, feat_len=T,
                num_epochs=epochs, ratio=1.0)
            init = setup_training(cfg, 2, device=DEVICE)[2].state_dict()
            torch.cuda.synchronize()
            lc.launches = 0
            summary, state = train(cfg, device=DEVICE, return_state=True)
            torch.cuda.synchronize()
            steps = 2 * epochs
            print(f"{family} + {add_loss} f32 on the fly: {steps} steps and "
                  f"{epochs} dev passes, B1 launches {lc.launches}; "
                  f"{summary}")
            check(lc.launches == steps + epochs,
                  f"{family}: B1 did not run once per step and dev batch")
            entries["B1"][f"launches_train_{family}_otf"] = lc.launches
            with open(os.path.join(cfg.out_fold, "train_loss.log")) as f:
                losses = [float(r.split()[2]) for r in f.readlines()[1:]]
            check(len(losses) == steps and bool(np.isfinite(losses).all()),
                  f"{family} losses {losses}")
            live = state.state_dict()
            moved = {k for k, v in live["model"].items()
                     if not torch.equal(v, init["model"][k])}
            stats = {k for k in live["model"] if k.endswith(RUNNING)}
            check(stats <= moved, f"{family}: BN statistics that did not "
                                  f"move: {sorted(stats - moved)}")
            check(all(not torch.equal(v, init["loss_module"][k])
                      for k, v in live["loss_module"].items()),
                  f"{family}: the loss module did not move")
            print(f"{family}: moved {len(moved)} of {len(live['model'])} "
                  f"model tensors (all BN statistics), the loss module; "
                  f"losses {np.round(losses, 5).tolist()}")
            fresh = lambda: setup_training(cfg, 2, device=DEVICE)[2]
            step = setup_training(cfg, 2, frontend=fe, device=DEVICE)[3]
            family_step_vs_plain(torch, fresh, live, step, wave, rng,
                                 f"{family} f32")
            times[f"{family} + {add_loss} f32 K=1 on the fly"] = (
                family_times(torch, cfg, 2, live, [wave], fe, rng,
                             f"{family} f32 training step on the fly"))
            del state

        # ---- from feature files, bf16, K = 8 as a CUDA graph: LCNN +
        # p2sgrad, ResNet18 + isolate ----
        feats = os.path.join(tmp, "feats")
        write_feature_tree(os.path.join(feats, "train", "LFCC"), 2 * B, 32,
                           True)
        write_feature_tree(os.path.join(feats, "dev", "LFCC"), B, 33, True)
        train_set = Repeat(ASVspoof2019FeatureDataset("LA", feats, "train"),
                           K // 2)             # K steps an epoch
        dev_set = ASVspoof2019FeatureDataset("LA", feats, "dev")
        fb = [{k: torch.from_numpy(b[k]) for k in ("feat", "label")}
              for b in RatioMixIterator(train_set, B, 1.0, feat_len=T,
                                        seed=7,
                                        steps_per_epoch=2 * K).epoch()]
        stack = lambda bs: {k: torch.stack([b[k] for b in bs])
                            for k in bs[0]}
        for family, add_loss in (("lcnn", "p2sgrad"), ("resnet", "isolate")):
            cfg = TrainConfig(
                out_fold=os.path.join(tmp, f"bf16_{family}"),
                path_to_features=feats, model=family, add_loss=add_loss,
                batch_size=B, feat_len=T, num_epochs=2, ratio=1.0,
                compute_dtype="bfloat16", steps_per_call=K)
            init = setup_training(cfg, K, device=DEVICE)[2].state_dict()
            summary, state = train(cfg, train_set=train_set,
                                   dev_set=dev_set, device=DEVICE,
                                   return_state=True)
            with open(os.path.join(cfg.out_fold, "train_loss.log")) as f:
                rows = [r.split() for r in f.readlines()[1:]]
            losses = np.array([float(r[2]) for r in rows])
            check([(int(r[0]), int(r[1])) for r in rows]
                  == [(e, i) for e in range(2) for i in range(K)],
                  f"{family} bf16 train_loss.log steps")
            check(bool(np.isfinite(losses).all()),
                  f"{family} bf16 losses {losses}")
            live = state.state_dict()
            check(all(not torch.equal(v, init["model"][k])
                      for k, v in live["model"].items()
                      if k.endswith(RUNNING))
                  and all(not torch.equal(v, init["loss_module"][k])
                          for k, v in live["loss_module"].items()),
                  f"{family} bf16: BN statistics or the loss did not move")
            print(f"{family} + {add_loss} bf16 K={K} from features: 2 "
                  f"epochs of {K} steps (one capture, one replay); "
                  f"{add_loss} loss per step "
                  f"{np.round(losses, 5).tolist()}; {summary}")
            del state
            # K graph-replayed steps against K eager steps, the model's
            # draws static inputs of the graph, cuDNN deterministic
            torch.backends.cudnn.deterministic = True
            _, _, st, step, _ = setup_training(cfg, K, device=DEVICE)
            st.load_state_dict(live)
            multi = make_multi_step(step, K)
            multi(st, stack(fb[:K]), rng)           # eager K steps, capture
            st.load_state_dict(live)
            m_graph = multi(st, stack(fb[K:]), rng)   # replay
            after_graph = copy.deepcopy(st.state_dict())
            st.load_state_dict(live)
            m_eager = [step(st, b, rng) for b in fb[K:]]
            after_eager = st.state_dict()
            torch.backends.cudnn.deterministic = False
            check_replay(torch, m_graph, after_graph, m_eager, after_eager,
                         live["step"], K, f"{family} + {add_loss} bf16 "
                         f"(its draws static inputs)")
            del st, multi
            times[f"{family} + {add_loss} bf16 K={K} from features"] = (
                family_times(torch, cfg, K, live, fb[:K], None, rng,
                             f"{family} bf16 {K}-step graph replay"))

        # ---- scoring: cli.generate_score with every -l rule ----
        dev_names = write_feature_tree(os.path.join(tmp, "score", "dev",
                                                    "LFCC"),
                                       2 * B + 8, 34, labeled=True)
        asv = os.path.join(tmp, "asv.txt")
        g = np.random.default_rng(35)
        with open(asv, "w") as f:
            for i in range(300):
                kind = ("target", "nontarget", "spoof")[i % 3]
                f.write(f"LA_{i:04d} {kind} "
                        f"{g.standard_normal() + 2.0 * (i % 3 != 1)}\n")
        rules = ((None, ("softmax",)), ("ang_iso", ("ocsoftmax", "ang_iso")),
                 ("isolate", ("isolate",)), ("iso_sq", ("iso_sq",)),
                 ("p2sgrad", ("p2sgrad",)), ("amsoftmax", ("amsoftmax",)))
        os.chdir(tmp)               # the 19* tasks write under ./scores
        try:
            for family in ("resnet", "lcnn"):
                sd = from_flax_variables(random_flax_variables(
                    36, model=family, feat_len=T), model=family)
                for add_loss, flags in rules:
                    name = f"{family}_{add_loss}"
                    run = os.path.join(tmp, "runs", name)
                    os.makedirs(run)
                    cfg = TrainConfig(out_fold=run, model=family,
                                      add_loss=add_loss, feat_len=T)
                    with open(os.path.join(run, "args.json"), "w") as f:
                        json.dump(dataclasses.asdict(cfg), f)
                    loss = build_loss(add_loss, generator=torch.Generator()
                                      .manual_seed(37), device="cpu")
                    torch.save({"step": 0, "model": sd, "optimizer": {},
                                "loss_module": None if loss is None
                                else loss.state_dict()},
                               os.path.join(run, "best.pt"))
                    for flag in flags:
                        with contextlib.redirect_stdout(io.StringIO()):
                            path = generate_score.main([
                                "--model_folder", os.path.join(tmp, "runs"),
                                "-n", name, "-t", "19dev", "-l", flag,
                                "--ori_features",
                                os.path.join(tmp, "score"), "--batch_size",
                                str(B), "--device", DEVICE])
                        with open(path) as f:
                            rows = [r.split() for r in f]
                        scores = np.array([float(r[1]) for r in rows])
                        check([r[0] for r in rows] == dev_names
                              and bool(np.isfinite(scores).all()),
                              f"{name} -l {flag}: score file rows")
                        # the first 8 utterances on the CPU, the plain
                        # reference of the card's cuDNN convolutions
                        batch = next(iter(SequentialIterator(
                            ASVspoof2019FeatureDataset(
                                "LA", os.path.join(tmp, "score"), "dev"),
                            8, T)))
                        _sd, lm, _c = generate_score.load_system(
                            run, device="cpu")
                        rule = None if flag == "softmax" else flag
                        ref = -make_score_fn(sd, lm, rule, model=family,
                                             device="cpu")(batch["feat"])
                        err = float(np.abs(scores[:8] - ref.numpy()).max())
                        print(f"cli.generate_score {name} -l {flag}: "
                              f"{len(rows)} rows, card vs CPU on 8 "
                              f"utterances {err:.2e} (bar 1e-4)")
                        check(err <= 1e-4, f"{name} -l {flag} scores off "
                                           "the CPU's")
                    buf = io.StringIO()
                    with contextlib.redirect_stdout(buf):
                        evaluate_tdcf.main([path, "--asv_score_file", asv])
                    result = ast.literal_eval(
                        buf.getvalue().strip().splitlines()[-1])
                    check(all(np.isfinite(v) for v in result.values()),
                          f"{name}: EER or min-tDCF not finite")
                print(f"{family}: evaluate_tdcf of the last file {result}")
        finally:
            os.chdir(cwd)
    for what, (ms, peak) in times.items():
        print(f"training step {what} [{gpu}] (B={B}, T={T}; CUDA events, "
              f"host-to-device copies of the batches included): {ms:.3f} "
              f"ms/step = {B / ms * 1e3:.1f} utt/s; peak {peak:.2f} GiB")


def train_new_families_path(torch, gpu: str, entries):
    """Phase 4e: SE-Res2Net50 and ConvNet at full width on the fly through
    B1 and from feature files as CUDA graphs of 8 steps (f32, as the JAX
    registry builds them), RawNet2 on the fly with the channel augmenter as
    a CUDA graph of 8 steps, and their scorers."""
    import dataclasses

    from asvspoof2021_air_tpu_torch.cli import generate_score
    from asvspoof2021_air_tpu_torch.data.datasets import (
        ASVspoof2019FeatureDataset, RawAudioDataset)
    from asvspoof2021_air_tpu_torch.data.pipeline import (
        RatioMixIterator, SequentialIterator, WaveformIterator)
    from asvspoof2021_air_tpu_torch.models.rawnet import RAWNET2_DEFAULT_ARGS
    from asvspoof2021_air_tpu_torch.ops import lfcc_cuda as lc
    from asvspoof2021_air_tpu_torch.ops.augment import ChannelAugmenter
    from asvspoof2021_air_tpu_torch.scoring import (
        build_scoring_model, make_score_fn, score_raw_to_file)
    from asvspoof2021_air_tpu_torch.train.frontend import (
        OnDeviceFrontend, WaveformFrontend)
    from asvspoof2021_air_tpu_torch.train.loop import (
        TrainConfig, setup_training, train)
    from asvspoof2021_air_tpu_torch.train.steps import make_multi_step

    K, rng = 8, 688 ^ 0x5EED           # the loop's seed for the draws
    n_samp = RAWNET2_DEFAULT_ARGS["nb_samp"]
    times, score_ms = {}, {}
    cwd = os.getcwd()
    stack = lambda bs: {k: torch.stack([b[k] for b in bs]) for k in bs[0]}

    def f32_only(model, x, what: str) -> None:
        # the JAX registry builds these families without a compute dtype
        dtypes = set()
        hooks = [m.register_forward_hook(
            lambda m, i, o: dtypes.update(t.dtype for t in (
                o if isinstance(o, tuple) else (o,)) if torch.is_tensor(t)))
            for m in model.modules()]
        with torch.no_grad():
            model(x)
        for h in hooks:
            h.remove()
        params = {p.dtype for p in model.parameters()}
        print(f"{what}: parameter types {params}, module output types "
              f"{dtypes}")
        check(params == dtypes == {torch.float32}, f"{what} is not f32")

    def replay_vs_eager(cfg, live, batches, frontend, what: str,
                        params=None):
        # K graph-replayed steps against K eager steps from the trained
        # state, cuDNN deterministic
        torch.backends.cudnn.deterministic = True
        _, _, st, step, _ = setup_training(cfg, K, frontend=frontend,
                                           device=DEVICE)
        st.load_state_dict(live)
        multi = make_multi_step(step, K)
        multi(st, stack(batches[:K]), rng, 0.0, params)   # eager, capture
        st.load_state_dict(live)
        m_graph = multi(st, stack(batches[K:]), rng, 0.0, params)
        after_graph = copy.deepcopy(st.state_dict())
        st.load_state_dict(live)
        m_eager = [step(st, b, rng, 0.0, params) for b in batches[K:]]
        after_eager = st.state_dict()
        torch.backends.cudnn.deterministic = False
        check_replay(torch, m_graph, after_graph, m_eager, after_eager,
                     live["step"], K, what)

    with tempfile.TemporaryDirectory() as tmp:
        # ---- on the fly, f32, K = 1, through B1: SE-Res2Net50 + ang_iso,
        # ConvNet + ang_iso ----
        write_corpus(tmp, 2 * B, seed=50, part="train")
        write_corpus(tmp, B, seed=51, part="dev")
        fe = OnDeviceFrontend(feat_len=T, device=DEVICE)
        raw = next(WaveformIterator(RawAudioDataset("LA", tmp, "train"), B,
                                    fe.min_samples(), seed=5).epoch())
        wave = {k: torch.from_numpy(raw[k]) for k in ("wave", "length",
                                                      "label")}
        for family in ("res2net", "cnn"):
            cfg = TrainConfig(
                out_fold=os.path.join(tmp, f"otf_{family}"),
                path_to_database=tmp, model=family, add_loss="ang_iso",
                on_the_fly=True, batch_size=B, feat_len=T, num_epochs=1,
                ratio=1.0)
            init = setup_training(cfg, 2, device=DEVICE)[2].state_dict()
            torch.cuda.synchronize()
            lc.launches = 0
            summary, state = train(cfg, device=DEVICE, return_state=True)
            torch.cuda.synchronize()
            print(f"{family} + ang_iso f32 on the fly: 2 steps and 1 dev "
                  f"pass, B1 launches {lc.launches}; {summary}")
            check(lc.launches == 3,
                  f"{family}: B1 did not run once per step and dev batch")
            entries["B1"][f"launches_train_{family}_otf"] = lc.launches
            with open(os.path.join(cfg.out_fold, "train_loss.log")) as f:
                losses = [float(r.split()[2]) for r in f.readlines()[1:]]
            check(len(losses) == 2 and bool(np.isfinite(losses).all()),
                  f"{family} losses {losses}")
            live = state.state_dict()
            moved = {k for k, v in live["model"].items()
                     if not torch.equal(v, init["model"][k])}
            stats = {k for k in live["model"] if k.endswith(RUNNING)}
            check(stats <= moved, f"{family}: BN statistics that did not "
                                  f"move: {sorted(stats - moved)}")
            check(all(not torch.equal(v, init["loss_module"][k])
                      for k, v in live["loss_module"].items()),
                  f"{family}: the loss module did not move")
            fresh = lambda: setup_training(cfg, 2, device=DEVICE)[2]
            step = setup_training(cfg, 2, frontend=fe, device=DEVICE)[3]
            family_step_vs_plain(torch, fresh, live, step, wave, rng,
                                 f"{family} f32", reverse=True)
            times[f"{family} + ang_iso f32 K=1 on the fly"] = (
                family_times(torch, cfg, 2, live, [wave], fe, rng,
                             f"{family} f32 training step on the fly"))
            del state

        # ---- from feature files at compute_dtype bf16 (f32 as in JAX),
        # K = 8 as a CUDA graph: SE-Res2Net50 + isolate, ConvNet +
        # p2sgrad ----
        feats = os.path.join(tmp, "feats")
        write_feature_tree(os.path.join(feats, "train", "LFCC"), 2 * B, 52,
                           True)
        write_feature_tree(os.path.join(feats, "dev", "LFCC"), B, 53, True)
        train_set = Repeat(ASVspoof2019FeatureDataset("LA", feats, "train"),
                           K // 2)             # K steps an epoch
        dev_set = ASVspoof2019FeatureDataset("LA", feats, "dev")
        fb = [{k: torch.from_numpy(b[k]) for k in ("feat", "label")}
              for b in RatioMixIterator(train_set, B, 1.0, feat_len=T,
                                        seed=7,
                                        steps_per_epoch=2 * K).epoch()]
        for family, add_loss in (("res2net", "isolate"), ("cnn", "p2sgrad")):
            cfg = TrainConfig(
                out_fold=os.path.join(tmp, "runs", family),
                path_to_features=feats, model=family, add_loss=add_loss,
                batch_size=B, feat_len=T, num_epochs=2, ratio=1.0,
                compute_dtype="bfloat16", steps_per_call=K)
            summary, state = train(cfg, train_set=train_set,
                                   dev_set=dev_set, device=DEVICE,
                                   return_state=True)
            with open(os.path.join(cfg.out_fold, "train_loss.log")) as f:
                rows = [r.split() for r in f.readlines()[1:]]
            losses = np.array([float(r[2]) for r in rows])
            check([(int(r[0]), int(r[1])) for r in rows]
                  == [(e, i) for e in range(2) for i in range(K)],
                  f"{family} train_loss.log steps")
            check(bool(np.isfinite(losses).all()), f"{family} losses")
            live = state.state_dict()
            f32_only(state.model.eval(), fb[0]["feat"].to(DEVICE),
                     f"{family} under compute_dtype bfloat16")
            print(f"{family} + {add_loss} compute_dtype bfloat16 K={K} from "
                  f"features: 2 epochs of {K} steps (one capture, one "
                  f"replay); loss per step {np.round(losses, 5).tolist()}; "
                  f"{summary}")
            del state
            replay_vs_eager(cfg, live, fb, None, f"{family} + {add_loss}")
            times[f"{family} + {add_loss} f32 K={K} from features"] = (
                family_times(torch, cfg, K, live, fb[:K], None, rng,
                             f"{family} {K}-step graph replay"))

        # ---- RawNet2, CE, on the fly with the channel augmenter, K = 8
        # as a CUDA graph; no B1 ----
        raw_train = Repeat(RawAudioDataset("LA", tmp, "train"), K // 2)
        rcfg = TrainConfig(
            out_fold=os.path.join(tmp, "runs", "rawnet"),
            path_to_database=tmp, model="rawnet", on_the_fly=True,
            on_device_aug=True, batch_size=B, num_epochs=1, ratio=1.0,
            steps_per_call=K)
        torch.cuda.synchronize()
        lc.launches = 0
        summary, state = train(rcfg, train_set=raw_train,
                               dev_set=RawAudioDataset("LA", tmp, "dev"),
                               device=DEVICE, return_state=True)
        torch.cuda.synchronize()
        print(f"rawnet CE on the fly with the channel augmenter, K={K}: "
              f"{K} steps (one call: eager steps and the capture) and 1 dev "
              f"pass, B1 launches {lc.launches}; {summary}")
        check(lc.launches == 0, "RawNet2 launched B1")
        entries["B1"]["launches_train_rawnet_otf"] = lc.launches
        with open(os.path.join(rcfg.out_fold, "train_loss.log")) as f:
            losses = np.array([float(r.split()[2])
                               for r in f.readlines()[1:]])
        check(len(losses) == K and bool(np.isfinite(losses).all()),
              f"rawnet losses {losses}")
        rfe = WaveformFrontend(n_samp, augmenter=ChannelAugmenter(
            device=DEVICE), device=DEVICE)
        live = state.state_dict()
        f32_only(state.model.eval(), torch.zeros(4, n_samp, device=DEVICE),
                 "rawnet")
        del state
        waves = [{k: torch.from_numpy(b[k]) for k in ("wave", "length",
                                                      "label")}
                 for b in WaveformIterator(raw_train, B, n_samp, seed=5,
                                           steps_per_epoch=2 * K).epoch()]
        replay_vs_eager(rcfg, live, waves, rfe,
                        "rawnet with the channel augmenter (cuDNN GRU)",
                        rfe.params)
        times[f"rawnet CE f32 K={K} on the fly, channel augmenter"] = (
            family_times(torch, rcfg, K, live, waves[:K], rfe, rng,
                         f"rawnet {K}-step graph replay with the augmenter"))

        # ---- scoring: cli.generate_score over the two feature-file run
        # folders, score_raw_to_file of RawNet2 from FLAC ----
        dev_names = write_feature_tree(os.path.join(tmp, "score", "dev",
                                                    "LFCC"),
                                       2 * B + 8, 54, labeled=True)
        x = torch.from_numpy(np.stack([b["feat"].numpy() for b in fb[:1]])[
            0]).to(DEVICE)
        os.chdir(tmp)               # the 19* tasks write under ./scores
        try:
            for family in ("res2net", "cnn"):
                run = os.path.join(tmp, "runs", family)
                with contextlib.redirect_stdout(open(os.devnull, "w")):
                    path = generate_score.main([
                        "--model_folder", os.path.join(tmp, "runs"),
                        "-n", family, "-t", "19dev", "--ori_features",
                        os.path.join(tmp, "score"), "--batch_size", str(B),
                        "--device", DEVICE])
                with open(path) as f:
                    rows = [r.split() for r in f]
                scores = np.array([float(r[1]) for r in rows])
                check([r[0] for r in rows] == dev_names
                      and bool(np.isfinite(scores).all()),
                      f"{family}: score file rows")
                batch = next(iter(SequentialIterator(
                    ASVspoof2019FeatureDataset(
                        "LA", os.path.join(tmp, "score"), "dev"), 8, T)))
                sd, lm, rc = generate_score.load_system(run, device="cpu")
                ref = -make_score_fn(sd, lm, rc.add_loss, model=family,
                                     device="cpu")(batch["feat"])
                err = float(np.abs(scores[:8] - ref.numpy()).max())
                print(f"cli.generate_score {family} ({rc.add_loss}): "
                      f"{len(rows)} rows, card vs CPU on 8 utterances "
                      f"{err:.2e} (bar 1e-4)")
                check(err <= 1e-4, f"{family} scores off the CPU's")
                sd, lm, rc = generate_score.load_system(run, device=DEVICE)
                fn = make_score_fn(sd, lm, rc.add_loss, model=family,
                                   device=DEVICE)
                score_ms[family] = time_ms(torch, lambda: fn(x))
        finally:
            os.chdir(cwd)
        write_corpus(os.path.join(tmp, "eval"), 2 * B + 8, seed=55,
                     fmt="flac")
        eval_set = RawAudioDataset("LA", os.path.join(tmp, "eval"), "eval")
        t0 = time.perf_counter()
        path = score_raw_to_file(
            live["model"], eval_set, os.path.join(tmp, "rawnet.txt"), True,
            WaveformFrontend(n_samp, device=DEVICE), batch_size=B,
            model="rawnet", device=DEVICE)
        raw_host_ms = (time.perf_counter() - t0) * 1e3 / 3
        subset = [eval_set[i] for i in range(8)]
        ref_path = score_raw_to_file(
            {k: v.cpu() for k, v in live["model"].items()}, subset,
            os.path.join(tmp, "rawnet_cpu.txt"), True,
            WaveformFrontend(n_samp, device="cpu"), batch_size=8,
            model="rawnet", device="cpu")
        with open(path) as f:
            rows = [r.split() for r in f]
        with open(ref_path) as f:
            ref_rows = [r.split() for r in f]
        scores = np.array([float(r[1]) for r in rows])
        check(len(rows) == len(eval_set) and bool(np.isfinite(scores).all())
              and [r[0] for r in rows[:8]] == [r[0] for r in ref_rows],
              "rawnet: score file rows")
        err = float(np.abs(scores[:8] - np.array(
            [float(r[1]) for r in ref_rows])).max())
        print(f"score_raw_to_file rawnet from FLAC: {len(rows)} rows, card "
              f"vs CPU on 8 utterances {err:.2e} (bar 1e-4)")
        check(err <= 1e-4, "rawnet scores off the CPU's")
        net = build_scoring_model(live["model"], "rawnet", device=DEVICE)
        xw = torch.from_numpy(np.stack([w["wave"].numpy()
                                        for w in waves[:1]])[0]).to(DEVICE)
        with torch.no_grad():
            score_ms["rawnet"] = time_ms(torch, lambda: net(xw))
    for what, (ms, peak) in times.items():
        print(f"training step {what} [{gpu}] (B={B}, T={T}; RawNet2 "
              f"{n_samp} samples; CUDA events, host-to-device copies of the "
              f"batches included): {ms:.3f} ms/step = {B / ms * 1e3:.1f} "
              f"utt/s; peak {peak:.2f} GiB")
    for family, ms in score_ms.items():
        print(f"scorer forward {family} [{gpu}] (B={B}, f32, CUDA events): "
              f"{ms:.3f} ms/batch = {B / ms * 1e3:.1f} utt/s")
    print(f"score_raw_to_file rawnet [{gpu}]: {raw_host_ms:.2f} ms/batch "
          f"(host clock, FLAC reading and the forward)")


PRE_N, PRE_BATCH = 256, 32


def front_end_float64(torch, feature: str, x, lengths):
    """The float64 value of ``feature`` on (B, L) waveforms ``x`` on the
    card, as the preprocess CLI writes it (B, T, D): the port's module with
    its constants cast to float64 (phase 5's reference)."""
    from asvspoof2021_air_tpu_torch.ops.cqcc import CQCC
    from asvspoof2021_air_tpu_torch.ops.lfcc import STFT, Melspec

    x = x.double()
    if feature == "CQCC":
        m = CQCC(device=x.device)
        m.kernels = [k.double() for k in m.kernels]
        m.hb, m.resample, m.dct = (t.double() for t in (m.hb, m.resample,
                                                        m.dct))
        return m(x, lengths)
    if feature == "STFT":
        m = STFT(device=x.device)
        m.window = m.window.double()
        return m(x)
    m = Melspec(device=x.device)
    m.window, m.fb = m.window.double(), m.fb.double()
    return m(x).transpose(1, 2)


def preprocess_path(torch, gpu: str, entries):
    """Phase 5: feature materialization through ``cli.preprocess`` on the
    card, LFCC through B1; the other front-ends on the card against their
    CPU runs."""
    import io

    from asvspoof2021_air_tpu_torch.cli import preprocess
    from asvspoof2021_air_tpu_torch.data import protocol as proto
    from asvspoof2021_air_tpu_torch.data.audio_io import write_wav
    from asvspoof2021_air_tpu_torch.data.datasets import RawAudioDataset
    from asvspoof2021_air_tpu_torch.data.pipeline import RatioMixIterator
    from asvspoof2021_air_tpu_torch.ops import lfcc_cuda as lc
    from asvspoof2021_air_tpu_torch.ops.lfcc import LFCC, emphasize
    from asvspoof2021_air_tpu_torch.scoring import build_task_dataset

    quiet = lambda: contextlib.redirect_stdout(io.StringIO())
    # the ASVspoof 2019 LA utterances' range, 1.0 - 8.0 s
    lengths = np.random.default_rng(30).integers(16000, 128001, PRE_N)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        written = write_corpus(tmp, PRE_N, seed=31, part="dev", fmt="flac",
                               lengths=lengths)
        print(f"preprocess corpus: {PRE_N} FLAC utterances of "
              f"{lengths.min() / 16000:.2f} - {lengths.max() / 16000:.2f} s "
              f"written in {time.perf_counter() - t0:.1f} s")
        base = ["-d", tmp, "--part", "dev", "--batch_size", str(PRE_BATCH),
                "--device", DEVICE]

        # ---- --dataset aug --with_device: the channel and device
        # suffixes (also the warm-up of the card's path) ----
        aug = os.path.join(tmp, "aug")
        os.makedirs(os.path.join(aug, "dev"))
        suffixes = {}
        for i, fname in enumerate(list(written)[:8]):
            ch, dv = proto.LA_CHANNELS[1 + 7 * i], proto.DEVICES[i]
            write_wav(os.path.join(aug, "dev", f"{fname}_{ch}_{dv}.wav"),
                      written[fname][:24000] / 32768.0)
            suffixes[fname] = (ch, dv)
        with quiet():
            preprocess.main(base + ["--dataset", "aug", "--aug_wav_dir", aug,
                                    "--with_device", "-o",
                                    os.path.join(tmp, "aug_feats")])
        names = sorted(os.listdir(os.path.join(tmp, "aug_feats", "dev",
                                               "LFCC")))
        fields = [n[:-4].split("_") for n in names]
        check(len(names) == 8 and all(
            len(f) == 8 and (f[6], f[7]) == suffixes["_".join(f[1:4])]
            for f in fields), f"aug --with_device names {names}")
        print(f"--dataset aug --with_device: {len(names)} files with their "
              f"_channel_device suffixes, e.g. {names[0]}")

        # ---- the main path: 256 utterances, LFCC, batch 32, on the card
        torch.cuda.synchronize()
        lc.launches = 0
        t0 = time.perf_counter()
        with quiet():
            n = preprocess.main(base + ["-o", os.path.join(tmp, "gpu")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = lc.launches
        order = np.sort(lengths)
        buckets = [int(-(-order[s:s + PRE_BATCH].max() // 16000) * 16000)
                   for s in range(0, PRE_N, PRE_BATCH)]
        print(f"preprocess LFCC: {n} files, B1 launches {launches} over "
              f"bucket batches (rows, samples) "
              f"{[(min(PRE_BATCH, PRE_N - i * PRE_BATCH), b) for i, b in enumerate(buckets)]}")
        check(n == PRE_N and launches == -(-PRE_N // PRE_BATCH),
              f"preprocess: {n} files, {launches} B1 launches")
        check(max(buckets) == 128000, f"largest bucket {max(buckets)}")
        entries["B1"]["launches_preprocess"] = launches

        # each file against the plain LFCC of its utterance alone, unpadded,
        # on the card (B1's bar)
        ds = RawAudioDataset("LA", tmp, "dev")
        gpu_dir = os.path.join(tmp, "gpu", "dev", "LFCC")
        names = sorted(os.listdir(gpu_dir))
        plain, worst = LFCC(device=DEVICE), 0.0
        for name in names:
            wav, fname = ds[int(name[:6])][:2]
            arr = np.load(os.path.join(gpu_dir, name))
            check(name[7:].startswith(fname + "_")
                  and arr.shape == (1, 1 + len(wav) // 160, 60)
                  and arr.dtype == np.float32, f"{name}: {arr.shape}")
            with torch.no_grad():
                ref = plain(torch.from_numpy(wav)[None].to(DEVICE))
            worst = max(worst, float(np.abs(arr - ref.cpu().numpy()).max()))
        print(f"preprocess LFCC files vs the plain LFCC of each utterance "
              f"alone on the card: max abs err {worst:.3e} (bar 5e-4)")
        check(worst <= 5e-4, f"preprocess LFCC vs plain: {worst}")

        # the names of a CPU run, and its arrays
        t0 = time.perf_counter()
        with quiet():
            preprocess.main(base + ["-o", os.path.join(tmp, "cpu"),
                                    "--device", "cpu"])
        cpu_s = time.perf_counter() - t0
        cpu_dir = os.path.join(tmp, "cpu", "dev", "LFCC")
        check(sorted(os.listdir(cpu_dir)) == names,
              "the card's and the CPU's file names differ")
        cpu_err = max(float(np.abs(np.load(os.path.join(gpu_dir, f))
                                   - np.load(os.path.join(cpu_dir, f))).max())
                      for f in names)
        print(f"preprocess LFCC: the CPU run's {len(names)} names equal the "
              f"card's; arrays within {cpu_err:.3e} (bar 5e-4); the CPU run "
              f"took {cpu_s:.1f} s")
        check(cpu_err <= 5e-4, f"card vs CPU LFCC files {cpu_err}")

        # read back by the task router and the training iterator
        task = build_task_dataset("19dev", {"ori_features": os.path.join(
            tmp, "gpu")})
        batch = next(iter(RatioMixIterator(task, B, 1.0, feat_len=T,
                                           seed=1).epoch()))
        check(len(task) == PRE_N and batch["feat"].shape == (B, T, 60)
              and np.isfinite(batch["feat"]).all(),
              f"19dev read back: {len(task)}, {batch['feat'].shape}")
        print(f"read back: build_task_dataset('19dev') {len(task)} items, "
              f"RatioMixIterator batch {batch['feat'].shape}")

        # ---- STFT, Melspec and CQCC on 8 utterances: the card's distance
        # to their float64 value within twice the CPU run's (the CPU
        # tests' bar, with the CPU run as the reference), and the card's
        # distance to the CPU run within the sum of the two ----
        waves = [ds[i][0] for i in range(8)]
        lens = np.array([len(w) for w in waves])
        x = np.zeros((8, int(-(-lens.max() // 16000) * 16000)), np.float32)
        for r, w in enumerate(waves):
            x[r, :len(w)] = w
        for feature in ("STFT", "Melspec", "CQCC"):
            outs = {}
            for dev in (DEVICE, "cpu"):
                fn, _hop = preprocess.build_extractor(feature, dev)
                with torch.no_grad():
                    outs[dev] = fn(torch.from_numpy(x).to(dev),
                                   torch.from_numpy(lens).to(dev)).cpu()
            with torch.no_grad():
                ref = front_end_float64(
                    torch, feature, torch.from_numpy(x).to(DEVICE),
                    torch.from_numpy(lens).to(DEVICE)).cpu()
            err64 = lambda a, b: float((a.double() - b.double()).abs().max())
            d_cpu, d_card = err64(outs["cpu"], ref), err64(outs[DEVICE], ref)
            diff = err64(outs[DEVICE], outs["cpu"])
            print(f"{feature} {tuple(outs[DEVICE].shape)}: the card's "
                  f"distance to float64 {d_card:.3e} (bar 2 x the CPU "
                  f"run's, {d_cpu:.3e}); card vs CPU {diff:.3e} (bar "
                  f"{d_card + d_cpu:.3e}); largest value "
                  f"{float(ref.abs().max()):.1f}")
            check(d_card <= 2 * d_cpu, f"{feature}: the card's distance "
                                       f"to float64 {d_card} > 2 x {d_cpu}")
            check(diff <= d_card + d_cpu, f"{feature}: card vs CPU {diff} > "
                                          f"{d_card} + {d_cpu}")

        # B1 alone at the largest bucket shape
        ex = lc.CudaLFCC(device=DEVICE)
        xb = emphasize(0.1 * torch.randn(PRE_BATCH, 128000, device=DEVICE),
                       ex.config, None).contiguous()
        b1_ms = time_ms(torch, lambda: ex.cepstra(xb))
    print(f"preprocess [{gpu}]: {PRE_N} utterances (FLAC, 1.0 - 8.0 s) to "
          f"LFCC files in {wall:.2f} s = {PRE_N / wall:.1f} utt/s (host "
          f"clock: FLAC decoding, {launches} B1 bucket batches, .npy "
          f"writes); B1 at ({PRE_BATCH}, 128000) {b1_ms:.4f} ms (CUDA "
          f"events)")


def flat_members(sd):
    """An ensemble's ``state_dict`` in the form ``check_replay`` reads a
    single system's: the step, and each member's parts under 'member<i>
    <part>'."""
    out = {"step": sd["step"]}
    for i, m in enumerate(sd["members"]):
        out.update({f"member{i} {part}": v for part, v in m.items()
                    if part != "step"})
    return out


def members_vs_single(torch, cfg, n_steps: int, frontend, live, batch,
                      rng, member_batch, what: str) -> None:
    """One eager ensemble step of ``cfg`` (K = 1) from state ``live`` on
    ``batch``, each member against a single-system step from the member's
    state on ``member_batch(i)``: model, loss module and Adam states, rtol
    1e-6 and atol 1e-9 (phase 5b)."""
    import dataclasses

    from asvspoof2021_air_tpu_torch.train.loop import setup_training

    k1 = dataclasses.replace(cfg, steps_per_call=1)
    _, _, est, estep, _ = setup_training(k1, n_steps, frontend=frontend,
                                         device=DEVICE)
    est.load_state_dict(live)
    estep(est, batch, rng)
    after_ens = copy.deepcopy(est.state_dict())
    del est
    _, _, single, sstep, _ = setup_training(
        dataclasses.replace(k1, ensemble=1), n_steps, frontend=frontend,
        device=DEVICE)
    same = total = 0
    for i in range(len(live["members"])):
        single.load_state_dict(live["members"][i])
        sstep(single, member_batch(i))
        got, want = after_ens["members"][i], single.state_dict()
        pairs = [(f"{part} {n}", v, want[part][n])
                 for part in ("model", "loss_module")
                 for n, v in got[part].items()]
        pairs += [(f"optimizer {n} {k}", t, want["optimizer"][n][k])
                  for n, st_ in got["optimizer"].items()
                  for k, t in st_.items()]
        same += sum(torch.equal(a, b) for _, a, b in pairs)
        total += len(pairs)
        bad = [n for n, a, b in pairs
               if not torch.allclose(a, b, rtol=1e-6, atol=1e-9)]
        check(not bad and got["step"] == want["step"],
              f"member {i}'s {what} ensemble step differs from its single "
              f"step: {bad[:5]}")
    print(f"each member's {what} ensemble step vs a single-system step from "
          f"its state: {same} of {total} tensors bitwise equal (bar rtol "
          f"1e-6, atol 1e-9)")


def train_ensemble_path(torch, gpu: str, entries):
    """Phase 5b: ensembles on one card, M = 3 ECAPA-TDNN-512 + ang_iso in
    bf16 with 8 steps per CUDA graph, from LA_aug feature files and on the
    fly with the channel augmenter; replay against eager steps, member
    steps against single-system steps; then ``cli.generate_score``'s
    member and fused files; times."""
    import io

    from asvspoof2021_air_tpu_torch.cli import generate_score
    from asvspoof2021_air_tpu_torch.data.datasets import (
        AugmentedFeatureDataset, RawAudioDataset)
    from asvspoof2021_air_tpu_torch.data.pipeline import (
        RatioMixIterator, WaveformIterator)
    from asvspoof2021_air_tpu_torch.fusion import entropy_weights
    from asvspoof2021_air_tpu_torch.metrics.evaluate import (
        eer_from_score_file, read_score_file)
    from asvspoof2021_air_tpu_torch.ops import attn_pool_cuda as ap
    from asvspoof2021_air_tpu_torch.ops import attn_pool_vjp as vj
    from asvspoof2021_air_tpu_torch.ops import lfcc_cuda as lc
    from asvspoof2021_air_tpu_torch.ops import res2_chain_cuda as rc
    from asvspoof2021_air_tpu_torch.ops.augment import ChannelAugmenter
    from asvspoof2021_air_tpu_torch.train.checkpoint import (
        restore_checkpoint)
    from asvspoof2021_air_tpu_torch.train.frontend import OnDeviceFrontend
    from asvspoof2021_air_tpu_torch.train.loop import (
        TrainConfig, setup_training, train)
    from asvspoof2021_air_tpu_torch.train.steps import (
        make_multi_step, step_generator)

    M, K, n_ori, n_aug = 3, 8, 5 * B, 5 * B // 2
    spe = -(-n_ori // (B // 2))           # ratio 0.5: 10 steps an epoch
    stack = lambda bs: {k: torch.stack([b[k] for b in bs]) for k in bs[0]}
    counts_now = lambda: {"B1": lc.launches, "B4a": vj.fwd_launches,
                          "B4b": vj.bwd_launches}
    with tempfile.TemporaryDirectory() as tmp:
        feats, aug = os.path.join(tmp, "feats"), os.path.join(tmp, "aug")
        for root, part, n, seed, sfx in (
                (feats, "train", n_ori, 20, ""), (feats, "dev", B, 21, ""),
                (aug, "train", n_aug, 23, "_amr[br=5k9]"),
                (aug, "dev", B, 24, "_amr[br=5k9]")):
            write_feature_tree(os.path.join(root, part, "LFCC"), n, seed,
                               True, sfx)
        cfg = TrainConfig(
            out_fold=os.path.join(tmp, "runs", "ens"),
            path_to_features=feats, path_to_aug_features=aug, LA_aug=True,
            ratio=0.5, model="ecapa", add_loss="ang_iso", batch_size=B,
            feat_len=T, num_epochs=1, C=C, compute_dtype="bfloat16",
            steps_per_call=K, ensemble=M)
        init = copy.deepcopy(setup_training(cfg, spe,
                                            device=DEVICE)[2].state_dict())

        # ---- the main path: train() M = 3, bf16, K = 8 from features ----
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lc.launches = vj.fwd_launches = vj.bwd_launches = 0
        t0 = time.perf_counter()
        summary, state = train(cfg, device=DEVICE, return_state=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak_train = torch.cuda.max_memory_allocated() / 2 ** 30
        counts = counts_now()
        counted, _run, _replays = graph_launches(spe, K, 1)
        print(f"ensemble M={M} bf16 K={K} from features: {spe} steps (a "
              f"call of {K}: eager + capture, and a tail of {spe % K}) and "
              f"one dev pass of 2 batches: launches {counts}; per member "
              f"B4b counted {counted}")
        check(counts == {"B1": 0, "B4a": M * (counted + 2),
                         "B4b": M * counted},
              f"ensemble launch counts {counts}, expected B4a "
              f"{M * (counted + 2)}, B4b {M * counted}")
        for k, v in counts.items():
            entries[k]["launches_train_ensemble"] = v
        with open(os.path.join(cfg.out_fold, "train_loss.log")) as f:
            losses = np.array([float(line.split()[2])
                               for line in f.readlines()[1:]])
        check(len(losses) == spe and bool(np.isfinite(losses).all()),
              f"ensemble losses {losses}")
        print(f"ensemble summary: {summary}; member-mean ang_iso per step "
              f"{np.round(losses, 5).tolist()}")
        live = copy.deepcopy(state.state_dict())
        best = restore_checkpoint(os.path.join(cfg.out_fold, "best.pt"))
        check(live["step"] == spe and len(live["members"]) == M
              and len(best["members"]) == M and best["step"] == spe,
              "the ensemble checkpoint does not hold every member")
        for i, m in enumerate(live["members"]):
            check(not torch.equal(m["model"]["fc6.weight"],
                                  init["members"][i]["model"]["fc6.weight"]),
                  f"member {i} did not move")
        apart = min(max_err(live["members"][i]["model"]["fc6.weight"],
                            live["members"][j]["model"]["fc6.weight"])
                    for i in range(M) for j in range(i + 1, M))
        check(apart > 0, "two members' fc6 weights are equal")
        print(f"members after the epoch: every member moved; fc6.weight "
              f"pairwise max difference at least {apart:.3e}")
        del state

        # ---- 8 replayed ensemble steps against 8 eager ones ----
        it = RatioMixIterator(AugmentedFeatureDataset(feats, aug, "train"),
                              B, 0.5, feat_len=T, seed=7,
                              steps_per_epoch=2 * K).epoch()
        fb = [{k: torch.from_numpy(b[k]) for k in ("feat", "label")}
              for b in it]
        torch.backends.cudnn.deterministic = True
        _, _, st, step, _ = setup_training(cfg, spe, device=DEVICE)
        st.load_state_dict(live)
        multi = make_multi_step(step, K)
        multi(st, stack(fb[:K]))                  # eager K steps, capture
        st.load_state_dict(live)
        m_graph = multi(st, stack(fb[K:]))         # replay
        after_graph = flat_members(copy.deepcopy(st.state_dict()))
        st.load_state_dict(live)
        m_eager = [step(st, b) for b in fb[K:]]
        check_replay(torch, m_graph, after_graph, m_eager,
                     flat_members(st.state_dict()), live["step"], K,
                     f"the M={M} ensemble step")
        del st, multi

        # ---- member i's ensemble step against a single-system step from
        # member i's state (ECAPA draws nothing, so no member draws) ----
        fbatch = {"feat": fb[0]["feat"].to(DEVICE), "label": fb[0]["label"]}
        members_vs_single(torch, cfg, spe, None, live, fbatch, None,
                          lambda i: fbatch, "from features")
        torch.backends.cudnn.deterministic = False

        # ---- times: the K = 8 ensemble graph from features ----
        _, _, st, step, _ = setup_training(cfg, spe, device=DEVICE)
        st.load_state_dict(live)
        multi = make_multi_step(step, K)
        stacked = stack(fb[:K])
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(torch, lambda: multi(st, stacked), iters=3,
                     warmup=2) / K
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        profile_device(torch, lambda: multi(st, stacked), K * ms,
                       f"M={M} bf16 {K}-step ensemble graph replay")
        del st, multi

        # ---- on the fly with the channel augmenter, M = 3, bf16, K = 8:
        # the front-end once a step over the (M B)-row tiled batch ----
        write_corpus(tmp, B, seed=8, part="train")
        write_corpus(tmp, B, seed=9, part="dev")
        n_otf = 2 * K
        otf = TrainConfig(
            out_fold=os.path.join(tmp, "otf"), path_to_database=tmp,
            on_the_fly=True, on_device_aug=True, ratio=1.0, model="ecapa",
            add_loss="ang_iso", batch_size=B, feat_len=T, num_epochs=1, C=C,
            compute_dtype="bfloat16", steps_per_call=K, ensemble=M)
        raw_train = Repeat(RawAudioDataset("LA", tmp, "train"), n_otf)
        torch.cuda.synchronize()
        lc.launches = vj.fwd_launches = vj.bwd_launches = 0
        summary_otf, st_otf = train(
            otf, train_set=raw_train,
            dev_set=RawAudioDataset("LA", tmp, "dev"), device=DEVICE,
            return_state=True)
        torch.cuda.synchronize()
        counts = counts_now()
        counted, _run, replays = graph_launches(n_otf, K, 1)
        print(f"ensemble M={M} on the fly with the augmenter, bf16 K={K}: "
              f"{n_otf} steps (one capture, {replays} replay) and one dev "
              f"batch: launches {counts}")
        check(counts == {"B1": counted + 1, "B4a": M * (counted + 1),
                         "B4b": M * counted},
              f"on-the-fly ensemble launch counts {counts}")
        for k, v in counts.items():
            entries[k]["launches_train_ensemble_otf"] = v
        with open(os.path.join(otf.out_fold, "train_loss.log")) as f:
            otf_losses = np.array([float(line.split()[2])
                                   for line in f.readlines()[1:]])
        check(len(otf_losses) == n_otf and np.isfinite(otf_losses).all()
              and np.isfinite(summary_otf["dev_loss"]),
              f"on-the-fly ensemble losses {otf_losses}, {summary_otf}")
        ws = [m.model.fc6.weight for m in st_otf.members]
        check(all(not torch.equal(ws[i], ws[j]) for i in range(M)
                  for j in range(i + 1, M)), "on-the-fly members are equal")
        print(f"on-the-fly ensemble summary: {summary_otf}")
        otf_live = copy.deepcopy(st_otf.state_dict())
        del st_otf
        fe = OnDeviceFrontend(feat_len=T, augmenter=ChannelAugmenter(
            device=DEVICE), device=DEVICE)
        wb = [{k: torch.from_numpy(b[k]) for k in ("wave", "length",
                                                   "label")}
              for b in WaveformIterator(raw_train, B, fe.min_samples(),
                                        seed=5,
                                        steps_per_epoch=2 * K).epoch()]
        rng = 1

        # ---- B1 on the (M B)-row tiled batch against the plain LFCC,
        # under the augmenter's draws of the next step ----
        tiled = {k: torch.cat([wb[0][k]] * M).to(DEVICE)
                 for k in ("wave", "length")}
        draws = fe.augmenter.draw(tuple(tiled["wave"].shape), step_generator(
            rng, otf_live["step"], DEVICE))
        with torch.no_grad():
            x_otf = fe(tiled, draws)
            with plain_b1():
                x_plain = fe(tiled, draws)
        err = max_err(x_otf, x_plain)
        print(f"on-the-fly ensemble features of the {M * B}-row tiled batch "
              f"{tuple(x_otf.shape)}: B1 vs the plain LFCC max abs err "
              f"{err:.3e} (B1's bar 5e-4)")
        check(x_otf.shape == (M * B, T, 60) and err <= 5e-4,
              f"B1 on the tiled batch vs plain: {x_otf.shape}, {err}")
        rows = [x_otf[i * B:(i + 1) * B] for i in range(M)]
        check(all(not torch.equal(rows[i], rows[j]) for i in range(M)
                  for j in range(i + 1, M)),
              "the augmenter gave two members the same rows")

        # ---- member i's on-the-fly ensemble step (drawing for itself)
        # against a single-system step from member i's state on rows
        # i B .. (i + 1) B - 1 of those features ----
        torch.backends.cudnn.deterministic = True
        members_vs_single(torch, otf, n_otf, fe, otf_live, wb[0], rng,
                          lambda i: {"feat": rows[i], "label": wb[0]["label"]},
                          "on-the-fly")

        # ---- 8 replayed on-the-fly ensemble steps against 8 eager ones
        _, _, st, step, _ = setup_training(otf, n_otf, frontend=fe,
                                           device=DEVICE)
        st.load_state_dict(otf_live)
        multi = make_multi_step(step, K)
        multi(st, stack(wb[:K]), rng)              # eager K steps, capture
        st.load_state_dict(otf_live)
        m_graph = multi(st, stack(wb[K:]), rng)    # replay
        after_graph = flat_members(copy.deepcopy(st.state_dict()))
        st.load_state_dict(otf_live)
        m_eager = [step(st, b, rng) for b in wb[K:]]
        check_replay(torch, m_graph, after_graph, m_eager,
                     flat_members(st.state_dict()), otf_live["step"], K,
                     f"the M={M} on-the-fly ensemble step with the augmenter")
        torch.backends.cudnn.deterministic = False
        st.load_state_dict(otf_live)
        waves = stack(wb[:K])
        torch.cuda.reset_peak_memory_stats()
        ms_otf = time_ms(torch, lambda: multi(st, waves, rng), iters=3,
                         warmup=2) / K
        peak_otf = torch.cuda.max_memory_allocated() / 2 ** 30
        profile_device(torch, lambda: multi(st, waves, rng), K * ms_otf,
                       f"M={M} bf16 {K}-step on-the-fly ensemble replay")
        del st, multi

        # ---- cli.generate_score over 136 LFCC files: member files and
        # their fusion ----
        scores_root = os.path.join(tmp, "score_feats")
        n_utt = 2 * B + 8
        write_feature_tree(os.path.join(scores_root, "dev", "LFCC"), n_utt,
                           7, labeled=True)
        cwd = os.getcwd()
        os.chdir(tmp)              # the 19* tasks write under ./scores
        try:
            base = ["--model_folder", os.path.join(tmp, "runs"), "-n", "ens",
                    "-t", "19dev", "--ori_features", scores_root,
                    "--batch_size", str(B), "--device", DEVICE]
            torch.cuda.synchronize()
            rc.launches = ap.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                fused_path = generate_score.main(base)
            torch.cuda.synchronize()
            score_wall = time.perf_counter() - t0
            n_batches = -(-n_utt // B)
            counts = {"B2": rc.launches, "B3": ap.launches}
            print(f"ensemble scoring, {M} members x {n_batches} batches: "
                  f"launches {counts}")
            check(counts == {"B2": 3 * n_batches * M, "B3": n_batches * M},
                  f"ensemble scoring launch counts {counts}")
            for k, v in counts.items():
                entries[k]["launches_score_ensemble"] = v
            fused = read_score_file(fused_path)
            members = [read_score_file(os.path.join(
                "scores", f"ens_member{i}_19dev_score.txt"))
                for i in range(M)]
            mean = np.mean([m["score"] for m in members], axis=0)
            err = float(np.abs(fused["score"] - mean).max())
            check(len(fused["fname"]) == n_utt and fused["key"] is not None
                  and all(np.array_equal(m["fname"], fused["fname"])
                          for m in members)
                  and np.isfinite(fused["score"]).all() and err <= 1e-6,
                  f"the fused file is not the members' mean ({err})")
            print(f"fused file ({n_utt} 3-column rows) vs the mean of the "
                  f"{M} member files: {err:.3e} (bar 1e-6)")
            # --fusion wght on a tree of the same shapes whose labels carry
            # no signal (every member separates the tree above, so their
            # EERs, all 0, would give equal weights): the members' EERs
            # differ, and the fused file is the members weighted by their
            # entropy weights
            noise_root = os.path.join(tmp, "noise_feats")
            write_feature_tree(os.path.join(noise_root, "dev", "LFCC"),
                               n_utt, 17, labeled=True, shift=0.0)
            base[base.index(scores_root)] = noise_root
            with contextlib.redirect_stdout(io.StringIO()):
                wght = generate_score.main(base + ["--fusion", "wght"])
            files = [os.path.join("scores", f"ens_member{i}_19dev_score.txt")
                     for i in range(M)]
            eers = [eer_from_score_file(f) for f in files]
            w = entropy_weights(eers)
            want = np.sum([wi * read_score_file(f)["score"]
                           for wi, f in zip(w, files)], axis=0)
            got = read_score_file(wght)["score"]
            err = float(np.abs(got - want).max())
            print(f"--fusion wght on {n_utt} files without class signal: "
                  f"member EERs {np.round(eers, 4).tolist()}, weights "
                  f"{np.round(w, 4).tolist()}; fused file vs the weighted "
                  f"sum of the member files {err:.3e} (bar 1e-6)")
            check(len(set(eers)) > 1 and err <= 1e-6
                  and np.isfinite(got).all(),
                  f"--fusion wght: EERs {eers}, fused vs weighted {err}")
        finally:
            os.chdir(cwd)
    print(f"ensemble training [{gpu}] (M={M}, B={B}, T={T}, C={C}, bf16, "
          f"K={K}; CUDA events, host-to-device copies included): from "
          f"features {ms:.3f} ms/step = {B / ms * 1e3:.1f} utt/s "
          f"({M * B / ms * 1e3:.1f} member-utt/s), peak {peak:.2f} GiB; on "
          f"the fly with the augmenter {ms_otf:.3f} ms/step = "
          f"{B / ms_otf * 1e3:.1f} utt/s ({M * B / ms_otf * 1e3:.1f} "
          f"member-utt/s), peak {peak_otf:.2f} GiB; train() {spe} steps "
          f"and a dev pass in {wall:.2f} s (host clock; peak "
          f"{peak_train:.2f} GiB); generate_score of {M} members and their "
          f"fusion {score_wall:.2f} s")


@contextlib.contextmanager
def plain_b2_b3():
    """B2's and B3's plain versions in place of the kernels on CUDA tensors
    (the twin path the int8 tiers are held against in phase 6); the custom
    ops look the launchers up at each call."""
    from asvspoof2021_air_tpu_torch.ops import attn_pool_cuda as ap
    from asvspoof2021_air_tpu_torch.ops import res2_chain_cuda as rc

    saved = rc.res2_chain_kernel, ap.attention_pooling_kernel
    rc.res2_chain_kernel = rc.res2_chain_plain
    ap.attention_pooling_kernel = ap.attention_pooling_plain
    try:
        yield
    finally:
        rc.res2_chain_kernel, ap.attention_pooling_kernel = saved


def synthetic_waves(n: int, seed: int) -> np.ndarray:
    """(n, L) f32 7.49 s utterances as ``write_corpus`` makes them: bona
    fide noise, spoof a tone + noise."""
    g = np.random.default_rng(seed)
    t = np.arange(L) / 16000.0
    out = np.empty((n, L), np.float32)
    for i in range(n):
        wav = 0.1 * g.standard_normal(L)
        if i % 2:
            wav = 0.3 * np.sin(2 * np.pi * (300 + 7 * i) * t) + 0.02 * wav
        out[i] = wav
    return out


def op_device_ms(torch, fn, names):
    """{operator: (calls, device ms)} over one call of fn: the device time
    of the kernels each named operator launched (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {name: (0, 0.0) for name in names}
    for ev in prof.key_averages():
        if ev.key in out:
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = getattr(ev, "cuda_time_total", 0.0)
            out[ev.key] = (ev.count, float(us) / 1e3)
    return out


def cosine_min(torch, a, b) -> float:
    return float(torch.nn.functional.cosine_similarity(
        a.float(), b.float(), dim=1).min())


def int8_export_path(torch, gpu: str, entries, fwd_ms: float):
    """Phase 6: the int8 serving tiers, then the scorer exported by
    ``torch.export``, saved, loaded and run, at full width."""
    import dataclasses

    from asvspoof2021_air_tpu_torch.cli.export import (
        build_score_module, export_system)
    from asvspoof2021_air_tpu_torch.cli.generate_score import load_system
    from asvspoof2021_air_tpu_torch.interop.flax_weights import (
        from_flax_variables, random_flax_variables)
    from asvspoof2021_air_tpu_torch.ops import attn_pool_cuda as ap
    from asvspoof2021_air_tpu_torch.ops import custom_ops
    from asvspoof2021_air_tpu_torch.ops import lfcc_cuda as lc
    from asvspoof2021_air_tpu_torch.ops import res2_chain_cuda as rc
    from asvspoof2021_air_tpu_torch.serving.ecapa_int8 import (
        calibrate_act_scales, pad_time)
    from asvspoof2021_air_tpu_torch.serving.ecapa_serving import ServingECAPA
    from asvspoof2021_air_tpu_torch.train.checkpoint import save_checkpoint
    from asvspoof2021_air_tpu_torch.train.frontend import OnDeviceFrontend
    from asvspoof2021_air_tpu_torch.train.loop import (
        TrainConfig, setup_training)

    def counts():
        return {"B1": lc.launches, "B2": rc.launches, "B3": ap.launches}

    sd = from_flax_variables(random_flax_variables(
        0, C=C, model_scale=8, enc_dim=256), model_scale=8)
    fe = OnDeviceFrontend(feat_len=T, padding="repeat", device=DEVICE)
    full = torch.full((B,), L, device=DEVICE)
    batch_of = lambda seed: {"wave": torch.from_numpy(
        synthetic_waves(B, seed)).to(DEVICE), "length": full}
    tiers = [(q, cal) for q in (True, "mfa", False) for cal in (False, True)]
    name = lambda q, cal: (f"quantize={q!r}, "
                           f"{'calibrated' if cal else 'dynamic'}")
    with torch.inference_mode():
        # JAX calibrates in f32 without the alignment padding.
        scales = calibrate_act_scales(
            sd, [fe(batch_of(s)) for s in (11, 12)], device=DEVICE)
        batch = batch_of(10)
        ref_emb, ref_logits = ServingECAPA(sd, dtype=torch.float32,
                                           device=DEVICE)(fe(batch))
        models = {k: ServingECAPA(sd, dtype=torch.bfloat16, quantize=k[0],
                                  act_scales=scales if k[1] else None,
                                  device=DEVICE) for k in tiers}

        def serve(model):
            """LFCC, then the tier with T padded to a multiple of 8 (JAX's
            fused_chain=True), as phase 3's forward (LFCC + ECAPA)."""
            x, valid = pad_time(fe(batch))
            return model(x, valid_len=valid)

        for m in models.values():             # warm-up (cuBLASLt plans)
            serve(m)
        torch.cuda.synchronize()
        lc.launches = rc.launches = ap.launches = 0
        outs = {k: serve(m) for k, m in models.items()}
        torch.cuda.synchronize()
        got = counts()
        print(f"int8 tiers: launches over one forward of each of the "
              f"{len(tiers)} tiers: {got}")
        check(got == {"B1": len(tiers), "B2": 3 * len(tiers),
                      "B3": len(tiers)},
              f"the int8 tiers did not run B1, B2 3x and B3 once each: {got}")
        for k, v in got.items():
            entries[k]["launches_serve_int8"] = v
        with plain_b2_b3():
            plain = {k: serve(m) for k, m in models.items()}
        print(f"int8 tiers [{gpu}] (B={B}, T={T} padded to "
              f"{-(-T // 8) * 8}, bf16, C={C};"
              f" CUDA events, LFCC included as in phase 3's forward "
              f"{fwd_ms:.3f} ms):")
        tier_ms = {}
        for k in tiers:
            emb, logits = outs[k]
            p_emb, p_logits = plain[k]
            check(bool(torch.isfinite(emb).all() and
                       torch.isfinite(logits).all()),
                  f"{name(*k)}: non-finite outputs")
            cos_ref, cos_plain = (cosine_min(torch, emb, ref_emb),
                                  cosine_min(torch, emb, p_emb))
            ok_ref = bool(torch.allclose(logits, ref_logits, atol=0.05,
                                         rtol=0.1))
            ok_plain = bool(torch.allclose(logits, p_logits, atol=0.05,
                                           rtol=0.1))
            tier_ms[k] = time_ms(torch, lambda: serve(models[k]), iters=10)
            print(f"  {name(*k)}: {tier_ms[k]:.3f} ms/batch "
                  f"({B / tier_ms[k] * 1e3:.1f} utt/s); embedding cosine vs "
                  f"the f32 graph {cos_ref:.6f} (bar 0.999), logits "
                  f"{max_err(logits, ref_logits):.3e} from it (atol 0.05, "
                  f"rtol 0.1: {ok_ref}); vs plain B2/B3 on the card cosine "
                  f"{cos_plain:.7f} (bar 0.9999), logits "
                  f"{max_err(logits, p_logits):.3e} ({ok_plain})")
            check(cos_ref > 0.999 and ok_ref,
                  f"{name(*k)} misses JAX's bars against the f32 graph")
            check(cos_plain > 0.9999 and ok_plain,
                  f"{name(*k)} differs from its plain-B2/B3 twin")
        split = {k: op_device_ms(torch, lambda: serve(models[(k, False)]),
                                 ("aten::_int_mm", "aten::mm"))
                 for k in (True, "mfa", False)}
        for k, ops in split.items():
            print(f"  products, quantize={k!r} (dynamic): "
                  + ", ".join(f"{op} x{n} {ms:.3f} ms"
                              for op, (n, ms) in ops.items()))
        # One MFA third alone: (B T', C) @ (C, 1536), int8 with the weight
        # as the tiers store it ((N, K), passed transposed) and as a (K, N)
        # row-major matrix, against the same product in bf16.
        rows, n_out = B * (-(-T // 8) * 8), 3 * C
        gen = torch.Generator(device=DEVICE).manual_seed(1)
        a8 = torch.randint(-127, 128, (rows, C), generator=gen,
                           device=DEVICE, dtype=torch.int8)
        w8 = torch.randint(-127, 128, (n_out, C), generator=gen,
                           device=DEVICE, dtype=torch.int8)
        w8_kn = w8.t().contiguous()
        ab, wb = a8.bfloat16(), w8_kn.bfloat16()
        ops = 2.0 * rows * C * n_out
        for what, fn, peak in (
                ("_int_mm, weight (N, K) transposed", lambda: torch._int_mm(
                    a8, w8.t()), 1979e12),
                ("_int_mm, weight (K, N) row-major", lambda: torch._int_mm(
                    a8, w8_kn), 1979e12),
                ("bf16 matmul", lambda: ab @ wb, 989e12)):
            ms = time_ms(torch, fn, iters=20)
            print(f"  one MFA third ({rows} x {C} x {n_out}) {what}: "
                  f"{ms:.4f} ms = {ops / ms / 1e9:.0f} TOP/s (bound "
                  f"{ops / peak * 1e3:.4f} ms at the peak)")
        profile_device(torch, lambda: serve(models[(True, False)]),
                       tier_ms[(True, False)], "int8 forward (dynamic)")

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            run = os.path.join(tmp, "runs", "sys")
            cfg = TrainConfig(out_fold=run, model="ecapa", add_loss="ang_iso",
                              on_the_fly=True, C=C, feat_len=T)
            state = setup_training(cfg, 1, device=DEVICE)[2]
            state.model.load_state_dict(sd)
            with torch.no_grad():
                state.loss_module.center.copy_(torch.from_numpy(
                    np.random.default_rng(6).uniform(-1, 1, (1, 256))))
            os.makedirs(run)
            with open(os.path.join(run, "args.json"), "w") as f:
                json.dump(dataclasses.asdict(cfg), f)
            save_checkpoint(os.path.join(run, "best.pt"), state)
            kinds = {"features": {}, "raw": {"raw": True},
                     "int8": {"quantize": "int8"}}
            metas, secs = {}, {}
            lc.launches = rc.launches = ap.launches = 0
            for kind, kw in kinds.items():
                t0 = time.perf_counter()
                metas[kind] = export_system(
                    run, os.path.join(tmp, f"{kind}.pt2"), batch_size=B,
                    check=True, device=DEVICE, **kw)
                torch.cuda.synchronize()
                secs[kind] = time.perf_counter() - t0
            got = counts()
            print(f"export: launches over the three exports' --check runs "
                  f"(artifact and live scorer each): {got}")
            check(got["B1"] >= 2 and got["B2"] >= 18 and got["B3"] >= 6,
                  f"the exported paths did not launch B1-B3: {got}")
            for k, v in got.items():
                entries[k]["launches_export"] = v
            sd_run, loss_mod, cfg_run = load_system(run, device=DEVICE)
            g = np.random.default_rng(0)
            for kind in ("features", "raw"):
                meta = metas[kind]
                frontend = (OnDeviceFrontend(feat_len=T, padding="repeat",
                                             device=DEVICE)
                            if kind == "raw" else None)
                live = build_score_module([sd_run], [loss_mod], cfg_run,
                                          frontend, DEVICE)
                back = torch.export.load(
                    os.path.join(tmp, f"{kind}.pt2")).module()
                if kind == "raw":
                    n = meta["signature"]["wave"][1]
                    args = (torch.from_numpy(g.standard_normal(
                        (B, n)).astype(np.float32) * 0.1).to(DEVICE),
                        torch.full((B,), n, dtype=torch.int32,
                                   device=DEVICE))
                else:
                    args = (torch.from_numpy(g.standard_normal(
                        (B, T, 60)).astype(np.float32)).to(DEVICE),)
                with torch.no_grad():
                    lc.launches = rc.launches = ap.launches = 0
                    got_scores = back(*args)
                    torch.cuda.synchronize()
                    ran = counts()
                    want = live(*args)
                    err = max_err(got_scores, want)
                    art_ms = time_ms(torch, lambda: back(*args), iters=10)
                    live_ms = time_ms(torch, lambda: live(*args), iters=10)
                graph_ops = {op: sum(
                    str(nd.target) == f"{custom_ops.NAMESPACE}.{op}.default"
                    for nd in back.graph.nodes) for op in custom_ops.OPS}
                want_ran = {"B1": int(kind == "raw"), "B2": 3, "B3": 1}
                print(f"export {kind} [{gpu}]: {meta['bytes']} bytes, "
                      f"export + save + --check {secs[kind]:.1f} s; graph "
                      f"custom ops {graph_ops}; one run of the loaded "
                      f"artifact launched {ran}; scores vs the live scorer "
                      f"{err:.3e} (bar 1e-5); artifact {art_ms:.3f} ms/batch"
                      f" vs live {live_ms:.3f} ms/batch (B={B}, f32, CUDA "
                      f"events)")
                check(ran == want_ran and err <= 1e-5
                      and bool(torch.isfinite(got_scores).all()),
                      f"export {kind}: launches {ran}, error {err}")
            q = metas["int8"]
            print(f"export int8 [{gpu}]: {q['bytes']} bytes, parameters "
                  f"{q['param_bytes_int8']} bytes int8 vs "
                  f"{q['param_bytes_f32']} f32 "
                  f"({q['param_bytes_int8'] / q['param_bytes_f32']:.3f}); "
                  f"scores {q['quantized_score_max_dev']:.3e} from the "
                  f"float system, rank agreement "
                  f"{q['quantized_rank_agreement']:.4f}; export + save + "
                  f"--check {secs['int8']:.1f} s")
            check(q["param_bytes_int8"] < 0.35 * q["param_bytes_f32"]
                  and q["quantized_score_max_dev"] < 0.05,
                  f"export int8: {q}")
        finally:
            os.chdir(cwd)


# ---------------------------------------------------------------- phase 7


def sync(torch) -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def to_cpu(tree):
    import torch

    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree


def state_hash(sd) -> str:
    """A digest of every tensor of a state_dict (bitwise equality)."""
    import hashlib

    import torch

    h = hashlib.sha256()

    def walk(x):
        if torch.is_tensor(x):
            h.update(x.detach().cpu().contiguous().view(-1).view(
                torch.uint8).numpy().tobytes())
        elif isinstance(x, dict):
            for k in sorted(x):
                h.update(str(k).encode())
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            h.update(repr(x).encode())

    walk(sd)
    return h.hexdigest()


def kernel_counts():
    """Every kernel wrapper's launch count in this process."""
    from asvspoof2021_air_tpu_torch.ops import attn_pool_cuda as ap
    from asvspoof2021_air_tpu_torch.ops import attn_pool_vjp as vj
    from asvspoof2021_air_tpu_torch.ops import lfcc_cuda as lc
    from asvspoof2021_air_tpu_torch.ops import res2_chain_cuda as rc

    return {"B1": lc.launches, "B2": rc.launches, "B3": ap.launches,
            "B4a": vj.fwd_launches, "B4b": vj.bwd_launches}


def zero_counts() -> None:
    from asvspoof2021_air_tpu_torch.ops import attn_pool_cuda as ap
    from asvspoof2021_air_tpu_torch.ops import attn_pool_vjp as vj
    from asvspoof2021_air_tpu_torch.ops import lfcc_cuda as lc
    from asvspoof2021_air_tpu_torch.ops import res2_chain_cuda as rc

    lc.launches = rc.launches = ap.launches = 0
    vj.fwd_launches = vj.bwd_launches = 0


def step_record(torch, st, metrics):
    """A train step's metrics, gradients (the loss module's as ``loss.*``)
    and BN running statistics, copied."""
    grads = {n: p.grad.detach().clone()
             for n, p in st.model.named_parameters()}
    grads.update({f"loss.{n}": p.grad.detach().clone()
                  for n, p in st.loss_module.named_parameters()})
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads,
            "running": {k: v.detach().clone()
                        for k, v in st.model.state_dict().items()
                        if k.endswith(RUNNING)}}


def check_dp_step(torch, got, cfg, frontend, live, batch, rng, tag: str,
                  eps: float):
    """A data-parallel step's record ``got`` (:func:`step_record`, the
    gradients all-reduced) from state ``live`` on the global ``batch``
    against the one-process step of ``cfg`` on it, at phase 4's bars: the
    metrics rtol 1e-4 (bf16, ``eps`` 2^-7: one bf16 ulp, 2^-8, relative);
    each gradient's error norm within max(1e-2, 4 x the one-process step's
    own spread: two runs, and the batch reversed) of its norm, the
    gradients that are zero there zero here; each BN statistic within
    rtol and atol 1e-5, or one input ulp (``bn_ulp_bars``)."""
    from asvspoof2021_air_tpu_torch.train.loop import setup_training

    runs = []
    flip = {k: v.flip(0) for k, v in batch.items()}
    for b in (batch, batch, flip):
        _, _, st, step, _ = setup_training(cfg, 4, frontend=frontend,
                                           device=DEVICE)
        st.load_state_dict(live)
        runs.append(step_record(torch, st, step(st, b, rng)))
    want, again, rev = runs
    rtol = 1e-4 if eps < 1e-3 else 2.0 ** -8
    for k, b in want["metrics"].items():
        a = got["metrics"][k]
        print(f"{tag}: {k} {a:.7f} vs one process {b:.7f} (rtol {rtol:.1e})")
        check(abs(a - b) <= rtol * abs(b), f"{tag} {k}: {a} vs {b}")
    g_p = want["grads"]
    # the attention BN's bias: a gradient of rounding noise (softmax over
    # T cancels its shift), held under 1e-4 of the largest element, or 4 x
    # the one-process step's own reading where that is larger (step_vs_plain)
    shift = "attention.2.bias"
    top = max(float(g.abs().max()) for g in g_p.values())
    noise = [float(r["grads"][shift].abs().max()) / top
             for r in (got, want, again, rev)]
    noise_bar = max(1e-4, 4 * max(noise[1:]))
    print(f"{tag}: {shift} gradient {noise[0]:.3e} of the largest element "
          f"(one process {max(noise[1:]):.3e}; bar {noise_bar:.1e})")
    check(noise[0] <= noise_bar, f"{tag} {shift} gradient: {noise}")
    names = [n for n in g_p if n != shift and g_p[n].abs().max() > 0]
    norm_err = lambda g: max(
        (float((g[n].to(g_p[n].device) - g_p[n]).norm() / g_p[n].norm()), n)
        for n in names)
    worst, spread = norm_err(got["grads"]), max(norm_err(again["grads"]),
                                                norm_err(rev["grads"]))
    bar = max(1e-2, 4 * spread[0])
    print(f"{tag}: largest gradient error norm {worst[0]:.3e} of its "
          f"tensor's ({worst[1]}; bar {bar:.3e}); the one-process step's "
          f"spread {spread[0]:.3e} ({spread[1]})")
    check(worst[0] <= bar, f"{tag} gradients disagree: {worst}")
    for n in g_p:
        if n != shift and float(g_p[n].abs().max()) == 0:
            check(bool((got["grads"][n] == 0).all()),
                  f"{tag} gradient {n} not zero")
    s_p = want["running"]
    before = {k: v.to(DEVICE) for k, v in live["model"].items()}
    ulp = bn_ulp_bars(torch, st.model, before, s_p, eps)
    worst_stat = max((max_err(got["running"][k].to(v.device), v), k)
                     for k, v in s_p.items())
    print(f"{tag}: BN statistics largest difference {worst_stat[0]:.3e} "
          f"({worst_stat[1]}; rtol {rtol:.1e}, atol 1e-5, or one input ulp)")
    for k, v in s_p.items():
        bar_k = torch.maximum(rtol * v.abs() + 1e-5, ulp[k])
        check(bool(((got["running"][k].to(v.device) - v).abs()
                    <= bar_k).all()), f"{tag} BN statistic {k} disagrees")


def check_members(torch, got, want, what: str) -> None:
    """Member states ``got`` against ``want`` (``TrainState.state_dict``
    each): model, loss module and Adam states, rtol 1e-6 and atol 1e-9, and
    the step (phases 5b and 7b)."""
    same = total = 0
    for i, (g, w) in enumerate(zip(got, want)):
        pairs = [(f"{part} {n}", v, w[part][n])
                 for part in ("model", "loss_module")
                 for n, v in g[part].items()]
        pairs += [(f"optimizer {n} {k}", t, w["optimizer"][n][k])
                  for n, st_ in g["optimizer"].items()
                  for k, t in st_.items()]
        pairs = [(n, a.cpu(), b.cpu()) for n, a, b in pairs]
        same += sum(torch.equal(a, b) for _, a, b in pairs)
        total += len(pairs)
        bad = [n for n, a, b in pairs
               if not torch.allclose(a, b, rtol=1e-6, atol=1e-9)]
        check(not bad and g["step"] == w["step"],
              f"member {i}: {what}: {bad[:5]}")
    print(f"{what}: {same} of {total} tensors bitwise equal (bar rtol "
          f"1e-6, atol 1e-9)")


def dp_inputs(torch, tmp: str):
    """Phase 7's states and batches at full width, written for the ranks:
    an f32 ECAPA-512 state and a 2-member ensemble from seeds, a waveform
    batch of B, a feature batch of B and two of 16, and a dev tree of 2 B
    + 3 LFCC files."""
    from asvspoof2021_air_tpu_torch.data.datasets import RawAudioDataset
    from asvspoof2021_air_tpu_torch.data.pipeline import WaveformIterator
    from asvspoof2021_air_tpu_torch.train.frontend import OnDeviceFrontend
    from asvspoof2021_air_tpu_torch.train.loop import setup_training

    write_corpus(tmp, B, seed=31, part="train")
    fe = OnDeviceFrontend(feat_len=T, device=DEVICE)
    raw = RawAudioDataset("LA", tmp, "train")
    wave = next(iter(WaveformIterator(raw, B, fe.min_samples(), seed=5,
                                      steps_per_epoch=1).epoch()))
    feats = os.path.join(tmp, "feats")
    write_feature_tree(os.path.join(feats, "dev", "LFCC"), 2 * B + 3, 32,
                       True)
    g = np.random.default_rng(33)
    labels = (np.arange(B) % 2).astype(np.int32)
    fbatch = {"feat": torch.from_numpy((g.standard_normal((B, T, 60))
                                        + 0.5 * labels[:, None, None]
                                        ).astype(np.float32)),
              "label": torch.from_numpy(labels)}
    lab16 = torch.arange(16, dtype=torch.int32) % 2
    small = [{"feat": torch.from_numpy(g.standard_normal(
        (16, T, 60)).astype(np.float32)) + 0.5 * lab16[:, None, None],
        "label": lab16} for _ in range(2)]
    cfg = dp_config()
    live = setup_training(cfg, 4, device=DEVICE)[2].state_dict()
    # the members one step on (Adam's first step, lr sign(g), would turn
    # rounding noise in a near-zero gradient into a step of lr)
    _, _, est, estep, _ = setup_training(dp_config(ensemble=2), 4,
                                         device=DEVICE)
    estep(est, {"feat": fbatch["feat"].flip(0), "label": fbatch["label"]})
    ens = est.state_dict()
    del est, estep
    inputs = {"live": to_cpu(live), "ens_live": to_cpu(ens), "rng": 17,
              "wave": {k: torch.from_numpy(wave[k])
                       for k in ("wave", "length", "label")},
              "fbatch": fbatch, "small": small, "feats": feats,
              "t0": time.perf_counter()}
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    return inputs


def dp_config(**kw):
    """Phase 7's ECAPA-TDNN-512 + ang_iso f32 configuration, batch B."""
    from asvspoof2021_air_tpu_torch.train.loop import TrainConfig

    fields = dict(model="ecapa", add_loss="ang_iso", batch_size=B,
                  feat_len=T, C=C, ratio=1.0)
    fields.update(kw)
    return TrainConfig(**fields)


def rank_7b(torch, rank: int, tmp: str, inputs):
    """Rank ``rank`` of phase 7b's 2 ranks over gloo (CUDA tensors): the
    data-parallel f32 step on the fly, sharded scoring, the member-parallel
    M = 2 step."""
    from asvspoof2021_air_tpu_torch.data.datasets import (
        ASVspoof2019FeatureDataset)
    from asvspoof2021_air_tpu_torch.parallel import make_mesh, shard_batch
    from asvspoof2021_air_tpu_torch.scoring import (
        make_score_fn, score_to_file)
    from asvspoof2021_air_tpu_torch.train.ensemble import ensemble_mesh
    from asvspoof2021_air_tpu_torch.train.frontend import OnDeviceFrontend
    from asvspoof2021_air_tpu_torch.train.loop import setup_training

    out = {"seconds": {}}
    t0 = time.perf_counter()
    mesh = make_mesh(DEVICE)
    fe = OnDeviceFrontend(feat_len=T, device=DEVICE)
    cfg = dp_config(on_the_fly=True)
    _, _, st, step, _ = setup_training(cfg, 4, frontend=fe, device=DEVICE,
                                       mesh=mesh)
    st.load_state_dict(inputs["live"])
    sync(torch)
    zero_counts()
    metrics = step(st, shard_batch(inputs["wave"], mesh), inputs["rng"])
    sync(torch)
    out["dp_counts"] = kernel_counts()
    rec = step_record(torch, st, metrics)
    out["dp"] = to_cpu(rec) if rank == 0 else None
    out["dp_hash"] = state_hash(st.state_dict())
    del st, step
    out["seconds"]["dp"] = time.perf_counter() - t0

    fn = make_score_fn(inputs["live"]["model"], device=DEVICE)
    ds = ASVspoof2019FeatureDataset("LA", inputs["feats"], "dev")
    zero_counts()
    score_to_file(fn, ds, os.path.join(tmp, "sharded_scores.txt"), True,
                  batch_size=B, feat_len=T, shard=mesh)
    sync(torch)
    out["score_counts"] = kernel_counts()
    out["seconds"]["score"] = time.perf_counter() - t0

    _, _, est, estep, _ = setup_training(
        dp_config(ensemble=2), 4, device=DEVICE, mesh=ensemble_mesh(2, DEVICE))
    est.load_state_dict(inputs["ens_live"])
    sync(torch)
    zero_counts()
    torch.backends.cudnn.deterministic = True
    estep(est, inputs["fbatch"])
    torch.backends.cudnn.deterministic = False
    sync(torch)
    out["member_counts"] = kernel_counts()
    out["member_ids"] = est.member_ids
    out["members"] = to_cpu(est.state_dict()["members"])
    out["seconds"]["member"] = time.perf_counter() - t0
    return out


def rank_7c(torch, rank: int, tmp: str, inputs):
    """Rank ``rank`` of phase 7c's 4 ranks over gloo: 2 steps of the 2 x 2
    member x data step from features, global B = 16 (8 a data shard)."""
    from asvspoof2021_air_tpu_torch.train.ensemble import member_data_mesh
    from asvspoof2021_air_tpu_torch.train.loop import setup_training

    mesh = member_data_mesh(2, 2, DEVICE)
    j = mesh.index("data")
    _, _, est, estep, _ = setup_training(
        dp_config(ensemble=2, batch_size=16), 4, device=DEVICE, mesh=mesh)
    est.load_state_dict(inputs["ens_live"])
    sync(torch)
    zero_counts()
    losses = [float(estep(est, {k: v[8 * j:8 * (j + 1)]
                                for k, v in b.items()})["ang_iso"])
              for b in inputs["small"]]
    sync(torch)
    sd = est.state_dict()
    return {"counts": kernel_counts(), "coords": (mesh.index("model"), j),
            "ids": est.member_ids, "losses": losses, "step": sd["step"],
            "hash": state_hash(sd["members"]),
            "conv1": sd["members"][0]["model"]["conv1.weight"].cpu()}


def dp_rank(rank: int, world: int, port: int, tmp: str, task: str,
            sizes: dict) -> None:
    """One spawned rank of phase 7b or 7c: gloo over CUDA tensors on the
    one card (NCCL refuses two ranks on one device), at the parent's
    ``sizes`` (DEVICE, B, T, C, L); writes its results to
    ``<tmp>/<task>_rank<r>.pt``; any failure exits non-zero."""
    import traceback

    globals().update(sizes)
    try:
        import torch
        import torch.distributed as dist

        from asvspoof2021_air_tpu_torch._device import disable_tf32
        from asvspoof2021_air_tpu_torch.ops import _build
        from asvspoof2021_air_tpu_torch.parallel import (
            initialize_distributed)

        os.environ["LOCAL_RANK"] = "0"      # every rank on the one card
        disable_tf32()
        initialize_distributed(f"127.0.0.1:{port}", world, rank,
                               device=DEVICE, backend="gloo")
        if DEVICE == "cuda":
            _build.library()        # built by the parent: loaded
        else:
            torch.set_num_threads(1)
        inputs = torch.load(os.path.join(tmp, "inputs.pt"),
                            weights_only=False)
        t0 = time.perf_counter()
        out = {"7b": rank_7b, "7c": rank_7c}[task](torch, rank, tmp, inputs)
        out["started_s"] = t0 - inputs["t0"]        # spawn and set-up
        torch.save(out, os.path.join(tmp, f"{task}_rank{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)


def start_ranks(task: str, world: int, tmp: str):
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    sizes = {"DEVICE": DEVICE, "B": B, "T": T, "C": C, "L": L}
    procs = [ctx.Process(target=dp_rank,
                         args=(r, world, port, tmp, task, sizes))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join_ranks(torch, task: str, procs, tmp: str, timeout: float):
    """Each rank's results; a rank that failed or outlived ``timeout``
    (then killed, with the others) fails the phase."""
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    check(not alive, f"phase 7 {task}: {len(alive)} rank(s) still running "
                     f"after {timeout} s, killed")
    codes = [p.exitcode for p in procs]
    check(not any(codes), f"phase 7 {task}: ranks exited with {codes}")
    return [torch.load(os.path.join(tmp, f"{task}_rank{r}.pt"),
                       weights_only=False) for r in range(len(procs))]


def add_counts(entries, path: str, counts) -> None:
    for k, v in counts.items():
        if v:
            entries[k][f"launches_{path}"] = (
                entries[k].get(f"launches_{path}", 0) + v)


def data_parallel_path(torch, gpu: str, entries, bf16_ms):
    """Phase 7: the multi-GPU layer on the one card. 7b and 7c run in
    spawned ranks over gloo with CUDA tensors (2 and 4 processes on the
    card; NCCL refuses two ranks on one device) while this process computes
    their references; then 7a here over NCCL at world size 1, timed alone."""
    import dataclasses

    import torch.distributed as dist

    from asvspoof2021_air_tpu_torch.data.datasets import (
        ASVspoof2019FeatureDataset, RawAudioDataset)
    from asvspoof2021_air_tpu_torch.data.pipeline import WaveformIterator
    from asvspoof2021_air_tpu_torch.parallel import (
        initialize_distributed, make_mesh)
    from asvspoof2021_air_tpu_torch.scoring import (
        make_score_fn, score_to_file)
    from asvspoof2021_air_tpu_torch.train.frontend import OnDeviceFrontend
    from asvspoof2021_air_tpu_torch.train.loop import (
        TrainConfig, setup_training, train)
    from asvspoof2021_air_tpu_torch.train.steps import make_multi_step

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        inputs = dp_inputs(torch, tmp)
        ranks_b = start_ranks("7b", 2, tmp)
        ranks_c = start_ranks("7c", 4, tmp)

        # ---- the references of 7b, meanwhile ----
        fe = OnDeviceFrontend(feat_len=T, device=DEVICE)
        live = inputs["live"]
        fn = make_score_fn(live["model"], device=DEVICE)
        one = score_to_file(fn, ASVspoof2019FeatureDataset(
            "LA", inputs["feats"], "dev"), os.path.join(tmp, "one.txt"),
            True, batch_size=B, feat_len=T)
        _, _, est, estep, _ = setup_training(dp_config(ensemble=2), 4,
                                             device=DEVICE)
        est.load_state_dict(inputs["ens_live"])
        torch.backends.cudnn.deterministic = True
        estep(est, inputs["fbatch"])
        torch.backends.cudnn.deterministic = False
        want_members = to_cpu(est.state_dict()["members"])
        del est, estep

        refs_s = time.perf_counter() - t0
        res_b = join_ranks(torch, "7b", ranks_b, tmp, 300)
        res_c = join_ranks(torch, "7c", ranks_c, tmp, 300)
        ranks_s = time.perf_counter() - t0
        print(f"phase 7: inputs and this process's references "
              f"{refs_s:.1f} s; ranks started their work after "
              f"{[round(r['started_s'], 1) for r in res_b + res_c]} s; 7b "
              f"ranks' seconds {[r['seconds'] for r in res_b]}; all ranks "
              f"joined after {ranks_s:.1f} s")

        # ---- 7b: data parallel, 2 ranks of 32 ----
        check(res_b[0]["dp_hash"] == res_b[1]["dp_hash"],
              "7b: the two ranks' states differ after the step")
        wave = {k: v.to(DEVICE) for k, v in inputs["wave"].items()}
        check_dp_step(torch, res_b[0]["dp"], dp_config(on_the_fly=True), fe,
                      live, wave, inputs["rng"],
                      "7b f32 2-rank step (gloo) vs one process B=64",
                      2.0 ** -23)
        with open(one) as f:
            want_rows = [r.split() for r in f]
        with open(os.path.join(tmp, "sharded_scores.txt")) as f:
            got_rows = [r.split() for r in f]
        check(len(got_rows) == len(want_rows) == 2 * B + 3
              and all(a[0] == b[0] and a[2] == b[2]
                      for a, b in zip(got_rows, want_rows)),
              "7b sharded score file: names or keys differ")
        diff = max(abs(float(a[1]) - float(b[1]))
                   for a, b in zip(got_rows, want_rows))
        print(f"7b sharded scoring of {2 * B + 3} files over 2 ranks vs one "
              f"process: largest score difference {diff:.3e} (bar 1e-5)")
        check(diff <= 1e-5, f"7b sharded scores: {diff}")
        got = {r["member_ids"][0]: r["members"][0] for r in res_b}
        check(sorted(got) == [0, 1], f"7b members {sorted(got)}")
        check_members(torch, [got[0], got[1]], want_members,
                      "7b member-parallel M=2 (one member a rank) vs the "
                      "one-card ensemble step")
        for path, key in (("train_dp", "dp_counts"),
                          ("score_dp", "score_counts"),
                          ("train_member_dp", "member_counts")):
            counts = {k: sum(r[key][k] for r in res_b) for k in res_b[0][key]}
            print(f"7b {path} launches over both ranks: {counts}")
            add_counts(entries, path, counts)
        nb = -(-(2 * B + 3) // B)
        check(sum(r["score_counts"]["B2"] for r in res_b) == 2 * 3 * nb
              and sum(r["score_counts"]["B3"] for r in res_b) == 2 * nb,
              "7b score_dp launch counts")
        check(all(r["dp_counts"]["B1"] == 1 and r["dp_counts"]["B4b"] == 1
                  for r in res_b), "7b train_dp launch counts")
        check(all(r["member_counts"]["B4b"] == 1 for r in res_b),
              "7b train_member_dp launch counts")

        # ---- 7c: member x data 2 x 2 ----
        by_member = {}
        for r, res in enumerate(res_c):
            check(tuple(res["coords"]) == (r // 2, r % 2)
                  and list(res["ids"]) == [r // 2]
                  and res["step"] == inputs["ens_live"]["step"] + 2
                  and all(np.isfinite(res["losses"])),
                  f"7c rank {r}: {res['coords']}, {res['ids']}, "
                  f"{res['losses']}")
            by_member.setdefault(r // 2, set()).add(res["hash"])
        check(all(len(h) == 1 for h in by_member.values()),
              "7c: a member's replicas differ across its data shards")
        check(by_member[0] != by_member[1]
              and not torch.equal(res_c[0]["conv1"], res_c[2]["conv1"]),
              "7c: the two members are equal")
        counts = {k: sum(r["counts"][k] for r in res_c)
                  for k in res_c[0]["counts"]}
        check(counts["B4b"] == 4 * 2, f"7c launches {counts}")
        add_counts(entries, "train_member_data_dp", counts)
        print(f"7c 2 x 2 member x data, 2 steps: each member's replicas "
              f"bitwise equal on its 2 data shards, the members apart; "
              f"losses {[res_c[0]['losses'], res_c[2]['losses']]}; "
              f"launches over the 4 ranks {counts}")

        # ---- 7a: NCCL at world size 1 in this process ----
        initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                               device=DEVICE)
        check(DEVICE != "cuda" or dist.get_backend() == "nccl",
              "7a: not NCCL")
        try:
            K, n_otf = 8, 16
            write_corpus(tmp, B, seed=34, part="dev")
            cfg = dp_config(out_fold=os.path.join(tmp, "dp_run"),
                            path_to_database=tmp, on_the_fly=True,
                            num_epochs=1, compute_dtype="bfloat16",
                            steps_per_call=K)
            raw = Repeat(RawAudioDataset("LA", tmp, "train"), n_otf)
            sync(torch)
            zero_counts()
            summary, state = train(cfg, train_set=raw,
                                   dev_set=RawAudioDataset("LA", tmp, "dev"),
                                   device=DEVICE, return_state=True)
            sync(torch)
            counts = kernel_counts()
            counted, run, replays = graph_launches(n_otf, K, 1)
            print(f"7a train() over NCCL at world 1, bf16, K={K}: "
                  f"{n_otf} steps (one capture, {replays} replay(s)) and a "
                  f"dev batch: launches {counts}; per kernel of the step "
                  f"counted {counted}, run {run}; {summary}")
            check({k: counts[k] for k in ("B1", "B4a", "B4b")}
                  == {"B1": counted + 1, "B4a": counted + 1,
                      "B4b": counted}, f"7a launch counts {counts}")
            add_counts(entries, "train_dp", counts)
            live = state.state_dict()
            del state
            mesh = make_mesh(DEVICE)
            waves = [{k: torch.from_numpy(b[k]) for k in ("wave", "length",
                                                          "label")}
                     for b in WaveformIterator(raw, B, fe.min_samples(),
                                               seed=5,
                                               steps_per_epoch=2 * K).epoch()]
            k1 = dataclasses.replace(cfg, steps_per_call=1)
            _, _, st, step, _ = setup_training(k1, 4, frontend=fe,
                                               device=DEVICE, mesh=mesh)
            st.load_state_dict(live)
            rec = step_record(torch, st, step(st, waves[0], 3))
            del st
            check_dp_step(torch, rec, k1, fe, live, waves[0], 3,
                          "7a bf16 data-parallel step (NCCL, world 1) vs "
                          "the one-process step", 2.0 ** -7)
            stack = lambda bs: {k: torch.stack([b[k] for b in bs])
                                for k in bs[0]}
            torch.backends.cudnn.deterministic = True
            _, _, st, step, _ = setup_training(cfg, 4, frontend=fe,
                                               device=DEVICE, mesh=mesh)
            st.load_state_dict(live)
            multi = make_multi_step(step, K)
            multi(st, stack(waves[:K]), 3)         # eager K, then capture
            st.load_state_dict(live)
            m_graph = multi(st, stack(waves[K:]), 3)
            after_graph = copy.deepcopy(st.state_dict())
            st.load_state_dict(live)
            m_eager = [step(st, b, 3) for b in waves[K:]]
            after_eager = st.state_dict()
            torch.backends.cudnn.deterministic = False
            check_replay(torch, m_graph, after_graph, m_eager, after_eager,
                         live["step"], K, "the data-parallel step with its "
                         "NCCL all-reduces captured")
            # ms a step: the one-process and the data-parallel K-step
            # graphs in turns
            _, _, st1, step1, _ = setup_training(cfg, 4, frontend=fe,
                                                 device=DEVICE)
            st1.load_state_dict(live)
            multi1 = make_multi_step(step1, K)
            batches = stack(waves[:K])
            runs = {"one process": lambda: multi1(st1, batches, 3),
                    "data parallel": lambda: multi(st, batches, 3)}
            times = {k: [] for k in runs}
            for name in ("one process", "data parallel", "data parallel",
                         "one process"):
                times[name].append(time_ms(torch, runs[name], iters=3) / K)
            ms = {k: float(np.mean(v)) for k, v in times.items()}
            print(f"7a bf16 K={K} on the fly [{gpu}] (B={B}, T={T}, C={C}; "
                  f"CUDA events, in turns): one process "
                  f"{ms['one process']:.3f} ms/step, data parallel over "
                  f"NCCL at world 1 {ms['data parallel']:.3f} ms/step "
                  f"(runs {times}); phase 4b's on the fly "
                  f"{bf16_ms:.3f} ms/step")
            del st, st1, multi, multi1
        finally:
            dist.destroy_process_group()
    print(f"phase 7: ranks of 7b and 7c (spawn, CUDA set-up, work, their "
          f"references) {ranks_s:.1f} s")



# Phase 8: utterances a part of the degraded corpus, the training batch
DEG_N, DEG_B = 32, 8


def _wav_tree_check(out_dir: str, sources, names, what: str) -> None:
    """Every file of ``out_dir`` one of ``names``, of its source's length,
    finite and unlike its source (``sources``: stem -> samples)."""
    from asvspoof2021_air_tpu_torch.data.audio_io import read_wav

    got = sorted(os.listdir(out_dir))
    check(got == sorted(names), f"{what}: files {got[:4]}... not the names "
                                f"expected {sorted(names)[:4]}...")
    for f in got:
        w, sr = read_wav(os.path.join(out_dir, f))
        src = sources[f[:12]]
        check(sr == 16000 and w.size == src.size
              and bool(np.isfinite(w).all()), f"{what}: {f} malformed")
        check(not np.array_equal(w, src), f"{what}: {f} equals its source")


def _same_tree(a: str, b: str) -> bool:
    import filecmp

    names = sorted(os.listdir(a))
    return names == sorted(os.listdir(b)) and all(
        filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False)
        for n in names)


def degraded_corpus_path(torch, gpu: str, entries):
    """Phase 8: the augmented pipeline without JAX. 8a: ``cli.degrade``
    of a synthetic corpus on the host (channel at -j 1 and -j 4, byte-equal;
    compression; make-irs and device); 8b: ``cli.preprocess`` of the
    original and degraded trees through B1, ``train()`` bf16 K = 8 with
    LA_aug and ADV_AUG from them, ``cli.generate_score -t 19laaugdev``
    through B2 and B3; 8c: one f32 ECAPA step with ``fused_chain``, with
    ``remat_policy="conv_dot"`` and with neither."""
    import dataclasses
    import io

    from asvspoof2021_air_tpu_torch.cli import degrade, generate_score
    from asvspoof2021_air_tpu_torch.cli import preprocess
    from asvspoof2021_air_tpu_torch.data import system_codecs
    from asvspoof2021_air_tpu_torch.data.audio_io import read_wav
    from asvspoof2021_air_tpu_torch.data.datasets import (
        AugmentedFeatureDataset)
    from asvspoof2021_air_tpu_torch.data.pipeline import (
        RatioMixIterator, SequentialIterator)
    from asvspoof2021_air_tpu_torch.ops import attn_pool_cuda as ap
    from asvspoof2021_air_tpu_torch.ops import attn_pool_vjp as vj
    from asvspoof2021_air_tpu_torch.ops import lfcc_cuda as lc
    from asvspoof2021_air_tpu_torch.ops import res2_chain_cuda as rc
    from asvspoof2021_air_tpu_torch.scoring import make_score_fn
    from asvspoof2021_air_tpu_torch.train.loop import (
        TrainConfig, setup_training, train)
    from asvspoof2021_air_tpu_torch.train.steps import make_multi_step

    quiet = lambda: contextlib.redirect_stdout(io.StringIO())
    K, E, Bt = 8, 2, DEG_B
    counts = lambda: {"B1": lc.launches, "B2": rc.launches, "B3": ap.launches,
                      "B4a": vj.fwd_launches, "B4b": vj.bwd_launches}

    def zero():
        lc.launches = rc.launches = ap.launches = 0
        vj.fwd_launches = vj.bwd_launches = 0

    lengths = np.random.default_rng(80).integers(48000, 64001, 2 * DEG_N)
    with tempfile.TemporaryDirectory() as tmp:
        db = os.path.join(tmp, "db")
        for i, part in enumerate(("train", "dev")):
            # the training tags of ASVspoof 2019 LA (A01 - A06)
            write_corpus(db, DEG_N, 81 + i, part, "wav",
                         lengths[i * DEG_N:(i + 1) * DEG_N], "A01")
        wav_dir = lambda part: os.path.join(db, "LA",
                                            f"ASVspoof2019_LA_{part}", "wav")
        sources = {f[:-4]: read_wav(os.path.join(wav_dir(p), f))[0]
                   for p in ("train", "dev") for f in os.listdir(wav_dir(p))}
        protdir = os.path.join(db, "LA", "ASVspoof2019_LA_cm_protocols")
        secs = float(lengths.mean()) / 16000

        # ---- 8a: the corpus, on the host ----
        aug = os.path.join(tmp, "aug_wavs")
        rates = {}

        def run(argv, what, n_files):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                degrade.main(argv)
            rates[what] = n_files / (time.perf_counter() - t0)
            return buf.getvalue()

        out = run(["channel", "-i", wav_dir("train"), "-o",
                   os.path.join(aug, "train"), "--sampling", "random",
                   "--fidelity", "native", "--seed", "3", "-j", "1"],
                  "channel -j 1", DEG_N)
        check("fidelity native -> native (silk tier)" in out,
              f"cli.degrade did not name its tier: {out!r}")
        run(["channel", "-i", wav_dir("train"), "-o",
             os.path.join(tmp, "aug_j4"), "--sampling", "random",
             "--fidelity", "native", "--seed", "3", "-j", "4"],
            "channel -j 4", DEG_N)
        check(_same_tree(os.path.join(aug, "train"),
                         os.path.join(tmp, "aug_j4")),
              "cli.degrade channel: -j 1 and -j 4 trees differ")
        run(["channel", "-i", wav_dir("dev"), "-o", os.path.join(aug, "dev"),
             "--sampling", "random", "--fidelity", "native", "--seed", "4",
             "-j", "4"], "channel dev -j 4", DEG_N)
        vocabulary = (degrade.LANDLINE + degrade.VOIP + degrade.CELLULAR
                      + degrade.COMMON)
        for part in ("train", "dev"):
            names = os.listdir(os.path.join(aug, part))
            check(len(names) == DEG_N and all(
                n[:12] in sources and n[13:-4] in vocabulary
                for n in names), f"channel {part}: names {names[:3]}")
            _wav_tree_check(os.path.join(aug, part), sources, names,
                            f"channel {part}")
        codecs = sorted(n[13:-4] for n in os.listdir(os.path.join(
            aug, "train")))
        run(["compression", "-i", wav_dir("dev"), "-o",
             os.path.join(tmp, "compressed"), "--sampling", "random",
             "--seed", "5", "-j", "4"], "compression -j 4", DEG_N)
        names = os.listdir(os.path.join(tmp, "compressed"))
        check(all(n[13:-4] in degrade.COMPRESSION for n in names),
              f"compression names {names[:3]}")
        _wav_tree_check(os.path.join(tmp, "compressed"), sources, names,
                        "compression")
        irs = os.path.join(tmp, "irs")
        run(["make-irs", "-o", irs, "--seed", "6"], "make-irs", 89)
        bank = os.path.join(tmp, "bank3")
        os.makedirs(bank)
        picked = sorted(os.listdir(os.path.join(irs, "devices")))[:3]
        for f in picked:
            shutil.copy(os.path.join(irs, "devices", f), bank)
        run(["device", "-i", wav_dir("dev"), "-o",
             os.path.join(tmp, "device"), "--ir_dir", bank, "-j", "4"],
            "device (3 IRs) -j 4", DEG_N)
        _wav_tree_check(os.path.join(tmp, "device"), sources,
                        [f"{s}{ir[:-4]}.wav" for s in sources
                         if s.startswith("LA_D") for ir in picked],
                        "device")
        system = system_codecs.available()
        if system:
            four = os.path.join(tmp, "four")
            os.makedirs(four)
            for f in sorted(os.listdir(wav_dir("dev")))[:4]:
                shutil.copy(os.path.join(wav_dir("dev"), f), four)
            out = run(["channel", "-i", four, "-o", os.path.join(tmp, "sys"),
                       "--fidelity", "system", "-j", "4"],
                      "channel parallel --fidelity system -j 4", 4)
            check("-> system" in out, f"system tier not taken: {out!r}")
            _wav_tree_check(os.path.join(tmp, "sys"), sources,
                            os.listdir(os.path.join(tmp, "sys")), "system")
            print("system codec tier: present (libavcodec + libopus); "
                  "channel --fidelity system over 4 files, 21 codecs each")
        else:
            print("system codec tier: NOT present on this machine "
                  "(libavcodec/libopus not loadable); --fidelity system "
                  "not run, and not counted as checked")
        print(f"degrade on the host [{os.cpu_count()} CPUs] ({DEG_N} "
              f"utterances a run, {secs:.2f} s mean): "
              + ", ".join(f"{k} {v:.1f} utt/s" for k, v in rates.items())
              + f"; -j 1 and -j 4 trees byte-equal; train codecs {codecs}")

        # ---- 8b: preprocess -> train -> 19laaugdev, on the card ----
        feats, aug_feats = (os.path.join(tmp, d) for d in ("feats",
                                                           "aug_feats"))
        torch.cuda.synchronize()
        zero()
        for part in ("train", "dev"):
            with quiet():
                preprocess.main(["-d", db, "-o", feats, "--part", part,
                                 "--batch_size", "32", "--device", DEVICE])
                preprocess.main(["--dataset", "aug", "--aug_wav_dir", aug,
                                 "--path_to_protocol", protdir, "-o",
                                 aug_feats, "--part", part, "--batch_size",
                                 "32", "--device", DEVICE])
        torch.cuda.synchronize()
        got = counts()
        want_b1 = 4 * -(-DEG_N // 32)
        print(f"preprocess_aug: 2 parts x (original, degraded) of {DEG_N} "
              f"utterances, launches {got}")
        check(got == {"B1": want_b1, "B2": 0, "B3": 0, "B4a": 0, "B4b": 0},
              f"preprocess_aug launches {got}, B1 expected {want_b1}")
        entries["B1"]["launches_preprocess_aug"] = got["B1"]
        ds = AugmentedFeatureDataset(feats, aug_feats, "train")
        labels = sorted(ds.channel[ds[i][4]]
                        for i in range(ds.num_original, len(ds)))
        check(labels == codecs, "ADV_AUG's channel labels are not the "
                                "degraded names' codecs")

        cfg = TrainConfig(
            out_fold=os.path.join(tmp, "runs", "laaug"),
            path_to_features=feats, path_to_aug_features=aug_feats,
            LA_aug=True, ADV_AUG=True, ratio=0.5, model="ecapa",
            add_loss="ang_iso", batch_size=Bt, feat_len=T, num_epochs=E,
            C=C, compute_dtype="bfloat16", steps_per_call=K)
        spe = -(-DEG_N // (Bt // 2))
        torch.cuda.synchronize()
        zero()
        summary, state = train(cfg, device=DEVICE, return_state=True)
        torch.cuda.synchronize()
        got = counts()
        counted, ran, replays = graph_launches(spe, K, E)
        evals = E * -(-2 * DEG_N // Bt)
        print(f"train_laaug: ECAPA-TDNN C={C} bf16 K={K} LA_aug + ADV_AUG, "
              f"{E * spe} steps ({replays} replay(s)) and {E} dev passes: "
              f"launches {got}; B4b counted {counted}, run {ran}; summary "
              f"{summary}")
        check(got == {"B1": 0, "B2": 0, "B3": 0, "B4a": counted + evals,
                      "B4b": counted}, f"train_laaug launches {got}")
        for k in ("B4a", "B4b"):
            entries[k]["launches_train_laaug"] = got[k]
        with open(os.path.join(cfg.out_fold, "train_loss.log")) as f:
            losses = np.array([float(r.split()[2])
                               for r in f.readlines()[1:]])
        check(len(losses) == E * spe and bool(np.isfinite(losses).all()),
              f"train_laaug losses {losses}")
        live = state.state_dict()
        del state

        # the step's time by CUDA events (an 8-step replay) at the batch
        # of the other training cells, B: K batches of the whole tree,
        # half originals, half degraded, reshuffled and cropped anew each
        # batch; and one step through B4a/B4b against the same step
        # through their plain versions at gate 1 (phase 4c's ADV step,
        # phase 4b's bars)
        it = RatioMixIterator(ds, B, 0.5, feat_len=T, seed=7,
                              steps_per_epoch=K).epoch()
        fb = [{k: torch.from_numpy(b[k]) for k in ("feat", "label",
                                                    "channel")}
              for b in it]
        timed = dataclasses.replace(cfg, batch_size=B)
        _, _, st, step, _ = setup_training(timed, spe, device=DEVICE)
        st.load_state_dict(live)
        multi = make_multi_step(step, K)
        stacked = {k: torch.stack([b[k] for b in fb]) for k in fb[0]}
        multi(st, stacked, None, 1.0)              # eager K, then capture
        step_ms = time_ms(torch, lambda: multi(st, stacked, None, 1.0),
                          iters=3, warmup=1) / K
        del st, multi
        k1 = dataclasses.replace(timed, steps_per_call=1)
        step1 = setup_training(k1, spe, device=DEVICE)[3]
        step_vs_plain(torch, lambda: setup_training(k1, spe,
                                                    device=DEVICE)[2],
                      live, lambda s, b: step1(s, b, None, 1.0),
                      {"feat": fb[0]["feat"].to(DEVICE),
                       "label": fb[0]["label"], "channel": fb[0]["channel"]},
                      "bf16 LA_aug ADV_AUG")

        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            torch.cuda.synchronize()
            zero()
            with quiet():
                path = generate_score.main([
                    "--model_folder", os.path.join(tmp, "runs"), "-n",
                    "laaug", "-t", "19laaugdev", "--ori_features", feats,
                    "--aug_features", aug_feats, "--batch_size", str(B),
                    "--device", DEVICE])
            torch.cuda.synchronize()
            got = counts()
            path = os.path.abspath(path)    # 19* tasks write to ./scores
        finally:
            os.chdir(cwd)
        with open(path) as f:
            rows = [r.split() for r in f]
        n_batches = -(-2 * DEG_N // B)
        print(f"score_laaug: 19laaugdev, {len(rows)} trials in {n_batches} "
              f"batch(es), launches {got}")
        check(got == {"B1": 0, "B2": 3 * n_batches, "B3": n_batches,
                      "B4a": 0, "B4b": 0}, f"score_laaug launches {got}")
        for k in ("B2", "B3"):
            entries[k]["launches_score_laaug"] = got[k]
        scores = np.array([float(r[1]) for r in rows])
        check(len(rows) == 2 * DEG_N and bool(np.isfinite(scores).all())
              and {r[2] for r in rows} <= {"bonafide", "spoof"},
              "19laaugdev score file")
        dev = AugmentedFeatureDataset(feats, aug_feats, "dev")
        batch = next(iter(SequentialIterator(dev, 8, T)))
        sd, lm, _c = generate_score.load_system(cfg.out_fold, device="cpu")
        ref = -make_score_fn(sd, lm, "ang_iso", device="cpu")(batch["feat"])
        err = float(np.abs(scores[:8] - ref.numpy()).max())
        print(f"score_laaug: card vs CPU on the first 8 trials {err:.2e} "
              "(bar 1e-4)")
        check(err <= 1e-4, "19laaugdev scores off the CPU's")
        fn = make_score_fn(sd, lm, "ang_iso", device=DEVICE)
        full = next(iter(SequentialIterator(dev, B, T)))["feat"]
        batch_ms = time_ms(torch, lambda: fn(full), iters=5)
        print(f"augmented pipeline [{gpu}]: train_laaug {step_ms:.3f} ms a "
              f"step (B={B}, T={T}, bf16, K={K} replay; CUDA events), "
              f"score_laaug {batch_ms:.3f} ms a batch (B={B}, T={T}, f32 "
              f"scorer; CUDA events)")

    # ---- 8c: fused_chain and remat_policy, one f32 step at B, T ----
    fused_chain_steps(torch, gpu)


def fused_chain_steps(torch, gpu: str) -> None:
    """Phase 8c: one f32 ECAPA-TDNN-512 + OC-Softmax training step at (B,
    T) from one state and batch: plain, ``fused_chain=True`` and
    ``remat_policy="conv_dot"``; loss rtol 1e-4, each gradient's error
    norm within 1e-2 of its tensor's, BN statistics rtol 1e-4 / atol
    1e-5 against the plain step (phase 4's bars); peak memory and ms."""
    from asvspoof2021_air_tpu_torch.interop.flax_weights import (
        from_flax_variables, random_flax_variables)
    from asvspoof2021_air_tpu_torch.losses.one_class import OCSoftmax
    from asvspoof2021_air_tpu_torch.models.ecapa import ECAPA_TDNN
    from asvspoof2021_air_tpu_torch.train.state import (
        create_train_state, step_decay_schedule)
    from asvspoof2021_air_tpu_torch.train.steps import (
        StepConfig, make_train_step)

    sd = from_flax_variables(random_flax_variables(
        90, C=C, model_scale=8, enc_dim=256), model_scale=8)
    g = torch.Generator().manual_seed(91)
    batch = {"feat": torch.randn(B, T, 60, generator=g).to(DEVICE),
             "label": torch.arange(B) % 2}
    center = torch.rand(1, 256, generator=g) * 2 - 1

    def fresh(fused_chain: bool):
        st = create_train_state(
            ECAPA_TDNN(C=C, fused_pool=True, fused_chain=fused_chain,
                       device=DEVICE),
            OCSoftmax(feat_dim=256, device=DEVICE),
            step_decay_schedule(5e-4, 0.5, 1, 10))
        st.model.load_state_dict(sd)
        with torch.no_grad():
            st.loss_module.center.copy_(center)
        return st

    runs = {}
    for name, fused_chain, policy in (("plain", False, None),
                                      ("fused_chain", True, None),
                                      ("conv_dot", False, "conv_dot")):
        st = fresh(fused_chain)
        step = make_train_step(StepConfig(add_loss="ang_iso",
                                          remat_policy=policy),
                               device=DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        m = step(st, batch)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        grads = {n: p.grad.clone() for n, p in st.model.named_parameters()
                 if p.grad is not None}
        stats = {k: v.clone() for k, v in st.model.state_dict().items()
                 if k.endswith(RUNNING)}
        ms = time_ms(torch, lambda: step(st, batch), iters=3, warmup=1)
        runs[name] = (float(m["ang_iso"]), grads, stats, peak, ms)
        del st, step
    loss0, g0, s0, _, _ = runs["plain"]
    for name in ("fused_chain", "conv_dot"):
        loss, gr, stats, _, _ = runs[name]
        worst = max((float((gr[n] - g0[n]).norm() / g0[n].norm()), n)
                    for n in g0 if g0[n].norm() > 0)
        stat = max((max_err(stats[k], s0[k]), k) for k in s0)
        print(f"8c {name} vs plain f32 step [{gpu}]: loss {loss:.7f} vs "
              f"{loss0:.7f} (rtol 1e-4), largest gradient error norm "
              f"{worst[0]:.3e} ({worst[1]}; bar 1e-2), BN statistics "
              f"{stat[0]:.3e} ({stat[1]}; rtol 1e-4, atol 1e-5)")
        check(abs(loss - loss0) <= 1e-4 * abs(loss0), f"8c {name} loss")
        check(worst[0] <= 1e-2, f"8c {name} gradients: {worst}")
        check(all(torch.allclose(stats[k], s0[k], rtol=1e-4, atol=1e-5)
                  for k in s0), f"8c {name} BN statistics: {stat}")
    for name, (_, _, _, peak, ms) in runs.items():
        print(f"8c f32 step {name} [{gpu}] (B={B}, T={T}; CUDA events): "
              f"{ms:.3f} ms, peak {peak:.2f} GiB above the state "
              "(torch.cuda.max_memory_allocated)")



# ---------------------------------------------------------------- phase 9


def ecapa_state(torch, sd, center, dtype=None, capturable=False, **model_kw):
    """An ECAPA-TDNN-512 + OC-Softmax train state on the card holding the
    weights ``sd`` and the loss center ``center``; ``model_kw`` are the
    model's flags (fused_pool, fused_bn, fused_chain, the variant
    fields)."""
    from asvspoof2021_air_tpu_torch.losses.one_class import OCSoftmax
    from asvspoof2021_air_tpu_torch.models.ecapa import ECAPA_TDNN
    from asvspoof2021_air_tpu_torch.train.state import (
        create_train_state, step_decay_schedule)

    # the rate halves every 30 epochs of 10 steps: constant over a phase's
    # steps, as a K-step graph holds it constant within a call
    st = create_train_state(
        ECAPA_TDNN(C=C, dtype=dtype, device=DEVICE, **model_kw),
        OCSoftmax(feat_dim=256, device=DEVICE),
        step_decay_schedule(5e-4, 0.5, 30, 10),
        capturable=capturable and DEVICE == "cuda")
    st.model.load_state_dict(sd)
    with torch.no_grad():
        st.loss_module.center.copy_(center)
    return st


NOISE = ("attention.2.bias", "attention.3.bias")


def check_step_pair(torch, what: str, tag: str, ref, got, rev, model,
                    before) -> None:
    """One training step ``got`` against ``ref`` from the same state and
    batch (each a :func:`step_record`); ``rev`` is ``got``'s function on
    the batch with its rows reversed (its own spread). f32: phase 8c's
    bars (loss rtol 1e-4, each gradient's error norm within 1e-2 of its
    tensor's, BN statistics rtol 1e-4 / atol 1e-5); bf16: phase 4b's
    (loss rtol 2^-8, gradients within max(1e-2, 4 x ``rev``'s error norm),
    BN statistics rtol 2^-8 / atol 1e-5 or one input ulp,
    ``bn_ulp_bars``). The attention's two biases shift every frame's
    logits of a channel by one value, which the softmax over T cancels:
    their gradients are rounding noise, held under 1e-4 (f32) or 1e-2
    (bf16) of the largest gradient element in both steps."""
    m_r, g_r, s_r = ref["metrics"], ref["grads"], ref["running"]
    m_g, g_g, s_g = got["metrics"], got["grads"], got["running"]
    g_v = rev["grads"]
    rtol = 1e-4 if tag == "f32" else 2.0 ** -8
    before = {k: v.to(DEVICE) for k, v in before.items()
              if k.endswith(RUNNING)}
    for k in m_r:
        print(f"9 {what} [{tag}]: {k} {m_g[k]:.7f} vs {m_r[k]:.7f} (rtol "
              f"{rtol:.2e})")
        check(abs(m_g[k] - m_r[k]) <= rtol * abs(m_r[k]),
              f"9 {what} {tag} {k}: {m_g[k]} vs {m_r[k]}")
    top = max(float(g.abs().max()) for g in g_r.values())
    noise_bar = 1e-4 if tag == "f32" else 1e-2
    for n in NOISE:
        if n in g_r:
            noise = max(float(g_g[n].abs().max()),
                        float(g_r[n].abs().max())) / top
            print(f"9 {what} [{tag}]: {n} gradient {noise:.3e} of the "
                  f"largest gradient element (bar {noise_bar:.0e})")
            check(noise <= noise_bar, f"9 {what} {tag} {n}: {noise}")
    names = [n for n in g_r if n not in NOISE and g_r[n].norm() > 0]

    def norm_err(a, b):
        return max((float((a[n] - b[n]).norm() / b[n].norm()), n)
                   for n in names)

    worst, spread = norm_err(g_g, g_r), norm_err(g_v, g_g)
    bar = 1e-2 if tag == "f32" else max(1e-2, 4 * spread[0])
    print(f"9 {what} [{tag}]: largest gradient error norm {worst[0]:.3e} "
          f"({worst[1]}; bar {bar:.3e}); its own step on the reversed "
          f"batch {spread[0]:.3e} ({spread[1]})")
    check(worst[0] <= bar, f"9 {what} {tag} gradients: {worst}")
    for n in g_r:
        if n not in NOISE and float(g_r[n].abs().max()) == 0:
            check(bool((g_g[n] == 0).all()), f"9 {what} {n} not zero")
    ulp = bn_ulp_bars(torch, model, before, s_r,
                      2.0 ** -23 if tag == "f32" else 2.0 ** -7)
    worst_stat = max((max_err(s_g[k], s_r[k]), k) for k in s_r)
    print(f"9 {what} [{tag}]: BN statistics largest difference "
          f"{worst_stat[0]:.3e} ({worst_stat[1]}; rtol {rtol:.2e}, atol "
          "1e-5, or one input ulp)")
    for k in s_r:
        limit = rtol * s_r[k].abs() + 1e-5
        if tag != "f32":
            limit = torch.maximum(limit, ulp[k])
        check(bool(((s_g[k] - s_r[k]).abs() <= limit).all()),
              f"9 {what} {tag} BN statistic {k}")


def unfused_steps(torch, gpu: str, sd, center, batch):
    """9a: one ECAPA-TDNN-512 training step with fused_pool and fused_bn
    off (plain autograd, no B4a/B4b) against the fused step from the same
    state and batch, f32 and bf16; both steps' peak memory and ms in turns
    (fused, unfused, unfused, fused), and the bf16 K = 8 graphs of both in
    turns: the hand-written path's yardstick, each step's device work with
    the host's launches out of the way."""
    from asvspoof2021_air_tpu_torch.train.steps import (
        StepConfig, make_multi_step, make_train_step)

    flip = {k: v.flip(0) for k, v in batch.items()}
    turns = ("fused", "unfused", "unfused", "fused")
    times, peaks = {}, {}
    for tag, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        recs, kept = {}, {}
        for name, fused, b in (("fused", True, batch),
                               ("unfused", False, batch),
                               ("unfused reversed", False, flip)):
            st = ecapa_state(torch, sd, center, dtype, fused_pool=fused,
                             fused_bn=fused)
            step = make_train_step(StepConfig(add_loss="ang_iso"),
                                   device=DEVICE)
            sync(torch)
            zero_counts()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            m = step(st, b)
            sync(torch)
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            counts = kernel_counts()
            recs[name] = step_record(torch, st, m)
            if name != "unfused reversed":
                check(counts["B4a"] == counts["B4b"] == int(fused),
                      f"9a {tag} {name} step launches {counts}")
                kept[name] = (st, step)
                peaks[(tag, name)] = (peak, counts)
        check_step_pair(torch, "9a unfused vs fused step", tag,
                        recs["fused"], recs["unfused"],
                        recs["unfused reversed"], st.model, sd)
        for name in turns:
            st, step = kept[name]
            times.setdefault((f"{tag} K=1", name), []).append(time_ms(
                torch, lambda: step(st, batch), iters=3, warmup=1))
        del st, step, kept
    K = 8
    stacked = stack_batches(torch, graph_batches(torch, K, 99))
    graphs = {}
    for name in ("fused", "unfused"):
        st = ecapa_state(torch, sd, center, torch.bfloat16, capturable=True,
                         fused_pool=name == "fused",
                         fused_bn=name == "fused")
        multi = make_multi_step(make_train_step(
            StepConfig(add_loss="ang_iso"), device=DEVICE), K)
        multi(st, stacked)                      # eager K steps, capture
        graphs[name] = (st, multi)
    for name in turns:
        st, multi = graphs[name]
        times.setdefault((f"bf16 K={K} graph", name), []).append(time_ms(
            torch, lambda: multi(st, stacked), iters=2, warmup=0) / K)
    del st, multi, graphs
    for (tag, name), (peak, counts) in peaks.items():
        print(f"9a {tag} training step {name} [{gpu}] (ECAPA-TDNN-512, "
              f"B={B}, T={T}, from features): peak {peak:.2f} GiB above "
              f"the state (torch.cuda.max_memory_allocated); B4a/B4b "
              f"launches {counts['B4a']}/{counts['B4b']}")
    for (what, name), ms in times.items():
        print(f"9a {what} step {name} [{gpu}] (B={B}, T={T}; CUDA events, "
              f"in turns fused, unfused, unfused, fused): "
              f"{' '.join(f'{t:.3f}' for t in ms)} ms = "
              f"{B / float(np.mean(ms)) * 1e3:.1f} utt/s")


def graph_batches(torch, n: int, seed: int):
    """``n`` seeded feature batches (B, T, 60) with alternating labels."""
    g = torch.Generator().manual_seed(seed)
    return [{"feat": torch.randn(B, T, 60, generator=g),
             "label": torch.arange(B) % 2} for _ in range(n)]


def stack_batches(torch, bs):
    return {k: torch.stack([b[k] for b in bs]) for k in bs[0]}


def conv_dot_graph(torch, gpu: str, entries, sd, center):
    """9b: ``remat_policy="conv_dot"`` through ``make_multi_step`` at K =
    8 on the card, bf16: the first call's 8 eager steps and the capture,
    then 8 graph-replayed steps against 8 eager steps from one state
    (``check_replay``, cuDNN deterministic)."""
    from asvspoof2021_air_tpu_torch.train.steps import (
        StepConfig, make_multi_step, make_train_step)

    K = 8
    fb = graph_batches(torch, 2 * K, 95)
    st = ecapa_state(torch, sd, center, torch.bfloat16, capturable=True,
                     fused_pool=True)
    step = make_train_step(StepConfig(add_loss="ang_iso",
                                      remat_policy="conv_dot"),
                           device=DEVICE)
    multi = make_multi_step(step, K)
    torch.backends.cudnn.deterministic = True
    sync(torch)
    zero_counts()
    multi(st, stack_batches(torch, fb[:K]))      # eager K steps, capture
    sync(torch)
    counts = kernel_counts()
    # the state after them, Adam's moments included, is the start of both
    # runs below (a state with no Adam state yet would drop the captured
    # moments when loaded)
    live = copy.deepcopy(st.state_dict())
    # each step's forward launches B4a, and the checkpoint's recompute
    # launches it again in the backward; on the card the capture counts
    # its K steps' launches once (on the CPU the K steps are a loop)
    steps = 2 * K if DEVICE == "cuda" else K
    print(f"9b conv_dot K={K}: {K} eager steps and the capture of {K} "
          f"launched {counts}")
    check(counts["B4b"] == steps and counts["B4a"] == 2 * steps,
          f"9b launch counts {counts}")
    add_counts(entries, "train_conv_dot_graph", counts)
    st.load_state_dict(live)
    m_graph = multi(st, stack_batches(torch, fb[K:]))
    after_graph = copy.deepcopy(st.state_dict())
    st.load_state_dict(live)
    m_eager = [step(st, b) for b in fb[K:]]
    after_eager = st.state_dict()
    torch.backends.cudnn.deterministic = False
    check_replay(torch, m_graph, after_graph, m_eager, after_eager,
                 live["step"], K, "the conv_dot step (checkpointed "
                 "backward captured)")


def fused_chain_dp_graph(torch, gpu: str, entries, sd, center):
    """9c: ``fused_chain`` inside the data-parallel K = 8 graph over NCCL
    at world size 1 (phase 7a's set-up) against the one-process
    ``fused_chain`` graph, bf16, cuDNN deterministic: each captured after
    its first call's 8 eager steps, then both replayed from one state
    (the one-process run's after its first call) on the same 8 batches.
    At world 1 the group's sums over n are the batch means, so the two
    replays must agree as a replay agrees with eager steps
    (``check_replay``'s bars: every metric and every tensor of the two
    states rtol 1e-6, atol 1e-9). Without deterministic cuDNN two runs
    of one function part by a few percent of the loss within 8 Adam
    steps from these random weights, so no looser bar would tell a fault
    from noise."""
    import torch.distributed as dist

    from asvspoof2021_air_tpu_torch.parallel import (
        initialize_distributed, make_mesh)
    from asvspoof2021_air_tpu_torch.train.steps import (
        StepConfig, make_multi_step, make_train_step)

    K = 8
    fb = graph_batches(torch, 2 * K, 96)
    initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0, device=DEVICE)
    check(DEVICE != "cuda" or dist.get_backend() == "nccl", "9c: not NCCL")
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        group = make_mesh(DEVICE).group()
        for name, data_group in (("one process", None),
                                 ("data parallel", group)):
            st = ecapa_state(torch, sd, center, torch.bfloat16,
                             capturable=True, fused_pool=True,
                             fused_chain=True)
            step = make_train_step(StepConfig(add_loss="ang_iso"),
                                   device=DEVICE, data_group=data_group)
            multi = make_multi_step(step, K)
            sync(torch)
            zero_counts()
            multi(st, stack_batches(torch, fb[:K]))
            sync(torch)
            counts = kernel_counts()
            steps = 2 * K if DEVICE == "cuda" else K
            check(counts["B4a"] == counts["B4b"] == steps,
                  f"9c {name} launch counts {counts}")
            if data_group is None:
                live = copy.deepcopy(st.state_dict())
            else:
                add_counts(entries, "train_dp_fused_chain", counts)
            st.load_state_dict(live)
            m = multi(st, stack_batches(torch, fb[K:]))
            out[name] = ({k: v.clone() for k, v in m.items()},
                         copy.deepcopy(st.state_dict()))
            del st, step, multi
    finally:
        torch.backends.cudnn.deterministic = False
        dist.destroy_process_group()
    (m1, s1), (m2, s2) = out["one process"], out["data parallel"]
    check_replay(torch, m2, s2, [{k: v[i] for k, v in m1.items()}
                                 for i in range(K)], s1, live["step"], K,
                 "fused_chain, the data-parallel graph over NCCL at world "
                 "1", against="replayed steps of the one-process graph")


VARIANT = dict(context=False, encoder_type="SAP", out_bn=False)


def variant_step(torch, gpu: str):
    """9d: the ECAPA variant ``context=False``, a non-"ECA" encoder (one
    attention channel) and ``out_bn=False``, f32, from seeded weights in
    its own tree: its eval forward on the card against the same forward
    on the CPU for the first 8 utterances (1e-4 of the largest value),
    and its training step (the recompute VJPs; the one-channel attention
    pools without B4a/B4b, as JAX's rule says) against the plain
    autograd step (fused_bn off) at phase 8c's bars."""
    from asvspoof2021_air_tpu_torch.interop.flax_weights import (
        from_flax_variables, random_flax_variables)
    from asvspoof2021_air_tpu_torch.models.ecapa import ECAPA_TDNN
    from asvspoof2021_air_tpu_torch.train.steps import (
        StepConfig, make_train_step)

    sd = from_flax_variables(random_flax_variables(
        97, C=C, model_scale=8, enc_dim=256, model_kwargs=VARIANT),
        model_scale=8)
    g = torch.Generator().manual_seed(98)
    feats = torch.randn(B, T, 60, generator=g)
    center = torch.rand(1, 256, generator=g) * 2 - 1
    batch = {"feat": feats.to(DEVICE), "label": torch.arange(B) % 2}
    outs = []
    for dev, x in ((DEVICE, batch["feat"][:8]), ("cpu", feats[:8])):
        m = ECAPA_TDNN(C=C, device=dev, **VARIANT).eval()
        m.load_state_dict(sd)
        with torch.no_grad():
            outs.append([t.cpu() for t in m(x)])
        del m
    errs = [max_err(a, b) / float(b.abs().max())
            for a, b in zip(outs[0], outs[1])]
    print(f"9d variant {VARIANT} eval forward [{gpu}] vs the CPU (8 "
          f"utterances, f32): embedding {errs[0]:.3e}, logits "
          f"{errs[1]:.3e} of the largest value (bar 1e-4)")
    check(max(errs) <= 1e-4, f"9d variant eval forward {errs}")
    recs = {}
    flip = {k: v.flip(0) for k, v in batch.items()}
    for name, fused, b in (("plain", False, batch),
                           ("recompute VJPs", True, batch),
                           ("recompute VJPs reversed", True, flip)):
        st = ecapa_state(torch, sd, center, fused_pool=True,
                         fused_bn=fused, **VARIANT)
        step = make_train_step(StepConfig(add_loss="ang_iso"),
                               device=DEVICE)
        sync(torch)
        zero_counts()
        m = step(st, b)
        sync(torch)
        counts = kernel_counts()
        check(counts["B4a"] == counts["B4b"] == 0,
              f"9d {name}: a one-channel attention launched {counts}")
        recs[name] = step_record(torch, st, m)
    check_step_pair(torch, "9d variant step vs plain", "f32",
                    recs["plain"], recs["recompute VJPs"],
                    recs["recompute VJPs reversed"], st.model, sd)


def remaining_configs_path(torch, gpu: str, entries):
    """Phase 9: the training configurations ported last (9a-9d)."""
    from asvspoof2021_air_tpu_torch.interop.flax_weights import (
        from_flax_variables, random_flax_variables)

    sd = from_flax_variables(random_flax_variables(
        93, C=C, model_scale=8, enc_dim=256), model_scale=8)
    g = torch.Generator().manual_seed(94)
    batch = {"feat": torch.randn(B, T, 60, generator=g).to(DEVICE),
             "label": torch.arange(B) % 2}
    center = torch.rand(1, 256, generator=g) * 2 - 1

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        fn(torch, gpu, *args)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s")

    timed("9a", unfused_steps, sd, center, batch)
    timed("9b", conv_dot_graph, entries, sd, center)
    timed("9c", fused_chain_dp_graph, entries, sd, center)
    timed("9d", variant_step)


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    try:
        from asvspoof2021_air_tpu_torch._device import disable_tf32
        from asvspoof2021_air_tpu_torch.ops import _build, _host_build
    except ImportError as e:
        fail(f"the port package is not beside chip_smoke.py ({e})")

    gpu = gpu_line()
    print(gpu)
    disable_tf32()
    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"(nvcc: {_build.build_seconds})")
    t0 = time.perf_counter()
    _host_build.codec_library()
    print(f"native codec library (native/augment, the host C++ compiler) "
          f"built and loaded in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    seconds = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        print(f"phase {name}: {seconds[name]:.1f} s")
        return out

    entries = phase("2", kernel_checks, torch, gen)
    phase("2b", vjp_checks, torch, gen, entries)
    fwd_ms = phase("3", main_path, torch, gpu, entries)
    phase("3b", score_path, torch, gpu, entries)
    f32_ms, _ = phase("4", train_path, torch, gpu, entries)
    bf16_ms = phase("4b", train_bf16_path, torch, gpu, entries, f32_ms)
    phase("4c", train_adv_path, torch, gpu, entries)
    phase("4d", train_families_path, torch, gpu, entries)
    phase("4e", train_new_families_path, torch, gpu, entries)
    phase("5", preprocess_path, torch, gpu, entries)
    phase("5b", train_ensemble_path, torch, gpu, entries)
    phase("6", int8_export_path, torch, gpu, entries, fwd_ms)
    phase("7", data_parallel_path, torch, gpu, entries, bf16_ms)
    phase("8", degraded_corpus_path, torch, gpu, entries)
    phase("9", remaining_configs_path, torch, gpu, entries)
    print(f"phase seconds: { {k: round(v, 1) for k, v in seconds.items()} }")

    kernels = []
    for key in ("B1", "B2", "B3", "B4a", "B4b"):
        e = entries[key]
        bound_ms, bound_by = bound(e["bytes"], e["flops"], e["kind"])
        by_path = {p: e[f"launches_{p}"] for p in (
            "serve", "score", "train", "train_bf16", "train_bf16_otf",
            "train_adv", "train_adv_dual", "train_aug_otf",
            "train_resnet_otf", "train_lcnn_otf", "train_res2net_otf",
            "train_cnn_otf", "train_rawnet_otf", "preprocess",
            "train_ensemble", "train_ensemble_otf", "score_ensemble",
            "serve_int8", "export", "train_dp", "score_dp",
            "train_member_dp", "train_member_data_dp", "preprocess_aug",
            "train_laaug", "score_laaug", "train_conv_dot_graph",
            "train_dp_fused_chain")
            if f"launches_{p}" in e}
        launches = sum(by_path.values())
        print(f"{e['name']} [{gpu}]: max_abs_err {e['max_abs_err']:.3e}, "
              f"{e['ms']:.4f} ms (plain {e['plain_ms']:.4f} ms, bound "
              f"{bound_ms:.4f} ms by {bound_by}: {e['bytes'] / 1e6:.1f} MB, "
              f"{e['flops'] / 1e9:.2f} GFLOP {e['kind']}), launches on the "
              f"main paths {by_path}")
        kernels.append({
            "name": e["name"], "route": "cuda", "source": e["source"],
            "replaces": e["replaces"], "launches": launches,
            "launches_by_path": by_path,
            "max_abs_err": e["max_abs_err"], "ms": e["ms"],
            "plain_ms": e["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            **{k: e[k] for k in ("matmul_ms",) if k in e},
            **e.get("extra", {})})
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
