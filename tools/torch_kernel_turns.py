#!/usr/bin/env python3
"""Time the port's pooling kernels in several checkouts, in turns, on one GPU.

    python3 tools/torch_kernel_turns.py TREE [TREE ...]

Each TREE is the root of a checkout of this repository (the port package
beside ``chip_smoke.py``); give a tree more than once to run it again, e.g.
``old new new old``. Each run is a fresh process started in its tree: it
builds that tree's kernels, makes the same inputs from a seed, and prints
one JSON line with the device times (CUDA events) of B3 at
(64, 750, 1536) in bf16 and in f32, of B4a at the same shape in f32, of
B2 at (64, 750, 512) in bf16 at d = 2 and in f32 at d = 2, 3 and 4 (with
its largest error against the plain version, TF32 off), with a SHA-256 of
each kernel's output, so that trees whose kernels should agree bit for bit
can be compared. The card's name and power limit (nvidia-smi) head the
output. Needs a GPU.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

B, T, C, D = 64, 750, 512, 1536


def child() -> None:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from asvspoof2021_air_tpu_torch._device import disable_tf32
    from asvspoof2021_air_tpu_torch.ops import _build
    from asvspoof2021_air_tpu_torch.ops import attn_pool_cuda as ap
    from asvspoof2021_air_tpu_torch.ops import attn_pool_vjp as vj
    from asvspoof2021_air_tpu_torch.ops import res2_chain_cuda as rc

    disable_tf32()
    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s, scale=1.0: torch.randn(
        *s, generator=gen, device="cuda") * scale
    digest = lambda ts: hashlib.sha256(b"".join(
        t.float().cpu().numpy().tobytes() for t in ts)).hexdigest()[:16]
    res = {}

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
    x32 = torch.relu(randn(B, T, D))
    for name, x in (("B3_bf16", x32.bfloat16()), ("B3_f32", x32)):
        out = ap.attention_pooling_kernel(x, pp)
        err = cs.max_err(out, ap.attention_pooling_plain(x, pp))
        res[name] = dict(
            ms=cs.time_ms(torch, lambda: ap.attention_pooling_kernel(x, pp),
                          iters=20),
            max_abs_err=err, sha=digest([out]))

    h2 = randn(B, T, 128)
    w2, b2 = randn(128, D, scale=128 ** -0.5), randn(D, scale=0.05)
    out = vj.softmax_stats_fwd_kernel(x32, h2, w2, b2)
    res["B4a_f32"] = dict(
        ms=cs.time_ms(torch, lambda: vj.softmax_stats_fwd_kernel(
            x32, h2, w2, b2), iters=20), sha=digest(out))
    del x32, h2

    sd = {}
    for j in range(7):
        sd[f"l.convs.{j}.weight"] = randn(64, 64, 3, scale=1 / 192 ** 0.5)
        sd[f"l.convs.{j}.bias"] = randn(64, scale=0.05)
        sd[f"l.bns.{j}.weight"] = 1 + randn(64, scale=0.1)
        sd[f"l.bns.{j}.bias"] = randn(64, scale=0.1)
        sd[f"l.bns.{j}.running_mean"] = randn(64, scale=0.1)
        sd[f"l.bns.{j}.running_var"] = 1 + randn(64, scale=0.1).abs()
    p32 = rc.pack_chain_params(sd, "l")
    p16 = (p32[0].bfloat16(), *p32[1:])
    x32 = randn(B, T, C)
    xc = x32.bfloat16()
    out = rc.res2_chain_kernel(xc, *p16, dilation=2)
    res["B2_bf16_d2"] = dict(
        ms=cs.time_ms(torch, lambda: rc.res2_chain_kernel(
            xc, *p16, dilation=2), iters=20), sha=digest([out]))
    for d in (2, 3, 4):
        out = rc.res2_chain_kernel(x32, *p32, dilation=d)
        res[f"B2_f32_d{d}"] = dict(
            ms=cs.time_ms(torch, lambda: rc.res2_chain_kernel(
                x32, *p32, dilation=d), iters=20),
            max_abs_err=cs.max_err(out, rc.res2_chain_plain(
                x32, *p32, dilation=d)), sha=digest([out]))
    print(json.dumps(res))


def main() -> int:
    if sys.argv[1:] == ["--child"]:
        child()
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(gpu)
    me = os.path.abspath(__file__)
    rows = []
    for tree in sys.argv[1:]:
        proc = subprocess.run([sys.executable, me, "--child"], cwd=tree,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(f"=== {tree}: exit {proc.returncode}\n{proc.stdout}"
                  f"{proc.stderr[-4000:]}")
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        rows.append((tree, res))
        print(f"=== {tree}: " + "; ".join(
            f"{k} {v['ms']:.4f} ms sha {v['sha']}"
            + (f" err {v['max_abs_err']:.3e}" if "max_abs_err" in v else "")
            for k, v in res.items()), flush=True)
    print(json.dumps({"gpu": gpu, "runs": [
        {"tree": tree, **res} for tree, res in rows]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
