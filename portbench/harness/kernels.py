"""The yardstick of the roofline shares: published H100 peaks, and the
operations and bytes of each hand-written kernel's function, from shapes.

A kernel's least time is the larger of its operations over the peak of
the precision the function is held to, and its bytes over HBM's rate.
Operations are the function's, counted once whatever implements them (a
product that a kernel splits into three TF32 products counts once); bytes
are each input read once and each output written once.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense rates (no sparsity).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12}
ESIZE = {"float32": 4, "bfloat16": 2}


def least_seconds(work: dict) -> float:
    """The least time of ``work`` ({"flops", "bytes", "peak"})."""
    return max(work["flops"] / PEAK_FLOPS[work["peak"]],
               work["bytes"] / HBM_BYTES_PER_S)


def lfcc_b1(B: int, L: int, win: int, hop: int, n_fft: int, n_filters: int):
    """B1: pre-emphasized (B, L) f32 -> (B, 1 + L // hop, n_filters) f32
    cepstra: per frame the window, a real FFT of n_fft points (2.5 n log2 n
    operations), the power, the dense filterbank, log10 and the DCT."""
    T = 1 + L // hop
    bins = n_fft // 2 + 1
    per_frame = (win + 2.5 * n_fft * math.log2(n_fft) + 3 * bins
                 + 2 * bins * n_filters + n_filters + 2 * n_filters ** 2)
    nbytes = 4 * B * L + 4 * B * T * n_filters
    return {"flops": B * T * per_frame, "bytes": nbytes, "peak": "tf32"}


def res2_chain_b2(B: int, T: int, C: int, scale: int, kernel: int,
                  dtype: str):
    """B2: one block's Res2 chain, (B, T, C) in and out in ``dtype``:
    ``scale - 1`` convs of width C / scale with ``kernel`` taps, each
    followed by bias, ReLU and the BN affine (f32 parameters)."""
    w, e = C // scale, ESIZE[dtype]
    flops = (scale - 1) * (2 * B * T * w * w * kernel + 4 * B * T * w)
    params = (scale - 1) * (w * w * kernel * e + 3 * w * 4)
    return {"flops": flops, "bytes": 2 * B * T * C * e + params,
            "peak": "bf16" if dtype == "bfloat16" else "tf32"}


def attn_pool_b3(B: int, T: int, D: int, H: int, dtype: str):
    """B3: attentive statistics pooling with context, x (B, T, D) in
    ``dtype`` -> (B, 2 D) f32: the context's statistics, x @ Wx and the
    context term (D x H each), ReLU and the BN affine, h @ Wb (H x D), the
    softmax over T, and the weighted first and second moments."""
    e = ESIZE[dtype]
    flops = (4 * B * T * D * H + 4 * B * D * H + 4 * B * T * D
             + 6 * B * T * D)
    params = 4 * (3 * D * H + H * D + 3 * H + D)
    return {"flops": flops, "bytes": B * T * D * e + params + 4 * B * 2 * D,
            "peak": "bf16" if dtype == "bfloat16" else "tf32"}


def softmax_stats_b4a(B: int, T: int, D: int, H: int, dtype: str):
    """B4a: (mu, E_w[x^2]) (B, D) f32 of x (B, T, D) and h2 (B, T, H) in
    ``dtype`` with W2 (H, D) and b2 (D) f32: h2 @ W2, the softmax over T,
    the two weighted sums. Held to float32 bars: the TF32 peak."""
    e = ESIZE[dtype]
    flops = 2 * B * T * H * D + 3 * B * T * D + 4 * B * T * D
    nbytes = B * T * (D + H) * e + 4 * (H * D + D) + 2 * 4 * B * D
    return {"flops": flops, "bytes": nbytes, "peak": "tf32"}


def softmax_stats_b4b(B: int, T: int, D: int, H: int, dtype: str):
    """B4b: the VJP of B4a, from x, h2, W2, b2 and the cotangents of mu and
    E_w[x^2] to dx and dh2 (in ``dtype``), dW2 and db2 (f32): the logits
    again, dlogits @ W2^T and h2^T @ dlogits (three H x D products) and the
    elementwise terms. Held to float32 bars: the TF32 peak."""
    e = ESIZE[dtype]
    flops = 3 * 2 * B * T * H * D + 12 * B * T * D
    nbytes = (2 * B * T * (D + H) * e + 2 * 4 * (H * D + D)
              + 2 * 4 * B * D)
    return {"flops": flops, "bytes": nbytes, "peak": "tf32"}
