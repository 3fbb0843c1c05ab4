"""Port B4a/B4b (the plain versions and FusedSoftmaxStats on the CPU,
asvspoof2021_air_tpu_torch/ops/attn_pool_vjp.py) against the JAX package's
fused_softmax_stats (Pallas, interpret mode), with the JAX test's own bars
(tests/test_attn_pool_vjp.py): forward 1e-5, cotangents 2e-4, db2 exactly
0, bf16 cotangents in the primal types; and models of the kernels' 3xTF32
products and of B4a's chunked online softmax against the plain versions."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asvspoof2021_air_tpu.ops.attn_pool_vjp import fused_softmax_stats as jfss
from asvspoof2021_air_tpu_torch.ops import attn_pool_vjp as vjp
from asvspoof2021_air_tpu_torch.utils import profiling
from tf32_emulation import three_tf32, tf32_rna, tf32_split


def _inputs(B=2, T=30, D=512, H=128, seed=0):
    g = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (sc * g.standard_normal(s)).astype(np.float32)
    return f(B, T, D), f(B, T, H, sc=0.5), f(H, D, sc=0.2), f(D, sc=0.1)


def _sigma_loss(mu, e2, cm, sqrt, clip):
    """The JAX test's scalar: sum((0.7 mu + sigma) * cm) with sigma =
    sqrt(clip(e2 - mu^2, 1e-4)), so both outputs carry cotangents."""
    return ((mu * 0.7 + sqrt(clip(e2 - mu ** 2))) * cm).sum()


@pytest.mark.parametrize("D", [512, 1024])
def test_plain_forward_matches_pallas(D):
    x, h2, w2, b2 = _inputs(D=D)
    want = jfss(True, *map(jnp.asarray, (x, h2, w2, b2)))
    got = vjp.fused_softmax_stats_plain(*map(torch.from_numpy,
                                             (x, h2, w2, b2)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_cotangents_match_pallas():
    """All four cotangents at T = 29 through FusedSoftmaxStats (the plain
    backward on the CPU) against jax.grad through the Pallas VJP."""
    x, h2, w2, b2 = _inputs(T=29)
    cm = np.random.default_rng(5).standard_normal(512).astype(np.float32)

    def jloss(*a):
        mu, e2 = jfss(True, *a)
        return _sigma_loss(mu, e2, cm, jnp.sqrt,
                           lambda v: jnp.clip(v, 1e-4))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, h2, w2, b2)))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, h2, w2, b2)]
    mu, e2 = vjp.fused_softmax_stats(*args)
    _sigma_loss(mu, e2, torch.from_numpy(cm), torch.sqrt,
                lambda v: torch.clamp(v, min=1e-4)).backward()
    for name, a, w in zip(("dx", "dh2", "dw2", "db2"), args, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4, err_msg=name)
    assert torch.all(args[3].grad == 0.0)


def test_function_matches_autograd_through_plain_forward():
    """The hand-written plain backward against torch autograd through the
    plain forward: the same function, so rounding only (atol 1e-5, rtol
    1e-4); autograd's db2 is zero to rounding, the Function's exactly."""
    x, h2, w2, b2 = _inputs(T=24, seed=3)
    g = np.random.default_rng(4)
    gmu, ge2 = (torch.from_numpy(g.standard_normal((2, 512)).astype(
        np.float32)) for _ in range(2))
    grads = []
    for fn in (vjp.fused_softmax_stats, vjp.fused_softmax_stats_plain):
        args = [torch.from_numpy(a).requires_grad_() for a in (x, h2, w2, b2)]
        mu, e2 = fn(*args)
        torch.autograd.backward((mu, e2), (gmu, ge2))
        grads.append([a.grad for a in args])
    (fx, fh, fw, fb), (px, ph, pw, pb) = grads
    for name, got, want in (("dx", fx, px), ("dh2", fh, ph), ("dw2", fw, pw)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4,
                                   msg=name)
    assert torch.all(fb == 0.0)
    torch.testing.assert_close(pb, torch.zeros_like(pb), atol=1e-5, rtol=0)


def test_bf16_inputs_track_pallas_and_keep_primal_types():
    x, h2, w2, b2 = _inputs(T=24, seed=7)
    jx, jh = jnp.asarray(x, jnp.bfloat16), jnp.asarray(h2, jnp.bfloat16)
    want = jfss(True, jx, jh, jnp.asarray(w2), jnp.asarray(b2))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
    th = torch.from_numpy(np.array(jh.astype(jnp.float32))).bfloat16()
    tx.requires_grad_()
    th.requires_grad_()
    mu, e2 = vjp.fused_softmax_stats(tx, th, torch.from_numpy(w2),
                                     torch.from_numpy(b2))
    assert mu.dtype == e2.dtype == torch.float32
    for g, w in zip((mu, e2), want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=2e-2, atol=2e-2)
    mu.sum().backward()
    assert tx.grad.dtype == torch.bfloat16
    assert th.grad.dtype == torch.bfloat16


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_shapes():
    x, h2, w2, b2 = map(torch.from_numpy, _inputs(T=8))
    with pytest.raises(ValueError, match="CUDA"):
        vjp.softmax_stats_fwd_kernel(x, h2, w2, b2)
    res = vjp.softmax_stats_fwd_plain(x, h2, w2, b2)
    with pytest.raises(ValueError, match="CUDA"):
        vjp.softmax_stats_bwd_kernel(x, h2, w2, b2, res, res[0], res[1])
    with pytest.raises(ValueError, match="multiple of 128"):
        vjp.softmax_stats_fwd_kernel(x[..., :100], h2, w2[:, :100], b2[:100])
    with pytest.raises(ValueError, match="share a type"):
        vjp.softmax_stats_fwd_kernel(x.bfloat16(), h2, w2, b2)
    counts = profiling.counts()
    assert counts.get("B4a", 0) == counts.get("B4b", 0) == 0


# --- B4b's 3xTF32 arithmetic, emulated on the CPU ---------------------------
# The split and what its emulation leaves out: tests/tf32_emulation.py.


def _products(T=50, seed=11):
    """B4b's three products at chip_smoke's scales (B = 2, D = 256, H = 128),
    as (name, a, b) with f32 operands: logits = h2 @ W2, dh2 = dlog @ W2^T,
    dW2 = h2^T @ dlog, dlog computed in float64 and rounded to f32 as the
    kernel holds it."""
    g = np.random.default_rng(seed)
    B, D, H = 2, 256, vjp.HIDDEN
    f = lambda *s, sc=1.0: torch.from_numpy(
        (sc * g.standard_normal(s)).astype(np.float32))
    x, h2 = torch.relu(f(B, T, D)), f(B, T, H)
    w2, b2 = f(H, D, sc=H ** -0.5), f(D, sc=0.05)
    gmu, ge2 = f(B, D), f(B, D, sc=0.1)
    xd = x.double()
    w = torch.softmax(h2.double() @ w2.double() + b2.double(), dim=1)
    q = gmu.double()[:, None] * xd + ge2.double()[:, None] * xd * xd
    dlog = (w * (q - (w * q).sum(1, keepdim=True))).float()
    h2f, dlf = h2.reshape(-1, H), dlog.reshape(-1, D)
    return [("logits", h2f, w2), ("dh2", dlf, w2.t().contiguous()),
            ("dW2", h2f.t().contiguous(), dlf)]


def _over_bar(name, got, want):
    """The largest error over chip_smoke's bar for this product: dW2 within
    1e-4 of its largest element; the others rtol 1e-4 + atol 1e-5."""
    err = (got - want).abs()
    if name == "dW2":
        return float(err.max() / (1e-4 * want.abs().max()))
    return float((err / (1e-5 + 1e-4 * want.abs())).max())


def test_tf32_split_reproduces_f32():
    g = np.random.default_rng(2)
    a = torch.from_numpy(np.concatenate([
        g.standard_normal(4096), 1e-20 * g.standard_normal(64),
        1e20 * g.standard_normal(64),
        [1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -12]]
    ).astype(np.float32))
    big, small = tf32_split(a)
    assert torch.all(big.view(torch.int32) & 0x1FFF == 0)
    assert torch.all(small.view(torch.int32) & 0x1FFF == 0)
    rel = ((big.double() + small.double() - a.double()).abs()
           / a.double().abs())
    assert float(rel.max()) <= 2.0 ** -21
    # ties round away from zero, as cvt.rna does
    assert big[-3] == 1.0 + 2.0 ** -10 and big[-2] == -(1.0 + 2.0 ** -10)


@pytest.mark.parametrize("T", [50, 49])
def test_three_tf32_products_hold_the_chip_bars(T):
    for name, a, b in _products(T):
        want = a.double() @ b.double()
        got = three_tf32(a, b).double()
        assert _over_bar(name, got, want) <= 0.1, name


def test_one_tf32_product_misses_the_chip_bars():
    """Why three terms: big * big alone (plain TF32) misses every bar."""
    for name, a, b in _products():
        want = a.double() @ b.double()
        one = (tf32_rna(a).double() @ tf32_rna(b).double()).float().double()
        assert _over_bar(name, one, want) > 1.0, name


# --- B4a's chunked online softmax, modelled on the CPU ----------------------
# B4a (csrc/attn_pool_vjp.cu) walks T in chunks of R2 rows per 128-channel
# tile; lane (g, t) of warp w keeps a running (max, normalizer, sum e x,
# sum e x^2) per channel for rows 32 (w % 2) + g + 8 k, k < 4, of each chunk:
# 16 row groups, rg = 8 (w % 2) + g, merged in order of rg at the end.

R2 = int(re.search(r"constexpr int R2 = (\d+);",
                   (Path(vjp.__file__).resolve().parent.parent / "csrc"
                    / "attn_pool_vjp.cu").read_text()).group(1))


def _b4a_model(x, h2, w2, b2):
    """(mu, e2, max, normalizer) by B4a's schedule in f32, the logits h2 @ W2
    in 3xTF32 (products summed in float64, rounded once to f32), and the
    count of (chunk, row group) pairs with no row before T."""
    return _chunked_pool((three_tf32(h2, w2) + b2).numpy(), x)


def _chunked_pool(logits, x):
    """B4a's chunked online softmax over the T rows of logits (B, T, D) f32:
    (mu, e2, max, normalizer) and the count of (chunk, row group) pairs with
    no row before T."""
    xf = x.float().numpy()
    T = x.shape[1]
    groups = 16
    shape = (groups,) + logits.shape[::2]          # (rg, B, D)
    m = np.full(shape, -np.inf, np.float32)
    l, s1, s2 = (np.zeros(shape, np.float32) for _ in range(3))
    empty = 0
    for t0 in range(0, T, R2):
        for rg in range(groups):
            rows = [t0 + 32 * (rg // 8) + rg % 8 + 8 * k for k in range(4)]
            rows = [t for t in rows if t < T]
            if not rows:
                empty += 1
                continue
            cmax = np.maximum(m[rg], logits[:, rows].max(axis=1))
            f = np.exp(m[rg] - cmax)
            l[rg], s1[rg], s2[rg], m[rg] = l[rg] * f, s1[rg] * f, s2[rg] * f, cmax
            for t in rows:
                e = np.exp(logits[:, t] - m[rg])
                v = xf[:, t]
                l[rg] += e
                s1[rg] += e * v
                s2[rg] += e * v * v
    M = m.max(axis=0)
    L, S1, S2 = (np.zeros_like(M) for _ in range(3))
    for rg in range(groups):
        live = m[rg] > -np.inf
        f = np.where(live, np.exp(np.where(live, m[rg] - M, 0)), 0).astype(
            np.float32)
        L += l[rg] * f
        S1 += s1[rg] * f
        S2 += s2[rg] * f
    return (S1 / L, S2 / L, M, L), empty


@pytest.mark.parametrize("T", [50, 49, 20, R2 + 6])
def test_chunked_online_softmax_matches_plain(T):
    """B4a's schedule against softmax_stats_fwd_plain, atol = rtol = 1e-4.
    At T = 20 the row groups of rows 32-63 see no row at all; at R2 + 6 the
    second chunk leaves most groups without a row."""
    g = np.random.default_rng(T)
    f = lambda *s, sc=1.0: torch.from_numpy(
        (sc * g.standard_normal(s)).astype(np.float32))
    B, D, H = 2, 256, vjp.HIDDEN
    x, h2 = torch.relu(f(B, T, D)), f(B, T, H)
    w2, b2 = f(H, D, sc=H ** -0.5), f(D, sc=0.05)
    got, empty = _b4a_model(x, h2, w2, b2)
    want = vjp.softmax_stats_fwd_plain(x, h2, w2, b2)
    for name, a, w in zip(("mu", "e2", "max", "normalizer"), got, want):
        np.testing.assert_allclose(a, w.numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    assert (empty > 0) == (T in (20, R2 + 6))
