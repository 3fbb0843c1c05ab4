"""B3's schedule (asvspoof2021_air_tpu_torch/csrc/attn_pool.cu) modelled on
the CPU, against the plain version and the exact result: the bf16 planes
of Wx, a float64 emulation of both products' arithmetic, a model of the
three passes' tiling and of valid_len, and the kernel wrapper's refusals.

The kernel: pass A computes P = x @ Wx per tile of RA rows (bf16 x against
Wx's bf16 planes, f32 x in 3xTF32) and the tile's column sums of x and
x^2; pass B sums those in tile order to mean and std and forms
c = mean @ Wm + std @ Ws + ba; pass C is B4a's chunked online softmax over
the rows < n, with h = relu(P + c) * s + bias formed as each P chunk lands
and the logits h @ Wb in 3xbf16 (h and Wb each as two bf16 planes, three
bf16 products)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from asvspoof2021_air_tpu_torch.ops import attn_pool_cuda as ap
from asvspoof2021_air_tpu_torch.utils import profiling
from tests.test_torch_attn_pool_vjp import _chunked_pool
from tf32_emulation import three_tf32

_CSRC = Path(ap.__file__).resolve().parent.parent / "csrc"
_SRC = (_CSRC / "attn_pool.cu").read_text()
_const = lambda name, text=_SRC: int(
    re.search(rf"constexpr int {name} = (\d+);", text).group(1))
RA = _const("RA")                     # pass A: rows per block
NPL = _const("NPL")                   # pass A: bf16 planes of Wx
R2 = _const("POOL_R", (_CSRC / "tensor_core.cuh").read_text())   # pass C
H = ap.HIDDEN


def _params(D, seed):
    """PoolParams at chip_smoke.py's scales."""
    g = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: torch.from_numpy(
        (sc * g.standard_normal(s)).astype(np.float32))
    return ap.pack_pool_params({
        "attention.0.weight": f(H, 3 * D, 1, sc=0.02),
        "attention.0.bias": f(H, sc=0.05),
        "attention.2.weight": 1 + f(H, sc=0.1),
        "attention.2.bias": f(H, sc=0.1),
        "attention.2.running_mean": f(H, sc=0.1),
        "attention.2.running_var": 1 + f(H, sc=0.1).abs(),
        "attention.3.weight": f(D, H, 1, sc=0.05),
        "attention.3.bias": f(D, sc=0.05),
    })


def _x(B, T, D, seed, n=None):
    """relu(N(0, 1)) as chip_smoke draws it; rows at and past n scaled by 7,
    which every statistic must leave out."""
    g = np.random.default_rng(seed)
    x = np.maximum(g.standard_normal((B, T, D)), 0).astype(np.float32)
    if n is not None:
        x[:, n:] *= 7
    return torch.from_numpy(x)


def test_source_constants_match_the_wrapper():
    assert NPL == ap.WX_PLANES
    assert RA in (64, 128) and R2 == 64
    assert "constexpr int R2 = POOL_R;" in _SRC   # pass C is B4a's pool


# --- (a) the bf16 planes of Wx ----------------------------------------------

def test_bf16_planes_reproduce_wx():
    """hi + mid holds W to 2^-17 |W| and three planes hold it exactly, at
    tiny and huge magnitudes too; one plane keeps 2^-8. Ties round to
    nearest even, as the f32 -> bf16 conversion does."""
    g = np.random.default_rng(2)
    w = torch.from_numpy(np.concatenate([
        g.standard_normal(4096), 1e-20 * g.standard_normal(64),
        1e20 * g.standard_normal(64),
        [1 + 2.0 ** -8, -(1 + 3 * 2.0 ** -8), 1 + 2.0 ** -8 + 2.0 ** -17]]
    ).astype(np.float32))
    exact = w.double()

    def rel(k):
        planes = ap.split_bf16(w, k)
        assert planes.dtype == torch.bfloat16
        assert planes.shape == (k, *w.shape)
        return float(((planes.double().sum(0) - exact).abs()
                      / exact.abs()).max())

    assert 2.0 ** -10 < rel(1) <= 2.0 ** -8
    assert rel(2) <= 2.0 ** -17
    assert rel(3) == 0.0
    hi, mid = ap.split_bf16(w, 2)[:, -3:-1]
    assert hi[0] == 1.0 and mid[0] == 2.0 ** -8            # tie to even
    assert hi[1] == -(1 + 2.0 ** -6) and mid[1] == 2.0 ** -8


def test_pack_pool_params_splits_wx_once():
    p = _params(256, 0)
    assert p.wx_planes.shape == (ap.WX_PLANES, 256, H)
    assert torch.equal(p.wx_planes, ap.split_bf16(p.wx))
    # the plain version reads the f32 weights only
    x = _x(2, 20, 256, 1)
    want = ap.attention_pooling_plain(x, p._replace(wx_planes=None))
    assert torch.equal(ap.attention_pooling_plain(x, p), want)


# --- (b) the products' arithmetic, emulated in float64 ----------------------
# B3's function in float64 with the two products given: pass A's P = x @ Wx
# and pass C's logits h @ Wb. Each emulated product is summed in float64 and
# rounded once to f32, as its f32 accumulators hold it (the tensor cores'
# own accumulation error is left to the chip check).

def _pool64(x, p, n, proj, logit):
    d = lambda t: t.double()
    xd = x.double()[:, :n]
    mean = xd.mean(1)
    var = ((xd * xd).mean(1) - mean ** 2) * n / (n - 1)
    std = torch.sqrt(var.clamp(min=1e-4))
    c = mean @ d(p.wm) + std @ d(p.ws) + d(p.ba)
    h = torch.relu(proj(xd) + c[:, None]) * d(p.s) + d(p.bias)
    w = torch.softmax(logit(h) + d(p.bb), dim=1)
    mu = (w * xd).sum(1)
    sg = torch.sqrt(((w * xd * xd).sum(1) - mu ** 2).clamp(min=1e-4))
    return torch.cat([mu, sg], -1)


def _f32(t):
    return t.float().double()


def _three_tf32(a, b):
    """a @ b as 3xTF32 computes it (tests/test_torch_attn_pool_vjp.py)."""
    return three_tf32(a.float(), b.float()).double()


def _three_bf16(a, b):
    """a @ b as pass C computes it: a and b each split into bf16 planes
    hi + lo, and lo hi + hi lo + hi hi (bf16 products are exact in f32)."""
    (ah, al), (bh, bl) = (ap.split_bf16(v.float(), 2).double()
                          for v in (a, b))
    return _f32(al @ bh + ah @ bl + ah @ bh)


def _planes(k, p):
    """Pass A for bf16 x against k planes of Wx."""
    w = ap.split_bf16(p.wx, k).double().sum(0)
    return lambda xd: _f32(xd @ w)


def _over_bar(got, want):
    """The largest error over the chip bar, atol 1e-4 + rtol 1e-4."""
    return float(((got - want).abs() / (1e-4 + 1e-4 * want.abs())).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_products_hold_the_chip_bar_at_the_serving_width(seed):
    """D = 1536, T = 300. bf16 x with two planes of Wx, and f32 x in 3xTF32,
    each with pass C's 3xbf16 logits: within 0.1 of the bar on
    [mu || sigma] (about 2e-3 of it; with 3xTF32 logits about 5e-4). One
    plane of Wx gives about 0.3 of the bar: inside it, but without the 10x
    margin, so the kernel takes two."""
    D, T = 1536, 300
    p = _params(D, seed)
    xb = _x(2, T, D, seed + 10).bfloat16()
    logit = lambda h: _three_bf16(h, p.wb)
    exact = lambda x: _pool64(x, p, T, lambda xd: xd @ p.wx.double(),
                              lambda h: h @ p.wb.double())
    want = exact(xb)
    two = _over_bar(_pool64(xb, p, T, _planes(NPL, p), logit), want)
    one = _over_bar(_pool64(xb, p, T, _planes(1, p), logit), want)
    assert NPL == 2 and two <= 0.1 and 0.1 < one < 1.0, (one, two)
    x32 = _x(2, T, D, seed + 20)
    got = _pool64(x32, p, T, lambda xd: _three_tf32(xd, p.wx), logit)
    assert _over_bar(got, exact(x32)) <= 0.1


# --- (c) the tiling and valid_len, modelled ---------------------------------

def _b3_model(x, p, n):
    """[mu || sigma] by B3's schedule in f32 (products in float64, rounded
    to f32). Pass A runs ceil(n / RA) row tiles, loads rows >= n as zeros,
    writes P's rows < n and one column-sum partial per tile; every row of P
    and every partial the schedule does not write is NaN, so a read of one
    shows. Pass B sums the partials of the tiles that ran, in order. Pass C
    is B4a's pool over the rows < n (its model in
    tests/test_torch_attn_pool_vjp.py, chunks of R2 rows), with h formed
    from those rows of P and the logits in 3xbf16."""
    B, T, D = x.shape
    xf = x.float().numpy()
    wx = p.wx.double().numpy()
    tiles = -(-n // RA)
    P = np.full((B, T, H), np.nan, np.float32)
    s1 = np.full((B, -(-T // RA), D), np.nan, np.float32)
    s2 = s1.copy()
    for tile in range(tiles):
        t0 = tile * RA
        nv = min(RA, n - t0)
        xt = np.zeros((B, RA, D), np.float32)
        xt[:, :nv] = xf[:, t0:t0 + nv]
        P[:, t0:t0 + nv] = (xt @ wx).astype(np.float32)[:, :nv]
        s1[:, tile] = xt.sum(1)
        s2[:, tile] = (xt * xt).sum(1)
    t1, t2 = (np.zeros((B, D), np.float32) for _ in range(2))
    for tile in range(tiles):
        t1 += s1[:, tile]
        t2 += s2[:, tile]
    mean = t1 / n
    var = (t2 / n - mean * mean) * (n / (n - 1))
    std = np.sqrt(np.maximum(var, 1e-4))
    f = lambda t: t.numpy()
    c = mean @ f(p.wm) + std @ f(p.ws) + f(p.ba)
    h = np.maximum(P[:, :n] + c[:, None], 0) * f(p.s) + f(p.bias)
    logits = (_three_bf16(torch.from_numpy(h), p.wb).float() + p.bb).numpy()
    (mu, e2, _, _), _ = _chunked_pool(logits, x[:, :n])
    return np.concatenate([mu, np.sqrt(np.maximum(e2 - mu * mu, 1e-4))], -1)


@pytest.mark.parametrize("T,n", [
    (2 * RA + 44, 2 * RA + 34),    # n in the last tile; T not a multiple of RA
    (2 * RA + 44, 2 * RA),         # n exactly at a tile boundary
    (2 * RA + 44, RA - 28),        # n in an earlier tile
    (2 * RA + 44, None),           # n = T
    (RA - 78, 37),                 # T < RA
])
def test_tiled_schedule_matches_plain(T, n):
    """The model against attention_pooling_plain, atol = rtol = 1e-4, with
    the rows past n scaled by 7."""
    D = 256
    p = _params(D, T)
    x = _x(2, T, D, T + 1, n)
    got = _b3_model(x, p, T if n is None else n)
    assert not np.isnan(got).any()
    want = ap.attention_pooling_plain(x, p, n).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


# --- (d) the kernel wrapper's refusals --------------------------------------

def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    p = _params(256, 3)
    x = _x(2, 10, 256, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ap.attention_pooling_kernel(x, p)
    with pytest.raises(ValueError, match="multiple of 128"):
        ap.attention_pooling_kernel(x[..., :200], p)
    for n in (1, 11):
        with pytest.raises(ValueError, match="valid_len"):
            ap.attention_pooling_kernel(x, p, valid_len=n)
    skew = torch.zeros(x.numel() + 1)[1:].view(x.shape)   # 4 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        ap.attention_pooling_kernel(skew, p)
    with pytest.raises(ValueError, match="wx_planes"):
        ap.attention_pooling_kernel(x.bfloat16(), p._replace(wx_planes=None))
    assert profiling.counts().get("B3", 0) == 0
