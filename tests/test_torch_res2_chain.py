"""Port Res2 chain (B2's plain version and parameter packing,
asvspoof2021_air_tpu_torch/ops/res2_chain_cuda.py) against the JAX package's
res2_chain_infer (Pallas, interpret mode) in f32, a model of kernel B2's
tiling against the plain version, and the f32 kernel's 3xTF32 products
emulated through that tiling against both.

Tolerance atol 1e-4: the JAX kernel's own bar against the model's chain math
(tests/test_res2_chain_pallas.py); seven chained f32 convs summed in another
order. The 3xTF32 emulation is held to 1e-5, a tenth of the card's f32 bar
for B2 (chip_smoke.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asvspoof2021_air_tpu.models.ecapa import ECAPA_TDNN as JECAPA
from asvspoof2021_air_tpu.ops.res2_chain_pallas import (
    pack_chain_params as jpack,
    res2_chain_infer as jchain,
)
from asvspoof2021_air_tpu_torch.interop.flax_weights import (
    from_flax_variables,
    random_flax_variables,
)
from asvspoof2021_air_tpu_torch.ops import res2_chain_cuda
from asvspoof2021_air_tpu_torch.ops.res2_chain_cuda import (
    KERNEL_WIDTH,
    pack_chain_params,
    res2_chain_infer,
    res2_chain_plain,
)
from tf32_emulation import three_tf32

C, SCALE = 64, 8
DILATION_OF = {2: "layer1", 3: "layer2", 4: "layer3"}


@pytest.fixture(scope="module")
def variables():
    return random_flax_variables(3, C=C, model_scale=SCALE, enc_dim=32,
                                 stat_noise=0.1)


@pytest.mark.parametrize("dilation", [2, 3, 4])
@pytest.mark.parametrize("B", [2, 3])
@pytest.mark.parametrize("T,valid_len", [(48, 47), (48, None)])
def test_plain_chain_matches_pallas(variables, B, T, valid_len, dilation):
    li = dilation - 2
    p = variables["params"][f"Bottle2neck_{li}"]
    bs = variables["batch_stats"][f"Bottle2neck_{li}"]
    # rows past valid_len hold garbage: both sides must ignore them
    x = (np.random.default_rng(B * T + dilation).standard_normal((B, T, C))
         * 2.0).astype(np.float32)
    want = np.asarray(jchain(jnp.asarray(x), *jpack(p, bs, scale=SCALE),
                             dilation=dilation, scale=SCALE,
                             valid_len=valid_len, interpret=True))
    sd = from_flax_variables(variables, SCALE)
    packed = pack_chain_params(sd, DILATION_OF[dilation], SCALE)
    got = res2_chain_infer(torch.from_numpy(x), *packed, dilation=dilation,
                           scale=SCALE, valid_len=valid_len).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    if valid_len is not None:
        np.testing.assert_array_equal(got[:, valid_len:], 0.0)


def test_packed_params_match_jax(variables):
    sd = from_flax_variables(variables, SCALE)
    for li, block in enumerate(("layer1", "layer2", "layer3")):
        want = jpack(variables["params"][f"Bottle2neck_{li}"],
                     variables["batch_stats"][f"Bottle2neck_{li}"],
                     scale=SCALE)
        got = pack_chain_params(sd, block, SCALE)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)


def test_bf16_plain_chain_tracks_pallas_bf16(variables):
    """bf16 I/O: both round sp + g and the BN output to bf16 at the same
    points; tolerance two bf16 ulps at the outputs' magnitude (~4)."""
    p = variables["params"]["Bottle2neck_1"]
    bs = variables["batch_stats"]["Bottle2neck_1"]
    x = np.random.default_rng(0).standard_normal((2, 40, C)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jchain(xb, *jpack(p, bs, scale=SCALE), dilation=3,
                             scale=SCALE, interpret=True), np.float32)
    packed = pack_chain_params(from_flax_variables(variables, SCALE),
                               "layer2", SCALE)
    got = res2_chain_plain(torch.from_numpy(x).bfloat16(), *packed,
                           dilation=3, scale=SCALE).float().numpy()
    np.testing.assert_allclose(got, want, atol=6e-2, rtol=2e-2)


def test_jax_tree_from_the_weight_maker_runs_in_jax(variables):
    """The numpy maker's tree is a valid ECAPA_TDNN variable tree."""
    model = JECAPA(C=C, model_scale=SCALE, enc_dim=32)
    emb, logits = model.apply(jax.tree.map(jnp.asarray, variables),
                              jnp.zeros((1, 20, 60)), False)
    assert emb.shape == (1, 32) and logits.shape == (1, 2)


# --- B2's tiling, modelled on the CPU ---------------------------------------
# The kernels (csrc/res2_chain.cu) compute one tile of TT output rows (bf16;
# TT_F32 in f32) at a time over R = TT + 2 H local rows, H = (scale-1) d;
# conv i computes local rows [(i+1) d, R - (i+1) d) from the rows of u next
# to them, and the rest of u is never read for a kept row. The model below
# runs that schedule with the tile height of x's type read from the source
# and NaN in every row of u the schedule does not compute, so a read outside
# the halo would show.

_SRC = (Path(res2_chain_cuda.__file__).resolve().parent.parent / "csrc"
        / "res2_chain.cu").read_text()
TT = int(re.search(r"constexpr int TT = (\d+);", _SRC).group(1))
TT_F32 = int(re.search(r"constexpr int TT_F32 = (\d+);", _SRC).group(1))


def _f32_product(x3, w):
    return x3 @ w


def _tiled_chain(x, w, cb, a, b, *, dilation, scale=SCALE, valid_len=None,
                 product=_f32_product):
    """res2_chain's function by B2's schedule: per tile, the halo recomputed
    and shrinking by d per conv, rounding to x's type at u and s; each
    conv's (rows, 3 width) @ (3 width, width) product by ``product``."""
    Bn, T, Cn = x.shape
    width, d, dt = Cn // scale, dilation, x.dtype
    tt = TT_F32 if dt == torch.float32 else TT
    valid = T if valid_len is None else valid_len
    H = (scale - 1) * d
    R = tt + 2 * H
    wf = w.to(dt).float()
    out = torch.full_like(x, float("nan"))
    for t0 in range(0, T, tt):
        r = torch.arange(t0 - H, t0 - H + R)
        inside = ((r >= 0) & (r < valid))[None, :, None]
        xt = torch.where(inside, x[:, r.clamp(0, T - 1)],
                         torch.zeros((), dtype=dt))
        n_own = min(tt, T - t0)
        u = xt[..., :width]
        for i in range(scale - 1):
            lo, hi = (i + 1) * d, R - (i + 1) * d
            uf = u.float()
            x3 = torch.cat([uf[:, lo - d:hi - d], uf[:, lo:hi],
                            uf[:, lo + d:hi + d]], dim=-1)
            y = product(x3, wf[i]) + cb[i]
            s = torch.where(inside[:, lo:hi], a[i] * torch.relu(y) + b[i],
                            torch.zeros(())).to(dt)
            out[:, t0:t0 + n_own, i * width:(i + 1) * width] = \
                s[:, H - lo:H - lo + n_own]
            if i + 2 < scale:
                g = xt[:, lo:hi, (i + 1) * width:(i + 2) * width]
                u = torch.full((Bn, R, width), float("nan"), dtype=dt)
                u[:, lo:hi] = (g.float() + s.float()).to(dt)
        out[:, t0:t0 + n_own, (scale - 1) * width:] = \
            xt[:, H:H + n_own, (scale - 1) * width:]
    return out


def _bf16_ulps_over_bars(got, want):
    """chip_smoke.py's bf16 bar for B2: the largest error per group in ulps
    of max(|want|, 1) must be <= i + 1 in group i and 0 in the passed-through
    group, with at most 1e-5 of the elements over 1 ulp. Returns (per-group
    ulps, bars, count over 1 ulp, allowed count)."""
    want = want.float()
    ulp = torch.exp2((torch.frexp(want.abs().clamp(min=1.0))[1] - 8).float())
    ulps = (got.float() - want).abs() / ulp
    per_group = ulps.unflatten(-1, (SCALE, -1)).amax(dim=(0, 1, 3))
    bars = torch.tensor([float(i + 1) for i in range(SCALE - 1)] + [0.0])
    return per_group, bars, int((ulps > 1).sum()), 1e-5 * ulps.numel()


def _valid(T, tt, where):
    """valid_len: None, inside the last tile (T - 10) or inside the first
    (T - tt - 20)."""
    return {None: None, "last": T - 10, "first": T - tt - 20}[where]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dilation", [2, 3, 4])
@pytest.mark.parametrize("valid_from_end", [None, "last", "first"],
                         ids=["None", "10", str(TT + 20)])
def test_tiled_schedule_matches_plain_chain(variables, dtype, dilation,
                                            valid_from_end):
    """T = tt + 37 with tt the tile height of the kernel for dtype (two
    tiles, the last one partial); valid_len inside the last tile (T - 10)
    and inside the first (T - tt - 20)."""
    tt = TT_F32 if dtype == torch.float32 else TT
    T = tt + 37
    valid = _valid(T, tt, valid_from_end)
    sd = from_flax_variables(variables, SCALE)
    packed = pack_chain_params(sd, DILATION_OF[dilation], SCALE)
    x = torch.from_numpy((np.random.default_rng(dilation).standard_normal(
        (2, T, C)) * 2.0).astype(np.float32)).to(dtype)
    w = (packed[0].to(dtype), *packed[1:])
    want = res2_chain_plain(x, *w, dilation=dilation, valid_len=valid)
    got = _tiled_chain(x, *w, dilation=dilation, valid_len=valid)
    assert not torch.isnan(got).any()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    else:
        per_group, bars, n_over, allowed = _bf16_ulps_over_bars(got, want)
        assert bool((per_group <= bars).all()), per_group
        assert n_over <= allowed
    if valid is not None:
        assert bool((got[:, valid:] == 0).all())


def _chain_params(seed=5, width=KERNEL_WIDTH, scale=SCALE):
    """Packed chain parameters at the kernel's width, as chip_smoke.py makes
    them: conv weights at 1/sqrt(3 width), BN folded from near-unit
    statistics."""
    g = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (sc * g.standard_normal(s)).astype(np.float32)
    n = scale - 1
    gamma, beta = 1 + f(n, width, sc=0.1), f(n, width, sc=0.1)
    mean, var = f(n, width, sc=0.1), 1 + np.abs(f(n, width, sc=0.1))
    a = (gamma / np.sqrt(var + 1e-5)).astype(np.float32)
    return (f(n, 3 * width, width, sc=(3 * width) ** -0.5),
            f(n, width, sc=0.05), a, (beta - mean * a).astype(np.float32))


@pytest.mark.parametrize("dilation", [2, 3, 4])
@pytest.mark.parametrize("valid_in", ["first", "last"])
def test_tf32_chain_matches_plain_and_pallas(dilation, valid_in):
    """The f32 kernel's arithmetic: every conv product in 3xTF32 (emulated
    as the kernel splits, tests/tf32_emulation.py) through its own tiling,
    T = TT_F32 + 37, valid_len inside the first or the last tile; within
    1e-5 of the plain f32 chain and of JAX's f32 res2_chain_infer."""
    T = TT_F32 + 37
    valid = _valid(T, TT_F32, valid_in)
    w, cb, a, b = _chain_params()
    x = (np.random.default_rng(dilation).standard_normal(
        (2, T, KERNEL_WIDTH * SCALE)) * 2.0).astype(np.float32)
    packed = [torch.from_numpy(v) for v in (w, cb, a, b)]
    got = _tiled_chain(torch.from_numpy(x), *packed, dilation=dilation,
                       valid_len=valid, product=three_tf32)
    assert not torch.isnan(got).any()
    assert bool((got[:, valid:] == 0).all())
    plain = res2_chain_plain(torch.from_numpy(x), *packed,
                             dilation=dilation, valid_len=valid)
    torch.testing.assert_close(got, plain, atol=1e-5, rtol=0)
    want = np.asarray(jchain(jnp.asarray(x), *map(jnp.asarray, (w, cb, a, b)),
                             dilation=dilation, scale=SCALE, valid_len=valid,
                             interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
