"""Port LFCC (plain LFCC and the B1 wrapper's plain version) against the JAX
package's LFCC and PallasLFCC (interpret mode), with and without lengths,
and at win 400 / hop 200 against the hop-rows layout (B1b's domain).

Tolerance atol 5e-4: the JAX package's own fused-vs-jnp LFCC bar
(tests/test_lfcc_pallas.py), since log10 near eps amplifies differences in
summation order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from asvspoof2021_air_tpu.ops.lfcc import LFCC as JLFCC
from asvspoof2021_air_tpu.ops.lfcc import LFCCConfig as JConfig
from asvspoof2021_air_tpu.ops.lfcc_pallas import PallasLFCC
from asvspoof2021_air_tpu_torch.ops.lfcc import LFCC, LFCCConfig
from asvspoof2021_air_tpu_torch.ops.lfcc_cuda import CudaLFCC

ATOL = 5e-4


def _wav(shape, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


@pytest.mark.parametrize("shape,lengths", [
    ((2, 48000), None),
    ((2, 48000), [32000, 48000]),
    ((3, 8000), None),
    ((3, 8000), [8000, 5120, 1601]),
])
def test_plain_and_fused_match_jax(shape, lengths):
    wav = _wav(shape, seed=shape[1] + (0 if lengths is None else 1))
    jl = None if lengths is None else jnp.asarray(lengths)
    tl = None if lengths is None else torch.tensor(lengths)
    want = np.asarray(JLFCC()(jnp.asarray(wav), jl))
    want_pallas = np.asarray(PallasLFCC(interpret=True)(jnp.asarray(wav), jl))

    plain = LFCC(device="cpu")(torch.from_numpy(wav), tl).numpy()
    fused = CudaLFCC(device="cpu")(torch.from_numpy(wav), tl).numpy()
    assert plain.shape == fused.shape == want.shape
    np.testing.assert_allclose(plain, want, atol=ATOL)
    np.testing.assert_allclose(fused, want_pallas, atol=ATOL)
    np.testing.assert_allclose(fused, want, atol=ATOL)


def test_hoprows_domain_win400_hop200():
    """win 400 / hop 200 has lcm(200, 128) / 200 = 16 phases, so the JAX
    package takes its hop-rows kernel there (_lfcc_kernel)."""
    wav = _wav((2, 12000), seed=5)
    lens = [12000, 7000]
    jcfg = JConfig(win_length=400, hop_length=200)
    want = np.asarray(PallasLFCC(jcfg, interpret=True, layout="hoprows")(
        jnp.asarray(wav), jnp.asarray(lens)))
    got = CudaLFCC(LFCCConfig(win_length=400, hop_length=200), device="cpu")(
        torch.from_numpy(wav), torch.tensor(lens)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("config", [
    LFCCConfig(win_length=400, hop_length=160),
    LFCCConfig(with_energy=True),
    LFCCConfig(n_fft=480),          # the kernel's FFT needs a power of two
])
def test_rejects_what_the_fused_kernel_rejects(config):
    with pytest.raises(ValueError):
        CudaLFCC(config, device="cpu")


@pytest.mark.parametrize("win,hop", [(320, 160), (400, 200)])
def test_kernel_constants(win, hop):
    """The window and twiddle table B1 takes: the periodic Hamming window
    and exp(-2 pi i k / n_fft), each to f32 rounding; the compact
    filterbank (bands and weights) holds every nonzero weight."""
    fe = CudaLFCC(LFCCConfig(win_length=win, hop_length=hop), device="cpu")
    k = np.arange(win)
    np.testing.assert_allclose(fe.window.numpy(),
                               0.54 - 0.46 * np.cos(2 * np.pi * k / win),
                               rtol=0, atol=6e-8)
    n = 512
    want = np.exp(-2j * np.pi * np.arange(n // 2) / n)
    tw = fe.twiddle.numpy()
    assert tw.dtype == np.float32 and tw.shape == (n // 2, 2)
    np.testing.assert_array_equal(tw[:, 0], want.real.astype(np.float32))
    np.testing.assert_array_equal(tw[:, 1], want.imag.astype(np.float32))
    fb, bands, weights = fe.fb.numpy(), fe.bands.numpy(), fe.weights.numpy()
    assert bands.dtype == np.int32 and bands.shape == (20, 2)
    rebuilt = np.zeros_like(fb)
    for f, (lo, hi) in enumerate(bands):
        assert fb[lo, f] != 0 and fb[hi - 1, f] != 0
        assert np.all(weights[hi - lo:, f] == 0)
        rebuilt[lo:hi, f] = weights[:hi - lo, f]
    np.testing.assert_array_equal(rebuilt, fb)


def _dft(v, w, n_fft):
    """R-point DFT along axis 0 of v (R, ...) in complex64, as B1 runs it in
    registers: radix-2 decimation in frequency (span h's twiddles W_2h^i =
    w[i n_fft / 2h], w[q] = exp(-2 pi i q / n_fft)), then the bit-reversal
    permutation, so natural order in and out."""
    v = v.copy()
    r_pts = v.shape[0]
    h = r_pts // 2
    while h >= 1:
        i = np.arange(h)
        tw = w[i * (n_fft // (2 * h))].reshape((h,) + (1,) * (v.ndim - 1))
        for blk in range(0, r_pts, 2 * h):
            lo, hi = v[blk + i].copy(), v[blk + i + h].copy()
            v[blk + i] = lo + hi
            v[blk + i + h] = (lo - hi) * tw
        h //= 2
    bits = r_pts.bit_length() - 1
    rev = [int(format(j, f"0{bits}b")[::-1], 2) if bits else 0
           for j in range(r_pts)]
    return v[rev]


def _kernel_rfft_power(frame, twiddle):
    """Test-only f32 numpy model of B1's transform of one n_fft frame, in
    the kernel's order: z = even + i odd samples (M = n_fft / 2 points); a
    Stockham FFT whose pass 0 takes the P = min(8, M)-point DFT of
    z[g + G j] (G = M / P) and whose further passes of span NS and radix R
    (8, then 8, 4 or 2) take R-point DFTs of z[j + r M / R] twiddled by
    W_(NS R)^((j mod NS) r) into z[(j / NS) NS R + j mod NS + r NS]; then the
    real-FFT post-twiddle, the thread of bin k <= M/2 giving bins k and
    M - k. Returns |X[k]|^2 for k < M."""
    n = frame.shape[0]
    m_pts = n // 2
    p_pts = min(8, m_pts)
    g_pts = m_pts // p_pts
    half = (twiddle[:, 0] + 1j * twiddle[:, 1]).astype(np.complex64)
    w = np.concatenate([half, -half])                # w^q for q < n_fft
    z = (frame[0::2] + 1j * frame[1::2]).astype(np.complex64)
    y = _dft(z.reshape(p_pts, g_pts), w, n)          # y[r, g], pass 0
    data = y.T.reshape(-1)                           # z[g P + r]
    ns = p_pts
    while ns < m_pts:
        r_pts = min(8, m_pts // ns)
        j = np.arange(m_pts // r_pts)
        r = np.arange(r_pts)[:, None]
        u = data[j + r * (m_pts // r_pts)]           # u[r, j]
        u = u * w[(j % ns) * r * (n // (ns * r_pts))]
        u = _dft(u, w, n)
        out = np.empty_like(data)
        out[(j // ns) * ns * r_pts + j % ns + r * ns] = u
        data, ns = out, ns * r_pts
    k = np.arange(m_pts // 2 + 1)
    a, cc = data[k], np.conj(data[(m_pts - k) % m_pts])
    e = np.complex64(0.5) * (a + cc)
    o = np.complex64(-0.5j) * (a - cc)
    wo = w[k] * o
    power = np.empty(m_pts, np.float32)
    power[(m_pts - k[1:])] = np.abs(e - wo)[1:] ** 2  # bins M - k, k > 0
    power[k] = np.abs(e + wo) ** 2                    # bins k
    return power


@pytest.mark.parametrize("n,win", [(512, 320), (512, 400), (256, 200),
                                   (64, 48), (8, 8)])
def test_kernel_fft_model_matches_rfft(n, win):
    """B1's transform (numpy model, f32) against np.fft.rfft in float64:
    each bin within 1e-5 of the frame's norm, whatever the frame's scale;
    an all-zero frame gives exactly 0. n_fft = 512 is every configuration
    of the repo (passes of radix 8, 8, 4); the smaller sizes take the
    kernel's other layouts (8, 4 at 64 with 4 lanes a frame; one lane of 4
    points at 8)."""
    fe = CudaLFCC(LFCCConfig(n_fft=n, win_length=win, hop_length=win // 2),
                  device="cpu")
    off = (n - win) // 2
    g = np.random.default_rng(n + win)
    tw = fe.twiddle.numpy()
    for scale in (1.0, 1e-3, 1e3):
        frame = np.zeros(n, np.float32)
        frame[off:off + win] = (scale * g.standard_normal(win)).astype(
            np.float32) * fe.window.numpy()
        got = np.sqrt(_kernel_rfft_power(frame, tw).astype(np.float64))
        want = np.abs(np.fft.rfft(frame.astype(np.float64)))[:n // 2]
        norm = np.linalg.norm(frame.astype(np.float64))
        assert np.max(np.abs(got - want)) <= 1e-5 * norm
    zero = _kernel_rfft_power(np.zeros(n, np.float32), tw)
    assert np.all(zero == 0.0)


def test_energy_variant_of_plain_lfcc():
    wav = _wav((2, 4000), seed=9)
    cfg = dict(with_energy=True)
    want = np.asarray(JLFCC(JConfig(**cfg))(jnp.asarray(wav)))
    got = LFCC(LFCCConfig(**cfg), device="cpu")(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_silence_frame_matches():
    want = JLFCC().silence_frame()
    got = LFCC(device="cpu").silence_frame().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
